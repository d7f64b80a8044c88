// linkpred native runtime: graph building, alias tables, negative
// sampling. C API consumed from Python via ctypes.
//
// These are the host-side data-path equivalents of what the reference gets
// from native *library* code (torch-scatter/torch-sparse C++ kernels,
// gensim's C Word2Vec, Spark's JVM — SURVEY.md §2.6): the framework
// keeps device compute in XLA, and keeps the host data plumbing in C++ so
// graph ingestion and table construction never bottleneck feeding the
// device.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <unordered_set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSR/ELL construction from a directed edge list.
// Inputs: src/dst [e]; outputs (caller-allocated):
//   indptr [n+1], order [e] (permutation sorting edges by (src,dst)),
//   nbr [n*max_deg], mask [n*max_deg] (uint8), degree [n].
// Returns the max degree actually used (<= max_deg capacity).
// ---------------------------------------------------------------------------
int32_t build_csr_ell(const int32_t* src, const int32_t* dst, int64_t e,
                      int32_t n, int32_t max_deg, int32_t* indptr,
                      int32_t* order, int32_t* nbr, uint8_t* mask,
                      int32_t* degree) {
  std::vector<int64_t> cnt(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) cnt[src[i] + 1]++;
  int32_t dmax = 0;
  for (int32_t v = 0; v < n; ++v) {
    degree[v] = (int32_t)cnt[v + 1];
    dmax = std::max(dmax, degree[v]);
  }
  if (dmax > max_deg) return -dmax;  // capacity too small; caller retries
  for (int32_t v = 0; v < n; ++v) cnt[v + 1] += cnt[v];
  for (int32_t v = 0; v <= n; ++v) indptr[v] = (int32_t)cnt[v];

  // counting-sort by src (stable), then sort each row's slice by dst
  std::vector<int64_t> cursor(cnt.begin(), cnt.end() - 1);
  for (int64_t i = 0; i < e; ++i) order[cursor[src[i]]++] = (int32_t)i;
  std::memset(mask, 0, (size_t)n * max_deg);
  for (int32_t v = 0; v < n; ++v) {
    int32_t lo = indptr[v], hi = indptr[v + 1];
    std::sort(order + lo, order + hi,
              [&](int32_t a, int32_t b) { return dst[a] < dst[b]; });
    for (int32_t k = lo; k < hi; ++k) {
      nbr[(int64_t)v * max_deg + (k - lo)] = dst[order[k]];
      mask[(int64_t)v * max_deg + (k - lo)] = 1;
    }
    for (int32_t k = hi - lo; k < max_deg; ++k)
      nbr[(int64_t)v * max_deg + k] = 0;
  }
  return dmax;
}

// ---------------------------------------------------------------------------
// Row-wise alias tables (Vose). probs [r*d] (unnormalized, zeros where
// invalid), deg [r] = number of valid slots per row. Outputs J [r*d] int32,
// q [r*d] float32. Matches the Python alias_setup semantics
// (reference node2vec.py:107-137). Multi-threaded over rows.
// ---------------------------------------------------------------------------
void build_alias_rows(const double* probs, const int32_t* deg, int64_t r,
                      int32_t d, int32_t* J, float* q) {
  int nthreads = (int)std::min<int64_t>(std::thread::hardware_concurrency(), 16);
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<double> qr;
    std::vector<int32_t> smaller, larger;
    for (int64_t row = lo; row < hi; ++row) {
      const double* p = probs + row * d;
      int32_t* Jr = J + row * d;
      float* qo = q + row * d;
      int32_t K = deg[row];
      std::memset(Jr, 0, sizeof(int32_t) * d);
      std::memset(qo, 0, sizeof(float) * d);
      if (K == 0) continue;
      double s = 0;
      for (int32_t k = 0; k < K; ++k) s += p[k];
      qr.assign(K, 0.0);
      smaller.clear();
      larger.clear();
      for (int32_t k = 0; k < K; ++k) {
        qr[k] = (s > 0 ? p[k] / s : 1.0 / K) * K;
        if (qr[k] < 1.0) smaller.push_back(k);
        else larger.push_back(k);
      }
      while (!smaller.empty() && !larger.empty()) {
        int32_t small = smaller.back(); smaller.pop_back();
        int32_t large = larger.back(); larger.pop_back();
        Jr[small] = large;
        qr[large] += qr[small] - 1.0;
        if (qr[large] < 1.0) smaller.push_back(large);
        else larger.push_back(large);
      }
      for (int32_t k = 0; k < K; ++k) qo[k] = (float)qr[k];
    }
  };
  std::vector<std::thread> ts;
  int64_t chunk = (r + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(r, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// 2nd-order (node2vec p/q) edge bias probabilities.
// For every directed edge e = (s -> t): over t's neighbor slots x:
//   prob = w(t, x) * (1/p if x == s, 1 if edge(x, s) exists, else 1/q),
// where w is the edge weight (reference `get_alias_edge`, node2vec.py:55-74;
// unweighted graphs pass weight = nullptr -> w = 1).
// nbr/mask are the ELL arrays (weight [n*d] float32 in the same layout);
// has_edge test uses binary search over the CSR row of x.
// Output probs [e*d] doubles (0 where invalid).
// ---------------------------------------------------------------------------
void edge_bias_probs(const int32_t* src, const int32_t* dst, int64_t e,
                     const int32_t* nbr, const uint8_t* mask,
                     const float* weight, int32_t d,
                     const int32_t* indptr, const int32_t* indices,
                     double p, double q, double* probs) {
  int nthreads = (int)std::min<int64_t>(std::thread::hardware_concurrency(), 16);
  if (nthreads < 1) nthreads = 1;
  auto has_edge = [&](int32_t u, int32_t v) {
    const int32_t* lo = indices + indptr[u];
    const int32_t* hi = indices + indptr[u + 1];
    return std::binary_search(lo, hi, v);
  };
  auto work = [&](int64_t lo_e, int64_t hi_e) {
    for (int64_t i = lo_e; i < hi_e; ++i) {
      int32_t s = src[i], t = dst[i];
      const int32_t* row = nbr + (int64_t)t * d;
      const uint8_t* m = mask + (int64_t)t * d;
      const float* w = weight ? weight + (int64_t)t * d : nullptr;
      double* out = probs + i * d;
      for (int32_t k = 0; k < d; ++k) {
        if (!m[k]) { out[k] = 0.0; continue; }
        int32_t x = row[k];
        double bias =
            (x == s) ? 1.0 / p : (has_edge(x, s) ? 1.0 : 1.0 / q);
        out[k] = w ? bias * w[k] : bias;
      }
    }
  };
  std::vector<std::thread> ts;
  int64_t chunk = (e + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(e, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// Uniform negative sampling: `want` pairs (u < v) not present in the
// exclusion set (sorted int64 keys u*n+v) and mutually distinct.
// Returns the number actually sampled (== want unless the space is thin).
// ---------------------------------------------------------------------------
int64_t sample_negatives(const int64_t* exclude_sorted, int64_t n_exclude,
                         int32_t n, int64_t want, uint64_t seed,
                         int32_t* out_pairs) {
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int32_t> uni(0, n - 1);
  std::unordered_set<int64_t> seen;
  seen.reserve((size_t)want * 2);
  int64_t got = 0;
  int64_t attempts = 0, max_attempts = want * 200 + 1000;
  while (got < want && attempts < max_attempts) {
    ++attempts;
    int32_t a = uni(rng), b = uni(rng);
    if (a == b) continue;
    int32_t lo = std::min(a, b), hi = std::max(a, b);
    int64_t key = (int64_t)lo * n + hi;
    if (std::binary_search(exclude_sorted, exclude_sorted + n_exclude, key))
      continue;
    if (!seen.insert(key).second) continue;
    out_pairs[got * 2] = lo;
    out_pairs[got * 2 + 1] = hi;
    ++got;
  }
  return got;
}

// ---------------------------------------------------------------------------
// Batched k-hop enclosing-subgraph extraction over CSR (the SEAL data path
// at graph scales where a dense [N, N] adjacency is impossible — 235k nodes
// would need ~55 GB; reference semantics: SEAL/config/subgraph.py:105-137).
// For every pair (u, v): start selected = {u, v}; each hop, collect the
// not-yet-selected neighbors of ALL selected nodes (matching the dense
// frontier product), and if they exceed the remaining budget K - |selected|
// keep a uniform random subset (partial Fisher-Yates — the reference's
// shuffle-then-slice truncation). Node order is [u, v, rest in discovery
// order]; the induced adjacency is emitted with the (u, v) target entry
// masked. Multi-threaded over pairs; per-pair rng is seeded from
// (seed, pair index) so results are independent of thread partitioning.
// Outputs (caller-allocated): nodes [P*K] int32, mask [P*K] uint8,
// adj [P*K*K] uint8, sizes [P] int32.
// ---------------------------------------------------------------------------
void extract_subgraphs_csr(const int32_t* indptr, const int32_t* indices,
                           int32_t n, const int32_t* pairs, int64_t P,
                           int32_t hop, int32_t K, uint64_t seed,
                           int32_t* nodes, uint8_t* mask, uint8_t* adj,
                           int32_t* sizes) {
  int nthreads = (int)std::min<int64_t>(std::thread::hardware_concurrency(), 16);
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int64_t lo_p, int64_t hi_p) {
    // epoch-stamped maps: no O(n) clear per pair
    std::vector<int64_t> sel_stamp(n, -1), cand_stamp(n, -1);
    std::vector<int32_t> local(n, 0);
    std::vector<int32_t> sel, cand;
    sel.reserve(K);
    for (int64_t p = lo_p; p < hi_p; ++p) {
      // splitmix64 over (seed, p) for a partition-independent stream
      uint64_t z = seed + 0x9e3779b97f4a7c15ULL * (uint64_t)(p + 1);
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      std::mt19937_64 rng(z ^ (z >> 31));

      int32_t u = pairs[p * 2], v = pairs[p * 2 + 1];
      sel.clear();
      sel.push_back(u);
      sel_stamp[u] = p;
      if (v != u) {
        sel.push_back(v);
        sel_stamp[v] = p;
      }
      for (int32_t h = 0; h < hop; ++h) {
        int32_t budget = K - (int32_t)sel.size();
        if (budget <= 0) break;
        cand.clear();
        size_t n_sel = sel.size();  // freeze: neighbors of current selected
        for (size_t i = 0; i < n_sel; ++i) {
          int32_t w = sel[i];
          for (int32_t k = indptr[w]; k < indptr[w + 1]; ++k) {
            int32_t x = indices[k];
            if (sel_stamp[x] == p || cand_stamp[x] == p) continue;
            cand_stamp[x] = p;
            cand.push_back(x);
          }
        }
        int32_t take = std::min<int32_t>((int32_t)cand.size(), budget);
        // partial Fisher-Yates: first `take` entries are a uniform subset
        for (int32_t i = 0; i < take; ++i) {
          std::uniform_int_distribution<int32_t> uni(i, (int32_t)cand.size() - 1);
          std::swap(cand[i], cand[uni(rng)]);
          sel.push_back(cand[i]);
          sel_stamp[cand[i]] = p;
        }
        if (cand.empty()) break;  // frontier exhausted
      }
      int32_t sz = (int32_t)sel.size();
      sizes[p] = sz;
      int32_t* nrow = nodes + p * K;
      uint8_t* mrow = mask + p * K;
      for (int32_t i = 0; i < sz; ++i) {
        nrow[i] = sel[i];
        mrow[i] = 1;
        local[sel[i]] = i;
      }
      for (int32_t i = sz; i < K; ++i) {
        nrow[i] = 0;
        mrow[i] = 0;
      }
      uint8_t* arow = adj + p * (int64_t)K * K;
      std::memset(arow, 0, (size_t)K * K);
      for (int32_t i = 0; i < sz; ++i) {
        int32_t w = sel[i];
        for (int32_t k = indptr[w]; k < indptr[w + 1]; ++k) {
          int32_t x = indices[k];
          if (sel_stamp[x] == p) arow[(int64_t)i * K + local[x]] = 1;
        }
      }
      if (sz >= 2) {  // mask the target link (subgraph.py:137)
        arow[0 * (int64_t)K + 1] = 0;
        arow[1 * (int64_t)K + 0] = 0;
      }
    }
  };
  std::vector<std::thread> ts;
  int64_t chunk = (P + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(P, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// Batched DRNL (Double-Radius Node Labeling) over padded subgraph stacks —
// the host data plane for SEAL at scale. Per subgraph: BFS from node 0 (=u)
// and node 1 (=v) on the dense [K, K] adjacency (target link already
// masked), then the closed-form tag of reference SEAL/utils/utils.py:50-52:
//   tag = 1 + min(dx, dy) + (d/2)*((d/2) + d%2 - 1),  d = dx + dy
// unreachable-from-either -> 0, endpoints -> 1, padded nodes -> 0.
// A 100-node BFS is microseconds of integer work; putting it on the device
// would spend device matmuls (and a host round-trip) on a host-sized job.
// Multi-threaded over subgraphs. adj [P*K*K] uint8, mask [P*K] uint8,
// sizes [P] int32 -> tags [P*K] int32.
// ---------------------------------------------------------------------------
void drnl_tags_batch(const uint8_t* adj, const uint8_t* mask,
                     const int32_t* sizes, int64_t P, int32_t K,
                     int32_t* tags) {
  int nthreads = (int)std::min<int64_t>(std::thread::hardware_concurrency(), 16);
  if (nthreads < 1) nthreads = 1;
  const int32_t INF = INT32_MAX / 4;
  auto work = [&](int64_t lo_p, int64_t hi_p) {
    std::vector<int32_t> dx(K), dy(K), queue(K);
    for (int64_t p = lo_p; p < hi_p; ++p) {
      const uint8_t* a = adj + p * (int64_t)K * K;
      const uint8_t* m = mask + p * K;
      int32_t sz = sizes[p];
      int32_t* out = tags + p * K;
      auto bfs = [&](int32_t src, std::vector<int32_t>& dist) {
        std::fill(dist.begin(), dist.end(), INF);
        if (src >= sz) return;
        dist[src] = 0;
        int32_t head = 0, tail = 0;
        queue[tail++] = src;
        while (head < tail) {
          int32_t w = queue[head++];
          const uint8_t* row = a + (int64_t)w * K;
          for (int32_t x = 0; x < sz; ++x) {
            if (row[x] && dist[x] == INF) {
              dist[x] = dist[w] + 1;
              queue[tail++] = x;
            }
          }
        }
      };
      bfs(0, dx);
      bfs(1, dy);
      for (int32_t i = 0; i < K; ++i) {
        if (!m[i] || i >= sz) { out[i] = 0; continue; }
        if (i < 2) { out[i] = 1; continue; }
        if (dx[i] >= INF || dy[i] >= INF) { out[i] = 0; continue; }
        int32_t d = dx[i] + dy[i];
        int32_t div = d / 2, mod = d % 2;
        out[i] = 1 + std::min(dx[i], dy[i]) + div * (div + mod - 1);
      }
    }
  };
  std::vector<std::thread> ts;
  int64_t chunk = (P + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(P, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// Host CPU skip-gram negative-sampling reference trainer — a faithful
// reimplementation of the gensim/word2vec.c training loop the reference
// depends on (`requirements.txt:13`, used at
// `LogisticRegression_Linkprediction/utils/feature_extraction.py:17` with
// workers=8 C threads): hogwild multithreaded SGD, per-position reduced
// window b ~ U[0, window), unigram^0.75 negative table, sigmoid via a
// 1000-entry exp table over [-6, 6], linear lr decay. Its purpose is a
// MEASURED on-host words/s baseline for the bench sgns gate (gensim itself
// is not installable in this image), not a production path — the device
// trainer in models/word2vec.py is the production path.
// Inputs: walks [n_walks * walk_len] int32, counts [n_nodes] int64.
// Outputs: syn0 [n_nodes * dim] float32 (caller-initialized uniform/dim),
//          syn1 [n_nodes * dim] float32 (caller-zeroed).
// Returns the number of center-token updates processed (words trained).
// ---------------------------------------------------------------------------
int64_t sgns_train_ref(const int32_t* walks, int64_t n_walks,
                       int32_t walk_len, const int64_t* counts,
                       int32_t n_nodes, int32_t dim, int32_t window,
                       int32_t negs, int32_t epochs, float lr0, float min_lr,
                       uint64_t seed, int32_t n_threads, float* syn0,
                       float* syn1) {
  // unigram^0.75 table (word2vec.c InitUnigramTable, 1e8 entries there;
  // 16M here keeps init cheap at the same sampling resolution for 235k
  // vocabularies)
  const int64_t table_size = 1 << 24;
  std::vector<int32_t> table(table_size);
  {
    double total = 0.0;
    for (int32_t i = 0; i < n_nodes; ++i)
      total += std::pow((double)counts[i], 0.75);
    int64_t i = 0;
    double cum = std::pow((double)counts[0], 0.75) / total;
    for (int64_t a = 0; a < table_size; ++a) {
      table[a] = (int32_t)i;
      if ((double)(a + 1) / table_size > cum && i < n_nodes - 1) {
        ++i;
        cum += std::pow((double)counts[i], 0.75) / total;
      }
    }
  }
  // sigmoid table (word2vec.c EXP_TABLE_SIZE=1000, MAX_EXP=6)
  const int kExp = 1000;
  const float kMaxExp = 6.0f;
  std::vector<float> expt(kExp);
  for (int i = 0; i < kExp; ++i) {
    float x = std::exp(((float)i / kExp * 2 - 1) * kMaxExp);
    expt[i] = x / (x + 1);
  }

  if (n_threads < 1)
    n_threads = (int32_t)std::max<uint32_t>(
        1, std::thread::hardware_concurrency());
  const int64_t total_words = n_walks * (int64_t)walk_len * epochs;
  std::atomic<int64_t> words_done(0);

  auto work = [&](int t) {
    std::vector<float> neu1e(dim);
    uint64_t rnd = seed + 0x9e3779b97f4a7c15ULL * (uint64_t)(t + 1);
    auto next_rand = [&]() {
      rnd = rnd * 6364136223846793005ULL + 1442695040888963407ULL;
      return rnd;
    };
    int64_t lo = n_walks * t / n_threads, hi = n_walks * (t + 1) / n_threads;
    int64_t local_words = 0;
    float lr = lr0;
    for (int32_t ep = 0; ep < epochs; ++ep) {
      for (int64_t s = lo; s < hi; ++s) {
        const int32_t* sent = walks + s * walk_len;
        for (int32_t pos = 0; pos < walk_len; ++pos) {
          // linear decay over the thread's share, gensim-style (refresh
          // every 10k words to keep the atomic off the hot path)
          if ((local_words & 0x2fff) == 0) {
            int64_t done = words_done.load(std::memory_order_relaxed);
            lr = lr0 - (lr0 - min_lr) * ((double)done / total_words);
            if (lr < min_lr) lr = min_lr;
          }
          ++local_words;
          if ((local_words & 0x3ff) == 0)
            words_done.fetch_add(0x400, std::memory_order_relaxed);
          int32_t w = sent[pos];
          int32_t b = (int32_t)(next_rand() % window);
          for (int32_t j = pos - window + b; j <= pos + window - b; ++j) {
            if (j == pos || j < 0 || j >= walk_len) continue;
            int32_t c = sent[j];
            if (c == w) continue;
            float* v = syn0 + (int64_t)c * dim;  // gensim trains context
            std::fill(neu1e.begin(), neu1e.end(), 0.0f);
            for (int32_t k = 0; k <= negs; ++k) {
              int32_t target;
              float label;
              if (k == 0) {
                target = w;
                label = 1.0f;
              } else {
                // word2vec.c indexes the table with (next_random >> 16):
                // the low bits of a power-of-two-modulus LCG are strongly
                // serially correlated (bit k has period 2^(k+1))
                target = table[(next_rand() >> 16) % table_size];
                if (target == w) continue;
                label = 0.0f;
              }
              float* u = syn1 + (int64_t)target * dim;
              float f = 0;
              for (int32_t d_ = 0; d_ < dim; ++d_) f += v[d_] * u[d_];
              float g;
              if (f > kMaxExp) g = (label - 1.0f) * lr;
              else if (f < -kMaxExp) g = label * lr;
              else
                g = (label -
                     expt[(int)((f + kMaxExp) * (kExp / kMaxExp / 2))]) *
                    lr;
              for (int32_t d_ = 0; d_ < dim; ++d_) neu1e[d_] += g * u[d_];
              for (int32_t d_ = 0; d_ < dim; ++d_) u[d_] += g * v[d_];
            }
            for (int32_t d_ = 0; d_ < dim; ++d_) v[d_] += neu1e[d_];
          }
        }
      }
    }
    words_done.fetch_add(local_words & 0x3ff, std::memory_order_relaxed);
    return;
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
  for (auto& t : ts) t.join();
  return total_words;
}

}  // extern "C"
