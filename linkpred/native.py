"""ctypes bindings for the C++ host runtime (`native/graphlib.cpp`).

The device compute path is JAX/XLA; this module is the *host* data
plane — CSR/ELL graph construction, alias-table building, p/q edge-bias
probabilities, and negative sampling — in multi-threaded C++, replacing the
pure-Python loops that would otherwise bottleneck data ingestion on large
graphs (the reference leans on torch-scatter/torch-sparse C++ and gensim C
for the same reason, SURVEY.md §2.6).

The library is built on demand with `make -C native` (g++ is baked into the
image); every entry point has a numpy fallback, so the framework works —
just slower on big graphs — without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgraphlib.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def load_library():
    """Build (if needed) and load the shared library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH)
                < os.path.getmtime(os.path.join(_NATIVE_DIR, "graphlib.cpp"))
            ):
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "-s"],
                    check=True,
                    capture_output=True,
                )
            lib = ctypes.CDLL(_LIB_PATH)
        except (OSError, subprocess.CalledProcessError):
            return None

        lib.build_csr_ell.restype = ctypes.c_int32
        lib.build_alias_rows.restype = None
        lib.edge_bias_probs.restype = None
        lib.sample_negatives.restype = ctypes.c_int64
        lib.extract_subgraphs_csr.restype = None
        lib.drnl_tags_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def build_csr_ell(src, dst, num_nodes: int, max_degree: int | None = None):
    """Sorted CSR + padded ELL arrays from a directed edge list.

    Returns (order, indptr, nbr, mask, degree) with edges sorted by
    (src, dst) via `order`. Falls back to numpy lexsort when the native
    library is unavailable.
    """
    lib = load_library()
    src = _i32(src)
    dst = _i32(dst)
    e = len(src)
    if lib is None:
        order = np.lexsort((dst, src)).astype(np.int32)
        degree = np.bincount(src, minlength=num_nodes).astype(np.int32)
        indptr = np.zeros(num_nodes + 1, dtype=np.int32)
        np.cumsum(degree, out=indptr[1:])
        d = max(int(degree.max(initial=0)), 1)
        if max_degree:
            d = max(d, max_degree)
        nbr = np.zeros((num_nodes, d), dtype=np.int32)
        mask = np.zeros((num_nodes, d), dtype=bool)
        s_sorted, d_sorted = src[order], dst[order]
        pos = np.arange(e, dtype=np.int64) - indptr[s_sorted]
        nbr[s_sorted, pos] = d_sorted
        mask[s_sorted, pos] = True
        return order, indptr, nbr, mask, degree

    degree = np.bincount(src, minlength=num_nodes).astype(np.int32)
    d = max(int(degree.max(initial=0)), 1)
    if max_degree:
        d = max(d, max_degree)
    indptr = np.zeros(num_nodes + 1, dtype=np.int32)
    order = np.zeros(e, dtype=np.int32)
    nbr = np.zeros((num_nodes, d), dtype=np.int32)
    mask_u8 = np.zeros((num_nodes, d), dtype=np.uint8)
    deg_out = np.zeros(num_nodes, dtype=np.int32)
    ret = lib.build_csr_ell(
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        ctypes.c_int64(e), ctypes.c_int32(num_nodes), ctypes.c_int32(d),
        _ptr(indptr, ctypes.c_int32), _ptr(order, ctypes.c_int32),
        _ptr(nbr, ctypes.c_int32), _ptr(mask_u8, ctypes.c_uint8),
        _ptr(deg_out, ctypes.c_int32),
    )
    assert ret >= 0, f"native build_csr_ell capacity error: {ret}"
    return order, indptr, nbr, mask_u8.astype(bool), deg_out


def build_alias_rows(probs, valid):
    """Native Vose alias tables per row; same contract as
    `linkpred.ops.walk.alias_setup_rows`."""
    lib = load_library()
    probs = np.ascontiguousarray(probs, dtype=np.float64)
    deg = np.ascontiguousarray(valid.sum(axis=1), dtype=np.int32)
    r, d = probs.shape
    if lib is None:
        from linkpred.ops.walk import alias_setup_rows

        return alias_setup_rows(probs, valid)
    J = np.zeros((r, d), dtype=np.int32)
    q = np.zeros((r, d), dtype=np.float32)
    lib.build_alias_rows(
        _ptr(probs, ctypes.c_double), _ptr(deg, ctypes.c_int32),
        ctypes.c_int64(r), ctypes.c_int32(d),
        _ptr(J, ctypes.c_int32), _ptr(q, ctypes.c_float),
    )
    return J, q


def edge_bias_probs(src, dst, nbr, mask, indptr, indices, p: float, q: float,
                    nbr_weight=None):
    """p/q-biased neighbor probabilities per directed edge (the 2nd-order
    walk bias of reference `node2vec.py:55-74`). [E, D] float64.

    `nbr_weight` ([N, D] float32 in ELL layout) scales each neighbor's bias
    by the edge weight — the weighted-graph `get_alias_edge` semantics —
    without any dense [N, N] has-edge matrix, so weighted walks keep the
    same scale ceiling as unweighted ones."""
    lib = load_library()
    src = _i32(src)
    dst = _i32(dst)
    e = len(src)
    d = nbr.shape[1]
    if lib is None:
        raise RuntimeError("native library unavailable; use python path")
    nbr_c = _i32(nbr)
    mask_c = np.ascontiguousarray(mask, dtype=np.uint8)
    if nbr_weight is not None:
        w_c = np.ascontiguousarray(nbr_weight, dtype=np.float32)
        w_ptr = _ptr(w_c, ctypes.c_float)
    else:
        w_ptr = ctypes.POINTER(ctypes.c_float)()
    out = np.zeros((e, d), dtype=np.float64)
    lib.edge_bias_probs(
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        ctypes.c_int64(e),
        _ptr(nbr_c, ctypes.c_int32), _ptr(mask_c, ctypes.c_uint8),
        w_ptr, ctypes.c_int32(d),
        _ptr(_i32(indptr), ctypes.c_int32), _ptr(_i32(indices), ctypes.c_int32),
        ctypes.c_double(p), ctypes.c_double(q),
        _ptr(out, ctypes.c_double),
    )
    return out


def sgns_train_ref(walks, num_nodes: int, dim: int = 128, window: int = 10,
                   negatives: int = 5, epochs: int = 1, lr: float = 0.025,
                   min_lr: float = 1e-4, seed: int = 0,
                   n_threads: int = 0):
    """Measured on-host gensim-class SGNS baseline (hogwild C++ threads —
    the loop structure of gensim's C training path, used by the reference
    at `feature_extraction.py:17` with workers=8). Returns
    (syn0 [N, dim] float32, words_trained). Raises if the native library
    is unavailable; this exists to give the bench sgns gate a MEASURED
    words/s denominator on this host, not as a production path."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    lib.sgns_train_ref.restype = ctypes.c_int64
    walks = _i32(walks)
    n_walks, walk_len = walks.shape
    counts = np.bincount(walks.reshape(-1), minlength=num_nodes).astype(
        np.int64)
    rng = np.random.default_rng(seed)
    syn0 = ((rng.random((num_nodes, dim)) - 0.5) / dim).astype(np.float32)
    syn1 = np.zeros((num_nodes, dim), dtype=np.float32)
    trained = lib.sgns_train_ref(
        _ptr(walks, ctypes.c_int32), ctypes.c_int64(n_walks),
        ctypes.c_int32(walk_len), _ptr(counts, ctypes.c_int64),
        ctypes.c_int32(num_nodes), ctypes.c_int32(dim),
        ctypes.c_int32(window), ctypes.c_int32(negatives),
        ctypes.c_int32(epochs), ctypes.c_float(lr), ctypes.c_float(min_lr),
        ctypes.c_uint64(seed), ctypes.c_int32(n_threads),
        _ptr(syn0, ctypes.c_float), _ptr(syn1, ctypes.c_float),
    )
    return syn0, int(trained)


def extract_subgraphs_csr(indptr, indices, num_nodes: int, pairs,
                          hop: int, max_neighbors: int, seed: int = 0):
    """Threaded C++ k-hop enclosing-subgraph extraction over CSR (the SEAL
    data path at scales where a dense [N, N] adjacency cannot exist).
    Returns (nodes [P, K] int32, mask [P, K] bool, adj [P, K, K] uint8,
    sizes [P] int32). Raises if the native library is unavailable — callers
    go through `data.subgraph.extract_subgraphs_csr`, which has the numpy
    fallback."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable; use python path")
    pairs = _i32(pairs)
    P, K = pairs.shape[0], max_neighbors
    nodes = np.zeros((P, K), dtype=np.int32)
    mask = np.zeros((P, K), dtype=np.uint8)
    adj = np.zeros((P, K, K), dtype=np.uint8)
    sizes = np.zeros(P, dtype=np.int32)
    lib.extract_subgraphs_csr(
        _ptr(_i32(indptr), ctypes.c_int32), _ptr(_i32(indices), ctypes.c_int32),
        ctypes.c_int32(num_nodes), _ptr(pairs, ctypes.c_int32),
        ctypes.c_int64(P), ctypes.c_int32(hop), ctypes.c_int32(K),
        ctypes.c_uint64(seed),
        _ptr(nodes, ctypes.c_int32), _ptr(mask, ctypes.c_uint8),
        _ptr(adj, ctypes.c_uint8), _ptr(sizes, ctypes.c_int32),
    )
    return nodes, mask.astype(bool), adj, sizes


def drnl_tags_batch(adj, mask, sizes):
    """Threaded C++ DRNL labeling over a padded subgraph stack
    (adj [P, K, K] uint8, mask [P, K] bool, sizes [P]) -> tags [P, K] int32.
    Exact same tags as the jit BFS (`data.subgraph.drnl_tags`); the host
    plane for SEAL-at-scale where shipping [P, K, K] stacks to the device
    just to BFS 100-node graphs wastes the chip."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable; use jit path")
    adj = np.ascontiguousarray(adj, dtype=np.uint8)
    mask_u8 = np.ascontiguousarray(mask, dtype=np.uint8)
    sizes = _i32(sizes)
    P, K = mask_u8.shape
    tags = np.zeros((P, K), dtype=np.int32)
    lib.drnl_tags_batch(
        _ptr(adj, ctypes.c_uint8), _ptr(mask_u8, ctypes.c_uint8),
        _ptr(sizes, ctypes.c_int32), ctypes.c_int64(P), ctypes.c_int32(K),
        _ptr(tags, ctypes.c_int32),
    )
    return tags


def sample_negatives(exclude_pairs, num_nodes: int, num_samples: int, seed: int = 0):
    """Uniform non-edge pair sampling in C++; returns [num_samples, 2]."""
    lib = load_library()
    ex = np.asarray(exclude_pairs, dtype=np.int64)
    lo = np.minimum(ex[:, 0], ex[:, 1])
    hi = np.maximum(ex[:, 0], ex[:, 1])
    keys = np.unique(lo * num_nodes + hi)
    if lib is None:
        from linkpred.data.split import negative_sampling

        return negative_sampling(
            exclude_pairs, num_nodes, num_samples,
            rng=np.random.default_rng(seed),
        )
    out = np.zeros((num_samples, 2), dtype=np.int32)
    got = lib.sample_negatives(
        _ptr(keys, ctypes.c_int64), ctypes.c_int64(len(keys)),
        ctypes.c_int32(num_nodes), ctypes.c_int64(num_samples),
        ctypes.c_uint64(seed), _ptr(out, ctypes.c_int32),
    )
    if got < num_samples:
        raise ValueError(f"sampled only {got}/{num_samples} negatives")
    return out.astype(np.int64)
