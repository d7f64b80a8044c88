"""Smoke run of the link-prediction main path on an NVIDIA GPU.

    python chip_smoke.py [--out DIR]     # one card: every phase below
    python chip_smoke.py --multi         # four cards: the sharded paths only

One process drives every card it uses. Phases, in order:

- device:   require a GPU (no CPU fallback); print JAX's view of it, the
            card's name and power limit, whether the native host library
            loaded, and the compile-cache directory.
- numerics: compare the device kernels at the pipelines' widths with plain
            float64 NumPy references (each tolerance is stated beside its
            check), and time the fb-pages 1-WL planned segment sum and one
            50k-node 2-WL paired pass.
- fbpages:  `cli logistic`, `cli seal`, `cli twowl` and the trial-major
            sweep of `bench.py` on fb-pages-food, with their AUC bands.
- scale:    `cli scale` for TwoWL (50k nodes) and GCN (235k nodes), and
            the collab-scale SEAL pipeline, each with a finite, decreasing
            loss and a test AUC.
- multi:    (`--multi` only) the multi-device dry run on four cards, and
            GCN training node-sharded over a (1, 4) mesh against (1, 1).

Every artifact (records, logs, checkpoints, plots) goes under `--out`.
A failed check fails its phase; the later phases still run, and the script
then exits 1 without printing the result line. On success the last line
of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Widths and schedule lengths of one smoke run. The defaults are the
    pipelines' own full widths; only steps and epochs are cut."""

    collab_nodes: int = 235_000  # bench.collab_graph / cli scale gcn
    collab_edges: int = 1_280_000
    collab_cap: int = 64
    feats: int = 128
    gcn_hidden: int = 128  # ScaleGCNConfig.hidden
    twowl_nodes: int = 50_000  # ScaleTwoWLConfig defaults
    twowl_edges: int = 250_000
    seal_batch: int = 256
    seal_k: int = 50
    seal_feats: int = 52  # 20 DRNL tags + 32 embedding dims
    logistic_rows: int = 4096
    logistic_dim: int = 100  # LogisticConfig.embed.dim
    twowl_trials: int = 2
    twowl_epochs: int = 100
    sweep_trials: int = 32
    sweep_epochs: int = 50
    scale_twowl_steps: int = 16
    scale_gcn_steps: int = 8
    scale_seal_epochs: int = 2
    multi_devices: int = 4
    multi_gcn_steps: int = 8
    # None = the pipeline's default graph size
    scale_nodes: int | None = None
    scale_edges: int | None = None


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def result_line(devices) -> str:
    """The contract's last line: exactly `ok` and `device`."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def phases_for(multi: bool) -> list[str]:
    return ["device", "multi"] if multi else [
        "device", "numerics", "fbpages", "scale"]


def say(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# plain float64 references
# ---------------------------------------------------------------------------

U_F32 = 2.0 ** -24  # unit roundoff
U_BF16 = 2.0 ** -8


def sum_error_ratio(got, ref, abs_terms) -> float:
    """max |got - ref| / sum|terms| over all output elements: the measure
    the naive-summation bound (n-1)*u*sum|terms| speaks of."""
    err = np.abs(np.asarray(got, np.float64) - ref)
    return float(np.max(err / (abs_terms + 1e-30)))


def ref_ell_spmm(nbr, w, x):
    """out[i] = sum_d w[i, d] * x[nbr[i, d]] in float64, and the matching
    sum of |terms|."""
    x = np.asarray(x, np.float64)
    out = np.zeros((nbr.shape[0], x.shape[1]))
    mag = np.zeros_like(out)
    for d in range(nbr.shape[1]):
        t = w[:, d, None].astype(np.float64) * x[nbr[:, d]]
        out += t
        mag += np.abs(t)
    return out, mag


def ref_segment_sum(data, ids, num_segments):
    """np.add.at segment sum in float64 (ids >= num_segments dropped) and
    the matching sum of |terms|."""
    data = np.asarray(data, np.float64)
    keep = ids < num_segments
    out = np.zeros((num_segments,) + data.shape[1:])
    mag = np.zeros_like(out)
    np.add.at(out, ids[keep], data[keep])
    np.add.at(mag, ids[keep], np.abs(data[keep]))
    return out, mag


def ref_seal_forward(p, d_inv, a_tilde, x, mask, k):
    """NumPy float64 DGCNN forward (models.seal.forward, no dropout):
    (logits, sort scores for the tie screen, conv-stack output)."""
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    z, zs = f(x), []
    for w in p.gw:
        z = np.tanh(f(d_inv)[:, :, None] * np.einsum(
            "bkj,bjc->bkc", f(a_tilde), z @ f(w)))
        zs.append(z)
    cat, z4 = np.concatenate(zs[:3], -1), zs[3][:, :, 0]
    scores = np.where(mask, z4, -np.inf)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    pooled = np.take_along_axis(cat, order[:, :, None], axis=1)
    pooled *= np.take_along_axis(mask, order, axis=1)[:, :, None]
    c1 = pooled @ f(p.wc1)
    wc2 = f(p.wc2)
    width = wc2.shape[0]
    c2 = sum(c1[:, t:t + k - width + 1] @ wc2[t] for t in range(width))
    h = np.maximum(c2.reshape(c2.shape[0], -1) @ f(p.w1) + f(p.b1), 0.0)
    return h @ f(p.w2) + f(p.b2), scores, cat


def ref_newton(x, y, w, c, iters):
    """models.logistic._newton_fit in float64."""
    n, d = x.shape
    xb = np.concatenate([x, np.ones((n, 1))], axis=1).astype(np.float64)
    reg = np.concatenate([np.full(d, 1.0 / c), [0.0]])
    beta = np.zeros(d + 1)
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(xb @ beta)))
        s = w * p * (1 - p) + 1e-10
        grad = xb.T @ (w * (p - y)) + reg * beta
        beta = beta - np.linalg.solve((xb * s[:, None]).T @ xb
                                      + np.diag(reg), grad)
    return beta


def median_ms(fn, *args, reps: int = 20) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


class Smoke:
    def __init__(self, sizes: Sizes, out_dir: str):
        self.sizes = sizes
        self.out_dir = out_dir
        self.failed: list[str] = []
        self.card = "card not reported by nvidia-smi"

    def run_phase(self, name: str, fn) -> None:
        say(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # a phase boundary: record, report, go on
            traceback.print_exc()
            self.failed.append(name)
            say(f"== phase {name} FAILED after "
                f"{time.perf_counter() - t0:.1f} s")
            return
        say(f"== phase {name} ok in {time.perf_counter() - t0:.1f} s "
            f"[{self.card}]")

    def cli(self, argv: list[str], log_name: str) -> str:
        """Run `linkpred.cli.main(argv)` in this process; its stdout goes to
        `<out>/logs/<log_name>.log` and is returned."""
        from linkpred import cli

        buf = io.StringIO()
        os.makedirs("logs", exist_ok=True)
        say(f"$ linkpred {' '.join(argv)}")
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        text = buf.getvalue()
        with open(os.path.join("logs", f"{log_name}.log"), "w") as f:
            f.write(text)
        return text

    # -- device -------------------------------------------------------------

    def device(self) -> None:
        import jax

        from linkpred import native
        from linkpred.utils.hardware import (
            enable_compile_cache,
            gpu_name_and_power_limit,
        )

        devs = jax.devices()
        check(devs[0].platform == "gpu",
              f"no GPU: JAX found {devs[0].platform} devices only")
        smi = gpu_name_and_power_limit()
        if smi:
            self.card = smi[0]
        say(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
            f"{len(devs)} device(s)")
        for line in smi:
            say(f"nvidia-smi: {line}")
        say(f"native host library loaded: {native.available()}")
        say(f"compile cache: {enable_compile_cache()}")

    # -- numerics -----------------------------------------------------------

    def numerics(self) -> None:
        for name, fn in (("spmm_bucketed", self._num_spmm),
                         ("2-WL segment sums", self._num_2wl),
                         ("SEAL DGCNN forward", self._num_seal),
                         ("logistic Newton fit", self._num_logistic)):
            say(f"-- {name}")
            fn()

    def _num_spmm(self) -> None:
        import jax
        import jax.numpy as jnp

        import bench
        from linkpred.ops import spmm

        z = self.sizes
        g = bench.collab_graph(z.collab_nodes, z.collab_edges, z.collab_cap)
        lay = spmm.BucketedEll.from_graph(g)
        ops = lay.operands()
        w = (g.nbr_mask * (g.nbr_weight if g.nbr_weight is not None
                           else 1.0)).astype(np.float32)
        rng = np.random.default_rng(0)
        x32 = rng.standard_normal((g.num_nodes, z.feats)).astype(np.float32)
        f = jax.jit(lambda x, *o: spmm.spmm_bucketed(x, g.num_nodes, *o))
        deg = int(g.nbr_mask.sum(1).max())
        # gather + sum paths differ from the reference only in summation
        # order: naive-summation bound (n-1)*u*sum|terms| with n the row
        # degree, plus one output rounding -> deg*u. bf16 inputs are
        # compared with a reference built from the same bf16-rounded
        # values; u is then bf16's unit roundoff, whatever order and
        # precision XLA accumulates in.
        for dt, u in ((jnp.float32, U_F32), (jnp.bfloat16, U_BF16)):
            x = jnp.asarray(x32).astype(dt)
            ref, mag = ref_ell_spmm(g.nbr, w, np.asarray(x, np.float32))
            r = sum_error_ratio(f(x, *ops), ref, mag)
            say(f"spmm_bucketed {jnp.dtype(dt).name} {g.num_nodes} nodes "
                f"{g.num_edges} edges F={z.feats}: err/sum|terms| {r:.2e} "
                f"(tol {deg * u:.2e})")
            check(r <= deg * u, f"spmm_bucketed {jnp.dtype(dt).name}: {r}")

        # GCN layer relu(A x @ W + x @ Ws) (pipelines.gcn_scale.embed_all)
        # in f32: matmuls compared under highest precision; the bound is
        # the same summation bound over deg + 2*F terms, taken against
        # the largest output (terms of a matmul are not summed apart here)
        wa = rng.standard_normal((z.feats, z.gcn_hidden)).astype(np.float32)
        wb = rng.standard_normal((z.feats, z.gcn_hidden)).astype(np.float32)
        wa, wb = wa / np.sqrt(z.feats), wb / np.sqrt(z.feats)

        def layer(x, wa, wb, *o):
            a = spmm.spmm_bucketed_sym(x, g.num_nodes, o)
            return jax.nn.relu(a @ wa + x @ wb)

        agg, _ = ref_ell_spmm(g.nbr, w, x32)
        ref = np.maximum(agg @ wa + x32.astype(np.float64) @ wb, 0.0)
        n_terms = deg + 2 * z.feats
        tol = n_terms * U_F32 * float(np.abs(agg).max() * np.abs(wa).sum(0)
                                      .max() + np.abs(x32).max()
                                      * np.abs(wb).sum(0).max())
        errs = {}
        for prec in ("highest", "default"):
            with jax.default_matmul_precision(prec):
                out = jax.jit(layer)(x32, wa, wb, *ops)
            errs[prec] = float(np.abs(np.asarray(out, np.float64)
                                      - ref).max())
        say(f"GCN layer f32 x@W: max|err| highest {errs['highest']:.2e} "
            f"(tol {tol:.2e}), default precision {errs['default']:.2e}")
        check(errs["highest"] <= tol, f"GCN layer: {errs['highest']}")

    def _num_2wl(self) -> None:
        import jax
        import jax.numpy as jnp

        import bench
        from linkpred.models import twowl as m
        from linkpred.ops.segment import (
            gather_sum_composed,
            segment_sum_planned,
        )
        from linkpred.pipelines.twowl_scale import (
            ScaleTwoWLConfig,
            build_scale_data,
        )

        z = self.sizes
        scfg = ScaleTwoWLConfig(nodes=z.twowl_nodes, edges=z.twowl_edges)
        data = build_scale_data(scfg)
        s = data.train
        arr = m.SplitArrays.from_split(s)
        R, S = len(s.pos1), len(s.e1_dst)
        C = scfg.channels_2wl
        rng = np.random.default_rng(1)
        src1 = np.where(s.e1_mask, s.e1_src ^ 1, R).astype(np.int64)
        dst = np.where(s.e1_mask, s.e1_dst, R).astype(np.int64)
        n_fwd = int(np.bincount(dst[dst < R], minlength=R).max())
        n_bwd = int(np.bincount(src1[src1 < R], minlength=R).max())
        say(f"2-WL structure: {data.num_nodes} nodes, {R} edge rows, "
            f"{S} ei2 slots (cap {scfg.ei2_cap_per_node}), C={C}; largest "
            f"segment {n_fwd} (fwd) / {n_bwd} (VJP)")

        def planned(mm):
            return segment_sum_planned(R, mm, *arr.e1_plan)

        plan_f = jax.jit(planned)
        plan_v = jax.jit(lambda mm, gg: jax.vjp(planned, mm)[1](gg)[0])
        comp = jax.jit(lambda h: gather_sum_composed(h, *arr.e1_cops))
        comp_v = jax.jit(lambda h, gg: jax.vjp(
            lambda hh: gather_sum_composed(hh, *arr.e1_cops), h)[1](gg)[0])
        # summation-order bound as for spmm_bucketed, n = largest segment
        # (+1 for the output rounding); the planned VJP is a pure gather
        # (g[dst] per slot) and must match exactly
        for dt, u in ((jnp.float32, U_F32), (jnp.bfloat16, U_BF16)):
            name = jnp.dtype(dt).name
            msgs = jnp.asarray(rng.standard_normal((S, C)), dt)
            h = jnp.asarray(rng.standard_normal((R, 2 * C)), dt)
            g = jnp.asarray(rng.standard_normal((R, 2 * C)), dt)
            m64, h64, g64 = (np.asarray(a, np.float32) for a in (msgs, h, g))
            h_ext = np.concatenate([h64, np.zeros((1, 2 * C), np.float32)])
            g_ext = np.concatenate([g64, np.zeros((1, 2 * C), np.float32)])
            checks = [
                ("segment_sum_planned fwd", plan_f(msgs),
                 ref_segment_sum(m64, dst, R), n_fwd + 1),
                ("gather_sum_composed fwd", comp(h),
                 ref_segment_sum(h_ext[src1], dst, R), n_fwd + 1),
                ("gather_sum_composed VJP", comp_v(h, g),
                 ref_segment_sum(g_ext[dst], src1, R), n_bwd + 1),
            ]
            for what, got, (ref, mag), n in checks:
                r = sum_error_ratio(got, ref, mag)
                say(f"{what} {name}: err/sum|terms| {r:.2e} "
                    f"(tol {n * u:.2e})")
                check(r <= n * u, f"{what} {name}: {r}")
            gv = plan_v(msgs, jnp.asarray(g64[:, :C], dt))
            exact = np.asarray(gv, np.float32) == np.concatenate(
                [g64[:, :C], np.zeros((1, C), np.float32)])[
                    np.minimum(s.e1_dst, R)]
            say(f"segment_sum_planned VJP {name}: exact gather "
                f"{bool(exact.all())}")
            check(bool(exact.all()), f"segment_sum_planned VJP {name}")

        # plain-XLA times a hand-written kernel would have to beat
        hb = jnp.asarray(rng.standard_normal((R, 2 * C)), jnp.bfloat16)
        t_2wl = median_ms(comp, hb)
        sdata, _ = bench.sweep_problem()
        fa = m.SplitArrays.from_split(sdata.train)
        msgs1 = jnp.asarray(rng.standard_normal(
            (len(sdata.train.msg), 24)), jnp.float32)
        t_1wl = median_ms(jax.jit(lambda mm: segment_sum_planned(
            sdata.num_nodes, mm, *fa.msg_plan)), msgs1)
        say(f"XLA time: fb-pages 1-WL planned segment sum "
            f"({len(sdata.train.msg)} msgs x 24 f32 -> {sdata.num_nodes} "
            f"nodes) {t_1wl:.4f} ms; {data.num_nodes}-node 2-WL paired pass "
            f"(gather_sum_composed, {S} slots x {2 * C} bf16) "
            f"{t_2wl:.4f} ms [{self.card}]")

    def _num_seal(self) -> None:
        import jax
        import jax.numpy as jnp

        from linkpred.models import seal

        z = self.sizes
        B, K, F = z.seal_batch, z.seal_k, z.seal_feats
        k = max(int(0.6 * K), seal.CONV1D_2_WIDTH)
        rng = np.random.default_rng(2)
        adj = np.triu((rng.random((B, K, K)) < 0.1), 1).astype(np.float32)
        a_tilde = adj + adj.transpose(0, 2, 1) + np.eye(K, dtype=np.float32)
        d_inv = (1.0 / a_tilde.sum(-1)).astype(np.float32)
        sizes = rng.integers(K // 3, K + 1, B)
        mask = np.arange(K)[None, :] < sizes[:, None]
        x = (rng.standard_normal((B, K, F)) * mask[:, :, None]).astype(
            np.float32)
        p = seal.init_params(jax.random.PRNGKey(3), F, k)
        ref, scores, ref_cat = ref_seal_forward(p, d_inv, a_tilde, x, mask,
                                                k)
        # SortPooling's order is discontinuous at ties: subgraphs whose
        # top-(k+1) sort scores hold a gap below 1e-6 (100x the f32
        # rounding of scores of this size) may legitimately reorder and
        # are left out of the logits comparison
        top = -np.sort(-np.where(mask, scores, -1e9), axis=1)[:, :k + 1]
        gaps = np.where(top[:, 1:] > -1e9, top[:, :-1] - top[:, 1:], np.inf)
        keep = gaps.min(axis=1) >= 1e-6

        def fwd(*a):
            return seal.forward(*a, k), seal.graph_conv_layers(*a[:4])[0]

        args = tuple(jnp.asarray(a) for a in (d_inv, a_tilde, x, mask))
        errs = {}
        for prec in ("highest", "default"):
            with jax.default_matmul_precision(prec):
                got, cat = jax.jit(fwd)(p, *args)
            errs[prec] = (float(np.abs(np.asarray(got) - ref)[keep].max()),
                          float(np.abs(np.asarray(cat) - ref_cat).max()))
        # f32 through ~8 layers of contractions of length <= max(K, 96):
        # relative rounding ~1e-6; 1e-4 of the largest value leaves margin
        tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
        say(f"SEAL DGCNN forward B={B} K={K} F={F} k={k}: max|err| logits "
            f"/ conv stack: highest {errs['highest'][0]:.2e} / "
            f"{errs['highest'][1]:.2e} (tol {tol:.2e}), default precision "
            f"{errs['default'][0]:.2e} / {errs['default'][1]:.2e}; "
            f"{int(keep.sum())}/{B} subgraphs free of near-ties in the "
            f"logits comparison")
        check(keep.mean() >= 0.75, "too many near-ties in SEAL sort scores")
        check(max(errs["highest"]) <= tol,
              f"SEAL forward: {errs['highest']}")

    def _num_logistic(self) -> None:
        import jax
        import jax.numpy as jnp

        from linkpred.models.logistic import _newton_fit

        z = self.sizes
        rng = np.random.default_rng(4)
        n, d = z.logistic_rows, z.logistic_dim
        x = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
        y = (rng.random(n) < 1 / (1 + np.exp(-(x @ rng.standard_normal(d)
                                                * 3)))).astype(np.float32)
        w = np.ones(n, np.float32)
        ref = ref_newton(x, y, w, 1.0, 16)
        errs = {}
        for prec in ("highest", "default"):
            with jax.default_matmul_precision(prec):
                got = np.asarray(jax.jit(
                    _newton_fit.__wrapped__, static_argnames="num_iters")(
                    jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), 1.0,
                    num_iters=16))
            errs[prec] = float(np.abs(got - ref).max())
        # an f32 solve of this well-conditioned (D+1)^2 system keeps ~5
        # digits of the float64 solution; 1e-3 of the largest coefficient
        tol = 1e-3 * max(1.0, float(np.abs(ref).max()))
        say(f"logistic Newton fit n={n} D={d}: max|dbeta| highest "
            f"{errs['highest']:.2e} (tol {tol:.2e}), default precision "
            f"{errs['default']:.2e}")
        check(errs["highest"] <= tol, f"Newton fit: {errs['highest']}")

    # -- fbpages ------------------------------------------------------------

    def fbpages(self) -> None:
        z = self.sizes
        out = self.cli(["logistic"], "logistic")
        auc = float(re.findall(r"AUC:([0-9.]+)", out)[-1])
        say(f"cli logistic: test AUC {auc:.4f} (band [0.75, 0.85])")
        check(0.75 <= auc <= 0.85, f"logistic AUC {auc}")

        out = self.cli(["seal"], "seal")
        auc, secs = map(float, re.findall(
            r"AUC:([0-9.]+)\s+Time:([0-9.]+)", out)[-1])
        say(f"cli seal: test AUC {auc:.4f} (>= 0.85), train {secs:.4f} s")
        check(auc >= 0.85, f"SEAL AUC {auc}")

        # a sweep journal left by an earlier run in this directory would
        # replay its trials; this run must train
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join("logs", "twowl_sweep_state.jsonl"))
        out = self.cli(["twowl", "--trials", str(z.twowl_trials),
                        "--epochs", str(z.twowl_epochs)], "twowl")
        losses = [float(v) for v in re.findall(
            r"epochs\s+\d+-\d+\s+loss (\S+)", out)]
        trials = re.findall(r"^trial \d+: .*$", out, re.M)
        auc = float(re.findall(r"AUC:([0-9.]+)", out)[-1])
        for line in trials:
            say(line)
        say(f"cli twowl: {len(trials)} trials trained, chunk losses "
            f"{losses}, test AUC {auc:.4f} (> 0.5)")
        check(len(losses) >= z.twowl_trials,
              "cli twowl replayed trials instead of training")
        check(all(math.isfinite(v) for v in losses), "non-finite loss")
        check(auc > 0.5, f"TwoWL AUC {auc}")

        import bench
        from linkpred.pipelines.twowl_pipeline import (
            TwoWLRunConfig,
            refine_vmapped,
        )

        data, cfg = bench.sweep_problem()
        t0 = time.perf_counter()
        res = refine_vmapped(data, cfg, TwoWLRunConfig(epochs=z.sweep_epochs),
                             n_trials=z.sweep_trials)
        secs = time.perf_counter() - t0
        vals = np.asarray(res["val_aucs"])
        say(f"trial-major sweep {z.sweep_trials} trials x {z.sweep_epochs} "
            f"epochs: {secs:.1f} s incl. compile; best val "
            f"{vals.max():.4f}, winner test {res['test_auc']:.4f} "
            f"[{self.card}]")
        check(bool(np.isfinite(vals).all()), "non-finite sweep val AUC")
        check(vals.max() > 0.5 and 0.0 < res["test_auc"] <= 1.0,
              "sweep AUCs out of range")

    # -- scale --------------------------------------------------------------

    def _size_args(self) -> list[str]:
        z = self.sizes
        a = []
        if z.scale_nodes:
            a += ["--nodes", str(z.scale_nodes)]
        if z.scale_edges:
            a += ["--edges", str(z.scale_edges)]
        return a

    def _scale_ok(self, name: str, res: dict) -> None:
        first, last = res["loss_first_quarter"], res["loss_last_quarter"]
        check(math.isfinite(first) and math.isfinite(last),
              f"{name}: non-finite loss")
        check(res["loss_decreased"], f"{name}: loss did not decrease")
        check(0.0 <= res["test_auc"] <= 1.0, f"{name}: test AUC")

    def scale(self) -> None:
        z = self.sizes
        out = self.cli(["--quiet", "scale", "--family", "twowl", "--steps",
                        str(z.scale_twowl_steps), *self._size_args()],
                       "scale_twowl")
        res = json.loads(out.strip().splitlines()[-1])
        say(f"scale twowl: {res['nodes']} nodes, {res['ei2_columns']} ei2 "
            f"cols, {res['epochs']} epochs, loss "
            f"{res['loss_first_quarter']:.4f} -> "
            f"{res['loss_last_quarter']:.4f}, test AUC "
            f"{res['test_auc']:.4f}; compile {res['compile_seconds']} s, "
            f"{res['epochs_per_s']} epochs/s, build {res['build_seconds']} "
            f"s, n2v {res['n2v_seconds']} s [{self.card}]")
        say(f"scale twowl epoch-scan memory_analysis: "
            f"{res['memory_analysis']}")
        self._scale_ok("scale twowl", res)

        out = self.cli(["--quiet", "scale", "--family", "gcn", "--steps",
                        str(z.scale_gcn_steps), *self._size_args()],
                       "scale_gcn")
        res = json.loads(out.strip().splitlines()[-1])
        say(f"scale gcn: {res['nodes']} nodes, {res['shards']} shard(s), "
            f"losses {[round(v, 4) for v in res['losses']]}, test AUC "
            f"{res['test_auc']:.4f}; compile {res['compile_seconds']} s, "
            f"{res['steps_per_s']} steps/s, {res['agg_edges_per_s']} "
            f"agg-edges/s [{self.card}]")
        self._scale_ok("scale gcn", res)

        from linkpred.pipelines.seal_scale import (
            ScaleSEALConfig,
            run_seal_scale,
        )

        kw = {k: v for k, v in (("nodes", z.scale_nodes),
                                ("edges", z.scale_edges)) if v}
        res = run_seal_scale(ScaleSEALConfig(epochs=z.scale_seal_epochs,
                                             **kw), verbose=False)
        say(f"scale seal: {res['nodes']} nodes, {res['target_pairs']} "
            f"subgraphs, loss {res['loss_first_quarter']:.4f} -> "
            f"{res['loss_last_quarter']:.4f}, test AUC "
            f"{res['test_auc']:.4f}; extract {res['extract_seconds']} s, "
            f"compile {res['compile_seconds']} s, train "
            f"{res['train_seconds']} s [{self.card}]")
        self._scale_ok("scale seal", res)

    # -- multi --------------------------------------------------------------

    def multi(self) -> None:
        import jax

        import __graft_entry__
        from linkpred.parallel import make_mesh
        from linkpred.pipelines.gcn_scale import ScaleGCNConfig, train_collab

        z = self.sizes
        n = z.multi_devices
        devs = jax.devices()
        check(len(devs) >= n, f"--multi needs {n} devices, JAX has "
              f"{len(devs)}")
        # the dry run's own equality checks compare sharded with replicated
        # matmul paths: run them at full f32 precision
        with jax.default_matmul_precision("highest"):
            __graft_entry__.dryrun_multichip(n)

        cfg = ScaleGCNConfig(steps=z.multi_gcn_steps, dtype="f32",
                             nodes=z.scale_nodes or ScaleGCNConfig.nodes,
                             edges=z.scale_edges or ScaleGCNConfig.edges)
        res = {}
        for shape in ((1, 1), (1, n)):
            mesh = make_mesh(n_devices=shape[1], shape=shape)
            with jax.default_matmul_precision("highest"):
                res[shape] = train_collab(cfg, mesh=mesh, verbose=False)
            r = res[shape]
            peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                     for d in mesh.devices.flat]
            say(f"gcn {cfg.nodes} nodes f32 on mesh {shape}: peak bytes per "
                f"device {peaks}")
            say(f"gcn {cfg.nodes} nodes f32 on mesh {shape}: "
                f"losses {[round(v, 5) for v in r['losses']]}, test AUC "
                f"{r['test_auc']:.4f}, {r['steps_per_s']} steps/s, "
                f"compile {r['compile_seconds']} s [{self.card}]")
        a, b = np.asarray(res[(1, 1)]["losses"]), np.asarray(
            res[(1, n)]["losses"])
        # one seed, same math; the shards only reorder f32 sums, and Adam
        # turns that into at most lr-sized steps on near-zero gradient
        # entries, which move the loss by far less than 1e-3
        d = float(np.abs(a - b).max())
        say(f"gcn (1, {n}) vs (1, 1): max |dloss| over "
            f"{len(a)} steps {d:.2e} (tol 1e-3)")
        check(d <= 1e-3, f"sharded GCN losses differ by {d}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for every artifact of the run")
    args = ap.parse_args(argv)

    import jax

    smoke = Smoke(Sizes(), os.path.abspath(args.out))
    smoke.run_phase("device", smoke.device)
    if smoke.failed:
        say("chip_smoke.py needs an NVIDIA GPU and this repository")
        return 1
    os.makedirs(smoke.out_dir, exist_ok=True)
    os.chdir(smoke.out_dir)
    for name in phases_for(args.multi)[1:]:
        smoke.run_phase(name, getattr(smoke, name))
    if smoke.failed:
        say(f"FAILED phases: {', '.join(smoke.failed)}")
        return 1
    say(f"card: {smoke.card}")
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
