#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (h2o_kubernetes_tpu_torch): the
scorer-replica serving path, binomial GBM training, DRF and multinomial
GBM training on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, in order; any failure exits non-zero:

1. device  — require CUDA; print the card (nvidia-smi name, power
   limit) and switch TF32 off for matmuls and cuDNN;
2. build   — compile every CUDA kernel from this checkout's sources, one
   nvcc per source, all started together; print ptxas registers/spills;
3. model   — a seeded full-width binomial GBM (28 features, 20 trees
   grown out to depth 5) as MOJO-v2 artifact bytes, HIGGS-shaped rows
   (normals, ~1% NaN), and margins checked against a float64 numpy
   descent;
4. kernels — shap_tab against its plain torch version at every depth
   group of the serving model, at the rows the serving path hands it
   (the 100,000-row batch, whole, and 1, 127, 128 and 4,096 rows):
   bitwise equal, the launch variant per group (staged / unstaged
   ctab, phi on chip / in device memory), and median times (CUDA
   events, from a flushed L2) against the bound;
5. serve   — the serving main path: start_server on the card, load the
   artifact over REST, POST predictions and contributions requests,
   check them (additivity of contributions against logit(p1)), and
   count the kernel launches the path made;
6. direct  — score_numpy and contrib_numpy on 100,000 rows, warm, as
   rows/s; contrib_numpy must launch shap_tab once per depth group per
   call (the whole batch, unchunked);
7. train   — the training main path: bench.py's workload (1,000,000
   rows, 10 features, GBM ntrees=10 max_depth=5 learn_rate=0.2
   bernoulli) on the card, a warm-up train then five timed ones:
   rows·trees/s at their median (and their spread), train AUC and
   logloss, histogram launches per train;
8. deep    — the same frame at max_depth=10, ntrees=2: the deep levels
   (64, 128 and 256 nodes, B2's) take the histogram kernel's
   partitioned regime (the row partition kernels, then the histogram
   over each tile's sorted rows);
9. hist    — the histogram kernel against its plain version and against
   one index_add_ at every level input the two trains gave it (depth 5:
   levels 0-4, the root at 2 channels, the AUC's 4096 int16 bins; depth
   10: levels 0-9): each cell's distance from the float64 sum, relative
   to the cell's Σ|v|, at most 1e-4, and exactly 0 difference on dyadic
   values; a control (the kernel fed bf16-rounded values) must exceed
   that limit; median times (CUDA events, from a flushed L2) and the
   bound; per train, the kernel's summed time against the summed bound
   over its launches; the row partition kernels against their plain
   version (a stable sort) at the 256-node level, bitwise;
10. parity — one tree grown from dyadic gradients at 1,000,000 rows on
   the card and on the CPU, bitwise equal; a 65,536-row slice trained
   on both, train AUC and logloss within 1e-4;
11. serve trained — score_numpy and contrib_numpy of the trained model
   on 100,000 rows (shap_tab on trees the port grew, one launch per
   group), additivity against logit(p1) ≤ 1e-4, and shap_tab held and
   timed at its groups as in phase 4; model_performance on the
   1,000,000-row frame, whose AUC is one histogram-kernel launch on the
   card;
12. drf — drf_higgs's shape (tools/bench_suite.py:225-232): 1,000,000
   HIGGS-shaped rows, DRF ntrees=10 max_depth=8 seed=1 (64 bins, mtries
   5, sample_rate 0.632: one batched histogram launch per level for all
   10 trees, streamed at the shallow levels, partitioned at the deep
   ones); a first train, five warm ones
   (median and spread, rows·trees/s), train AUC, launches by mode; the
   forest grown on the CPU from the same frame must equal the card's
   bitwise in structure (leaves ≤ 1e-6); it serves through score_numpy
   and contrib_numpy, Σφ = p1 ≤ 1e-4, one shap_tab launch per group,
   and shap_tab is held and timed at its groups as in phase 4 (its
   depth-8 group reads ctab through the read-only path);
13. multinomial — gbm_multinomial's shape (tools/bench_suite.py:
   243-265): 500,000 rows x 10 features, 4 classes, GBM ntrees=5
   max_depth=5 learn_rate=0.2; warm trains as rows·classtrees/s, train
   logloss, model_performance (one AUC launch per class); card vs CPU
   train logloss ≤ 1e-4 at 65,536 rows;
14. B3 — the batched kernel against its plain version and one
   index_add_ at every level input the two trains gave it (DRF: levels
   0-7, 10 to 640 tree·nodes, C=2; multinomial: levels 0-4, 4 to 32
   tree·nodes, C=3), held as in phase 9, with the per-train sums; the
   row partition at the DRF's deepest level; a bf16 control over all
   compared levels must exceed the limit;
15. report — one JSON line of kernel records (B4 with its variants,
   B1, B2, B3, each histogram record with the regimes it ran in, and the
   row partition),
   the card line, and as the last line {"ok": true, "device": {...}}.

``--profile`` adds torch.profiler breakdowns of one warm score_numpy,
contrib_numpy, GBM train, DRF train and multinomial train call.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import statistics
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and
# non-tensor-core fp32 operations/s
_HBM_BYTES_PER_S = 3.35e12
_FP32_OPS_PER_S = 67e12
# per (row, real path slot) in the TreeSHAP kernel: two compares, the
# NA test, the OR, the pattern bit, and the f32 add into phi
_SHAP_OPS_PER_SLOT = 6
# the serving bench's batch (tools/bench_suite.py:346-349) and the
# number of warm timed calls per median
_ROWS = 100_000
_REPEATS = 5
_L2_FLUSH_BYTES = 128 << 20     # > the H100's 50 MB L2
# bench.py's on-chip training shape (bench.py:134-151) and the row count
# up to which the AUC and the bin edges take their exact paths
_TRAIN_ROWS = 1_000_000
_TRAIN_TREES = 10
_PARITY_ROWS = 65_536
# drf_higgs (tools/bench_suite.py:225-232): DRF on HIGGS, 10 trees of
# depth 8; gbm_multinomial (tools/bench_suite.py:243-265): 500,000 rows,
# 10 features, 4 classes, 5 rounds of depth 5
_DRF_ROWS = 1_000_000
_DRF_TREES = 10
_DRF_DEPTH = 8
_MN_ROWS = 500_000
_MN_TREES = 5
_WARM_TRAINS = 5                # timed warm trains; the median is reported
# a histogram cell may be this far from the float64 sum, relative to
# its Σ|v|: above the kernel's float32 rounding at 1,000,000 rows, below
# what bf16-rounded values give
_HIST_REL_LIMIT = 1e-4


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, repeats: int, flush=None, warm: int = 1,
             lead_cycles: int = 0) -> float:
    """Median milliseconds of fn() on the current stream after ``warm``
    untimed calls; with a ``flush`` buffer larger than the L2 cache, that
    buffer is rewritten before each timed call, so fn() finds its inputs
    in device memory. ``lead_cycles`` keeps the card spinning that long
    before the start event, so that the wrapper's host work is done
    before the card reaches it and the time is the kernel's alone."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _host_s(fn, repeats: int) -> float:
    """Median seconds of fn() (which returns host data, so synced)."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _profile(torch, name: str, fn, top: int = 6) -> None:
    """One warm call of fn under torch.profiler: wall time, the device
    time summed over device-side events (kernels and copies on one
    stream, so the busy time) and the top of them by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):      # profiler start-up, not timed
        torch.ones(1, device="cuda").sum().item()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0
           and e.key != "Activity Buffer Request"]
    dev_us = sum(e.self_device_time_total for e in dev)
    _log(f"[profile] {name}: wall {wall_us / 1e3:.3f} ms (profiled), "
         f"device busy {dev_us / 1e3:.3f} ms = "
         f"{dev_us / wall_us:.1%} of wall")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        _log(f"[profile] {name}:   {e.key[:70]}: "
             f"{e.self_device_time_total / 1e3:.3f} ms over {e.count} "
             "calls")


def _numpy_margin(arrays: dict, X: np.ndarray, levels: int) -> np.ndarray:
    """float64 numpy descent of a K=1 flat ensemble: the reference the
    device margins are checked against."""
    sf, th = arrays["flat_split_feat"], arrays["flat_thresh"]
    lf, nl = arrays["flat_left"], arrays["flat_na_left"]
    val = arrays["flat_value"]
    em = arrays["enum_mask"].astype(bool)
    Xc = np.where(em[None, :] & (X < 0), np.nan, X)
    rows = np.arange(X.shape[0])
    total = np.zeros(X.shape[0])
    for t in range(sf.shape[0]):
        node = np.zeros(X.shape[0], dtype=np.int64)
        for _ in range(levels):
            f = sf[t][node]
            x = Xc[rows, np.maximum(f, 0)]
            with np.errstate(invalid="ignore"):
                go_r = np.where(np.isnan(x), ~nl[t][node],
                                x >= th[t][node])
            node = np.where(f >= 0, lf[t][node] + go_r, node)
        total += val[t][node]
    return total + float(arrays["init_score"].ravel()[0])


def _post(port: int, path: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _json_rows(X: np.ndarray) -> list:
    return [[None if np.isnan(v) else float(v) for v in row] for row in X]


def _bench_cols(rows: int, seed: int) -> dict:
    """bench.py's training table (bench.py:137-146): 8 normal columns,
    an 8-level enum c1, dep_delay ~ exponential(10), and the label."""
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(8)}
    X["c1"] = np.array(list("abcdefgh"))[rng.integers(0, 8, size=rows)]
    X["dep_delay"] = rng.exponential(10.0, size=rows).astype(np.float32)
    logit = (1.2 * X["x0"] - 0.8 * X["x1"] + 0.05 * X["dep_delay"]
             - 1.0 + rng.normal(scale=0.5, size=rows))
    X["y"] = np.where(logit > 0, "late", "ontime")
    return X


def _higgs_cols(rows: int, seed: int) -> tuple[dict, dict]:
    """HIGGS shape (tools/datasets.py:159-170): 28 standard-normal
    features and a binary response from nonlinear combinations."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 28)).astype(np.float32)
    logit = (0.8 * X[:, 0] - 0.6 * X[:, 1] * X[:, 2]
             + 0.5 * np.abs(X[:, 3]) - 0.4 * (X[:, 4] ** 2)
             + rng.normal(scale=0.7, size=rows))
    cols = {f"f{i}": X[:, i] for i in range(28)}
    cols["y"] = (logit > 0).astype(np.float32)
    return cols, {"y": ["b", "s"]}


def _multinomial_cols(rows: int, seed: int) -> dict:
    """gbm_multinomial's table (tools/bench_suite.py:248-256): 10 normal
    columns, classes a/b by a score's tails, c/d by a third column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 10)).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1]
    y = np.where(score > 0.6, "a", np.where(
        score < -0.6, "b", np.where(X[:, 2] > 0, "c", "d")))
    cols = {f"f{i}": X[:, i] for i in range(10)}
    cols["y"] = y
    return cols


class _HistRecorder:
    """Keeps the first (binned, rel, vals) the training path hands the
    histogram kernel at each level, and counts the calls per level, so
    the kernel can be compared and timed at exactly those inputs and
    weighted by its launches. A level is keyed (K, n_bins, C, code
    dtype, depth): after the root only left children are histogrammed,
    so depth d >= 1 has max(1, 2**(d-1)) nodes and a one-node call
    right after a root is depth 1. It wraps the batched wrapper (the
    single-tree wrapper is its K=1 call), which still counts its own
    launches."""

    def __init__(self, hist_op):
        self.op, self.kernel, self.seen = hist_op, \
            hist_op.build_histogram_batched, {}
        self.calls, self.last = {}, {}

    def __enter__(self):
        def record(binned, rel, vals, n_nodes, n_bins):
            kind = (rel.shape[0], n_bins, vals.shape[2], binned.dtype)
            if n_nodes > 1:
                depth = n_nodes.bit_length()
            else:
                depth = 1 if self.last.get(kind) == 0 else 0
            self.last[kind] = depth
            key = kind + (depth,)
            self.seen.setdefault(key, (binned, rel, vals, n_nodes))
            self.calls[key] = self.calls.get(key, 0) + 1
            return self.kernel(binned, rel, vals, n_nodes, n_bins)

        self.op.build_histogram_batched = record
        return self

    def __exit__(self, *exc):
        self.op.build_histogram_batched = self.kernel

    def levels(self, K, n_bins, C, dtype):
        """[(depth, inputs, calls)] of one kind, by depth."""
        return sorted((k[4], v, self.calls[k]) for k, v in self.seen.items()
                      if k[:4] == (K, n_bins, C, dtype))


def _hist_compare(torch, hist_op, binned, rel, vals, n, B,
                  repeats: int) -> dict:
    """The histogram kernel (over K trees: rel [K, rows], vals [K, rows,
    C]) against its plain version (general values, then dyadic ones)
    and one index_add_ at these inputs: errors, median CUDA-event times
    and the bound.

    Errors are per cell, relative to the cell's Σ|v|, against the
    float64 sum (the plain version on float64 values). A cell of a
    1,000,000-row root level sums up to ~125,000 rows, and a float32
    running sum of that many equal hessians drifts by up to ~1e-3 of the
    sum, so float32 results are held to the float64 sum, not to each
    other. The control is the kernel fed the values rounded to bf16
    (what a kernel that accumulated in bf16 would at best give); it
    tells nothing where bf16 keeps the values (0/1 weights, DRF's
    integer targets), and is then left out."""
    kern, plain = hist_op.build_histogram_batched, \
        hist_op.histogram_batched_plain
    F, rows = binned.shape
    K, C = rel.shape[0], vals.shape[2]
    before = dict(hist_op.LAUNCHES)
    out_k = kern(binned, rel, vals, n, B)
    ran = {m: c - before[m] for m, c in hist_op.LAUNCHES.items()
           if c != before[m]}
    if list(ran.values()) != [1]:
        raise RuntimeError(f"histogram {K}x{n}x{B}x{C}: one launch "
                           f"expected, counted {ran}")
    out_p = plain(binned, rel, vals, n, B)
    exact = plain(binned, rel, vals.double(), n, B)
    scale = plain(binned, rel, vals.abs().double(), n, B)
    torch.cuda.synchronize()
    if not (torch.isfinite(out_k).all()
            and out_k.shape == (K, n, F, B, C)):
        raise RuntimeError(f"histogram {K}x{n}x{B}x{C}: bad output")
    if bool(((scale == 0) & (out_k != 0)).any()):
        raise RuntimeError(f"histogram {K}x{n}x{B}x{C}: mass in an empty "
                           "cell")

    def rel_err(out):
        return float(((out.double() - exact).abs()
                      / scale.clamp(min=1e-300)).max())
    g = torch.Generator(device=vals.device).manual_seed(K * n * B + C)
    dy = torch.randint(-2, 3, vals.shape, generator=g, device=vals.device
                       ).float() * 0.5
    dy = torch.where(rel[..., None] >= 0, dy, 0.0)
    dyadic_equal = torch.equal(kern(binned, rel, dy, n, B),
                               plain(binned, rel, dy, n, B))
    v16 = vals.bfloat16().float()
    control_rel_err = rel_err(kern(binned, rel, v16, n, B))
    # the library call: one index_add_ into [(K·n+1)·F·B, C] on a flat
    # index computed once (dead rows into the junk node K·n)
    kn = (torch.arange(K, device=rel.device)[:, None] * n + rel).long()
    seg = torch.where(rel >= 0, kn, K * n).reshape(-1)       # [K·rows]
    idx = ((seg[None, :] * F + torch.arange(F, device=seg.device)[:, None])
           * B + binned.long().repeat(1, K)).reshape(-1)
    src = vals.reshape(K * rows, C).repeat(F, 1)
    acc = torch.zeros(((K * n + 1) * F * B, C), device=vals.device)

    def library():
        acc.zero_()
        acc.index_add_(0, idx, src)

    library()
    lib_err = rel_err(acc[: K * n * F * B].view(K, n, F, B, C))
    # a level's codes, rel and vals fit the 50 MB L2 at the smaller
    # shapes: every timing starts from a flushed cache
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=vals.device)
    ms = _cuda_ms(torch, lambda: kern(binned, rel, vals, n, B), repeats,
                  flush)
    plain_ms = _cuda_ms(torch, lambda: plain(binned, rel, vals, n, B), 3,
                        flush)
    library_ms = _cuda_ms(torch, library, repeats, flush)
    live = int((rel >= 0).sum())
    nbytes = (F * rows * binned.element_size() + 4 * K * rows
              + 4 * K * C * rows + 4 * K * n * F * B * C)
    ops = F * C * live
    bytes_ms = nbytes / _HBM_BYTES_PER_S * 1e3
    ops_ms = ops / _FP32_OPS_PER_S * 1e3
    return {"K": K, "n_nodes": n, "n_bins": B, "C": C, "F": F,
            "rows": rows, "live_rows": live,
            "codes": str(binned.dtype).split(".")[-1],
            "mode": next(iter(ran)),
            "max_abs_err": float((out_k - out_p).abs().max()),
            "max_rel_err": rel_err(out_k), "plain_rel_err": rel_err(out_p),
            "library_rel_err": lib_err, "dyadic_equal": dyadic_equal,
            "control_rel_err": control_rel_err,
            "bf16_changes_vals": not torch.equal(v16, vals),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def _log_hist(name: str, res: dict, card: str) -> None:
    _log(f"[hist] {name}: {res['mode']} mode, K={res['K']} x "
         f"{res['n_nodes']} nodes x {res['n_bins']} bins x C={res['C']}, "
         f"F={res['F']}, {res['rows']} rows ({res['live_rows']} live "
         f"tree·rows), {res['codes']} codes: kernel {res['ms']:.4f} ms, "
         f"plain {res['plain_ms']:.4f} ms, index_add_ "
         f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
         f"{res['bound_by']}; max |kernel - plain| {res['max_abs_err']:.3e}"
         f"; max |x - float64 sum| / cell sum|v|: kernel "
         f"{res['max_rel_err']:.3e}, plain {res['plain_rel_err']:.3e}, "
         f"index_add_ {res['library_rel_err']:.3e}, control (kernel on "
         f"bf16 values) {res['control_rel_err']:.3e}; dyadic bitwise "
         f"{res['dyadic_equal']} [{card}]")
    if res["max_rel_err"] > _HIST_REL_LIMIT or not res["dyadic_equal"]:
        raise RuntimeError(f"histogram kernel disagrees at {name}")


def _partition_compare(torch, hist_op, binned, rel, vals, n, repeats: int,
                       name: str, card: str) -> dict:
    """The row partition kernels (count, scan, scatter) against their
    plain version (a stable sort) at a level's inputs: bitwise equal,
    median times from a flushed L2, and the byte bound (rel and codes
    read once, the live pairs' vals read once; the sorted codes, vals
    and segment starts written once)."""
    F, rows = binned.shape
    K, C = rel.shape[0], vals.shape[2]
    stride = 16 * -(-F * binned.element_size() // 16)
    def kern():
        return hist_op.row_partition(binned, rel, vals, n, stride)

    def plain():
        return hist_op.row_partition_plain(binned, rel, vals, n, stride)

    got, want = kern(), plain()
    live = int(want[0][-1])
    equal = (torch.equal(got[0], want[0]) and torch.equal(got[1][:live],
                                                          want[1])
             and torch.equal(got[2][:live], want[2]))
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=vals.device)
    ms = _cuda_ms(torch, kern, repeats, flush)
    plain_ms = _cuda_ms(torch, plain, 3, flush)
    nbytes = (4 * K * rows + F * rows * binned.element_size()
              + live * (4 * C + stride + 4 * C) + 4 * (K * n + 1))
    res = {"K": K, "n_nodes": n, "F": F, "rows": rows, "live_pairs": live,
           "equal": equal, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": nbytes / _HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "max_abs_err": 0.0 if equal else float("nan"), "bytes": nbytes}
    _log(f"[hist] row partition at {name}: K={K} x {n} nodes, F={F}, "
         f"{rows} rows ({live} live pairs): kernels {ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms by bytes; "
         f"bitwise equal to the plain version {equal} [{card}]")
    if not equal:
        raise RuntimeError(f"the row partition disagrees at {name}")
    return res


def _log_sums(sums: dict, names, card: str) -> None:
    """Per train: its histogram launches, the kernel's time summed over
    them (each level's median times its launches) against the summed
    bound — the launches x gap that orders the kernel work."""
    for name in names:
        calls, ms, bound = sums[name]
        _log(f"[hist] {name} train: {calls} launches per train, kernel "
             f"{ms:.4f} ms against a bound of {bound:.4f} ms (gap "
             f"{ms - bound:.4f} ms) [{card}]")


def _shap_compare(torch, shap_kernel, model, X: np.ndarray, label: str,
                  card: str) -> dict:
    """shap_tab against its plain version at every depth group of
    ``model``: bitwise equal at the whole batch and at 1, 127, 128 and
    4,096 rows, median times from a flushed L2 at the batch, and the
    bound — the bytes of X and phi (each read or written once) plus the
    tables over 3.35 TB/s, or the _SHAP_OPS_PER_SLOT operations per (row,
    real slot) and one per (row, tree) over 67 TFLOP/s, the larger; per
    group and over all groups."""
    kern, plain = (shap_kernel.flat_shap_tab_kernel,
                   shap_kernel.flat_shap_tab_plain)
    groups, ctabs = model._contrib_prepare()
    em = model._contrib_enum_mask()
    Xd = torch.as_tensor(X, device=model.device)
    rows, F = Xd.shape
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=model.device)
    res = {"groups": [], "ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    bytes_moved, ops = 0, 0
    for gi, (g, ct, sl) in enumerate(zip(groups, ctabs, model._shap_slots)):
        if ct is None:
            raise RuntimeError(f"{label} group {gi} has no pattern table")
        T, L, D = g.feat.shape
        plan = shap_kernel.shap_plan(F, T, L, D, rows)
        equal, d = True, 0.0
        for n in (rows, 1, 127, 128, 4096):
            Xn = Xd[:n]
            out_k = kern(g, ct, Xn, em, slots=sl)
            out_p = plain(g, ct, Xn, em)
            torch.cuda.synchronize()
            if not (out_k.shape == (min(n, rows), F + 1)
                    and torch.isfinite(out_k).all()
                    and torch.isfinite(out_p).all()):
                raise RuntimeError(f"{label} group {gi}: bad output at "
                                   f"{n} rows")
            equal &= torch.equal(out_k, out_p)
            d = max(d, float((out_k - out_p).abs().max()))
        # ten warm calls: the plain version's small launches before this
        # leave the card's clocks low; the wrapper's host work (checks,
        # plan) is hidden behind a spin of ~0.5 ms
        gk = _cuda_ms(torch, lambda: kern(g, ct, Xd, em, slots=sl),
                      _REPEATS * 2, flush, warm=10, lead_cycles=1_000_000)
        gp = _cuda_ms(torch, lambda: plain(g, ct, Xd, em), 2, flush)
        slots = int((g.feat >= 0).sum())
        tab_bytes = sum(t.numel() * t.element_size() for t in
                        (g.feat, g.lo, g.hi, g.na_ok, g.bias, ct))
        g_bytes = rows * (2 * F + 1) * 4 + tab_bytes
        g_ops = rows * (slots * _SHAP_OPS_PER_SLOT + T)
        bytes_moved += g_bytes
        ops += g_ops
        g_bound = max(g_bytes / _HBM_BYTES_PER_S, g_ops / _FP32_OPS_PER_S) \
            * 1e3
        _log(f"[kernels] shap_tab {label} group {gi}: T={T} L={L} D={D} "
             f"real slots={slots}; {plan.variant} (rows/block "
             f"{plan.threads}, {plan.stages} ctab stages, "
             f"{plan.smem_bytes} B shared, {plan.blocks_per_sm} blocks/SM); "
             f"bitwise {equal}; kernel {gk:.4f} ms plain {gp:.4f} ms bound "
             f"{g_bound:.4f} ms = {gk / g_bound:.1f}x [{card}]")
        if not equal:
            raise RuntimeError(f"shap_tab differs from its plain version at "
                               f"{label} group {gi} by {d}")
        res["groups"].append({"T": T, "L": L, "D": D, "variant": plan.variant,
                              "threads": plan.threads, "stages": plan.stages,
                              "ms": gk, "plain_ms": gp, "bound_ms": g_bound})
        res["ms"] += gk
        res["plain_ms"] += gp
        res["max_abs_err"] = max(res["max_abs_err"], d)
    bytes_ms = bytes_moved / _HBM_BYTES_PER_S * 1e3
    ops_ms = ops / _FP32_OPS_PER_S * 1e3
    res.update(rows=rows, bound_ms=max(bytes_ms, ops_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               bytes=bytes_moved, ops=ops,
               variants=sorted({g["variant"] for g in res["groups"]}))
    _log(f"[kernels] shap_tab {label}, all {len(groups)} groups at {rows} "
         f"rows: kernel {res['ms']:.4f} ms plain {res['plain_ms']:.4f} ms; "
         f"bound {res['bound_ms']:.4f} ms by {res['bound_by']} "
         f"({bytes_moved} bytes, {ops} ops) = "
         f"{res['ms'] / res['bound_ms']:.1f}x; variants {res['variants']} "
         f"[{card}]")
    return res


def _warm_trains(fit, n: int) -> tuple[list[float], object]:
    """Wall seconds of n trains (each ends on host data: its metrics)."""
    times, model = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        model = fit()
        times.append(time.perf_counter() - t0)
    return times, model


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm score_numpy, contrib_numpy "
                         "and train call of each kind with torch.profiler "
                         "and print where the device time goes")
    args = ap.parse_args()

    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — nothing to run",
              file=sys.stderr)
        return 2
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"[device] nvidia-smi: {card}")
    _log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {kind} count {torch.cuda.device_count()}")
    _log(f"[device] matmul.allow_tf32="
         f"{torch.backends.cuda.matmul.allow_tf32} "
         f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    from h2o_kubernetes_tpu_torch import load_artifact, rest, start_server
    from h2o_kubernetes_tpu_torch.mojo import read_mojo_parts
    from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
        random_rows, random_tree_artifact)
    from h2o_kubernetes_tpu_torch.ops import shap_kernel

    # -- 2. build ------------------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    from h2o_kubernetes_tpu_torch.ops import histogram as hist_op

    libs = (shap_kernel.LIB, hist_op.LIB)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:     # one nvcc per source
        build_s = list(pool.map(lambda lib: lib.build(), libs))
    _log(f"[build] all kernels in {time.perf_counter() - t0:.2f}s")
    for lib, secs in zip(libs, build_s):
        _log(f"[build] {lib.source.name} built+loaded in {secs:.2f}s")
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                _log(f"[build] {lib.source.name} ptxas: {line.strip()}")

    # -- 3. model ------------------------------------------------------------
    F, NTREES, DEPTH = 28, 20, 5
    # p_leaf=0: every branch grows to depth 5, as a GBM trained on
    # 100k HIGGS rows does (~32 leaves per tree)
    blob = random_tree_artifact(args.seed, n_features=F, ntrees=NTREES,
                                max_depth=DEPTH, p_leaf=0.0)
    _, arrays, _ = read_mojo_parts(io.BytesIO(blob))
    X = random_rows(args.seed + 1000, _ROWS, F, nan_frac=0.01)
    model = load_artifact(blob)
    dev = model.device
    _log(f"[model] binomial GBM F={F} ntrees={NTREES} depth={DEPTH} "
         f"artifact {len(blob)} bytes; rows {X.shape} on {dev}")
    n0 = min(4096, X.shape[0])
    p_small = model.score_numpy(X[:n0])
    want = _numpy_margin(arrays, X[:n0], DEPTH)
    got = np.log(p_small[:, 1].astype(np.float64)
                 / (1.0 - p_small[:, 1].astype(np.float64)))
    err = float(np.abs(got - want).max())
    _log(f"[model] margins vs float64 numpy descent: max abs {err:.3e}")
    if not (p_small.shape == (n0, 2) and np.isfinite(p_small).all()
            and err <= 1e-4):
        raise RuntimeError("device margins disagree with the reference")

    # -- 4. kernels vs plain -------------------------------------------------
    kern = shap_kernel.flat_shap_tab_kernel
    shap = {"serving": _shap_compare(torch, shap_kernel, model, X,
                                     "serving", card)}
    rows = X.shape[0]
    n_groups = len(shap["serving"]["groups"])

    # -- 5. main path through REST -------------------------------------------
    shap_kernel.reset_launches()
    srv = start_server(port=0)
    port = srv.server_address[1]
    try:
        code, resp = _post(port, "/3/ModelRegistry/load", {
            "model_id": "higgs_gbm",
            "artifact_b64": base64.b64encode(blob).decode(),
            "warm_buckets": [128, 4096]})
        if code != 200 or not resp.get("contributions"):
            raise RuntimeError(f"registry load failed: {code} {resp}")
        _log(f"[serve] loaded on {resp['device']}, warmed "
             f"{resp['warmed_buckets']}")
        cols = [f"x{i}" for i in range(F)]
        launches_contrib = 0
        served = []
        for n in (min(n, rows) for n in (128, 1000, 4096)):
            body = {"rows": _json_rows(X[:n]), "columns": cols}
            code, pr = _post(port, "/3/Predictions/models/higgs_gbm", body)
            if code != 200:
                raise RuntimeError(f"predictions {n}: {code} {pr}")
            before = kern.launches
            code, cr = _post(
                port, "/3/Predictions/models/higgs_gbm/contributions", body)
            if code != 200:
                raise RuntimeError(f"contributions {n}: {code} {cr}")
            launches_contrib += kern.launches - before
            served.append((n, np.asarray(pr["p1"], dtype=np.float64),
                           np.asarray(cr["contributions"],
                                      dtype=np.float64)))
        main_launches = kern.launches
        main_variants = dict(shap_kernel.LAUNCHES)
    finally:
        srv.shutdown()
        srv.server_close()
    worst_add, worst_p, worst_c = 0.0, 0.0, 0.0
    for n, p1, phi in served:
        if phi.shape != (n, F + 1) or not np.isfinite(phi).all():
            raise RuntimeError(f"contributions {n}: bad shape/values")
        logit = np.log(p1 / (1.0 - p1))
        worst_add = max(worst_add,
                        float(np.abs(phi.sum(axis=1) - logit).max()))
        worst_p = max(worst_p, float(np.abs(
            p1 - model.score_numpy(X[:n])[:, 1]).max()))
        worst_c = max(worst_c, float(np.abs(
            phi - model.contrib_numpy(X[:n])).max()))
    _log(f"[serve] additivity max |sum(phi) - logit(p1)| = {worst_add:.3e}"
         f"; REST vs direct: p1 {worst_p:.3e}, phi {worst_c:.3e}")
    _log(f"[serve] shap_tab launches: {main_launches} on the main path "
         f"({main_variants}), {launches_contrib} during the contributions "
         "requests")
    if worst_add > 1e-4 or worst_p > 1e-6 or worst_c > 1e-6:
        raise RuntimeError("served results are wrong")
    if launches_contrib != len(served) * n_groups or main_launches <= 0:
        raise RuntimeError(f"the {len(served)} contributions requests made "
                           f"{launches_contrib} shap_tab launches, not one "
                           f"per group ({n_groups}) each")

    # -- 6. full width, direct -----------------------------------------------
    score_s = _host_s(lambda: model.score_numpy(X), _REPEATS)
    before = kern.launches
    contrib_s = _host_s(lambda: model.contrib_numpy(X), _REPEATS)
    launched = kern.launches - before
    per_call = launched // (_REPEATS + 1)
    _log(f"[direct] score_numpy {rows} rows: {score_s * 1e3:.3f} ms "
         f"= {rows / score_s:.0f} rows/s [{card}]")
    _log(f"[direct] contrib_numpy {rows} rows: {contrib_s * 1e3:.3f} ms "
         f"= {rows / contrib_s:.0f} rows/s, {per_call} shap_tab launches "
         f"per call over {n_groups} groups; dispatch (rows, padded) "
         f"{model._contrib_dispatch()} [{card}]")
    if launched != (_REPEATS + 1) * n_groups:
        raise RuntimeError(f"contrib_numpy made {launched} shap_tab launches "
                           f"in {_REPEATS + 1} calls, not one per group "
                           f"({n_groups}) per call")
    if args.profile:
        _profile(torch, "score_numpy", lambda: model.score_numpy(X))
        _profile(torch, "contrib_numpy", lambda: model.contrib_numpy(X))
    rest.BATCHER.stop(timeout=5.0)

    # -- 7. train: the training main path ------------------------------------
    from h2o_kubernetes_tpu_torch import GBM, Frame
    from h2o_kubernetes_tpu_torch.models.tree import core as tree_core

    hk = hist_op.LAUNCHES                  # histogram launches by regime
    cols = _bench_cols(_TRAIN_ROWS, args.seed)
    t0 = time.perf_counter()
    frame = Frame.from_arrays(cols)
    _log(f"[train] bench frame {_TRAIN_ROWS} rows x {len(cols) - 1} "
         f"features on {frame.device} in {time.perf_counter() - t0:.2f}s")

    def train(frame, depth=5, ntrees=_TRAIN_TREES):
        return GBM(ntrees=ntrees, max_depth=depth, learn_rate=0.2,
                   seed=1).train(y="y", training_frame=frame)

    with _HistRecorder(hist_op) as rec5:
        t0 = time.perf_counter()
        train(frame)                       # warm-up: bins and caches them
        warm_s = time.perf_counter() - t0
    hist_op.reset_launches()
    train_times, gbm = _warm_trains(lambda: train(frame), _WARM_TRAINS)
    train_launches = dict(hk)
    train_s = statistics.median(train_times)
    hist = gbm.scoring_history[-1]
    rate = _TRAIN_ROWS * _TRAIN_TREES / train_s
    _log(f"[train] GBM ntrees={_TRAIN_TREES} max_depth=5 bernoulli: first "
         f"train {warm_s:.3f}s (binning included); {_WARM_TRAINS} warm "
         f"trains {[round(t, 4) for t in train_times]} s, median "
         f"{train_s:.4f}s (min {min(train_times):.4f}, max "
         f"{max(train_times):.4f}) = gbm_boosted_rows_per_sec_per_chip "
         f"{rate:.0f} at the median; train_auc {hist['train_auc']:.6f} "
         f"train_logloss {hist['train_logloss']:.6f}; histogram launches "
         f"{train_launches} over {_WARM_TRAINS} trains [{card}]")
    if not (np.isfinite(hist["train_auc"]) and 0.5 < hist["train_auc"] <= 1
            and np.isfinite(hist["train_logloss"])):
        raise RuntimeError(f"bad training metrics {hist}")
    per_train = 5 * _TRAIN_TREES + 1
    if sum(train_launches.values()) != _WARM_TRAINS * per_train:
        raise RuntimeError(f"expected {per_train} histogram launches per "
                           f"train, got {train_launches} over "
                           f"{_WARM_TRAINS} trains")

    # -- 8. deep: B2's levels on the same path -------------------------------
    hist_op.reset_launches()
    with _HistRecorder(hist_op) as rec10:
        t0 = time.perf_counter()
        deep = train(frame, depth=10, ntrees=2)
        deep_s = time.perf_counter() - t0
    deep_launches = dict(hk)
    _log(f"[deep] GBM ntrees=2 max_depth=10: {deep_s:.3f}s, train_auc "
         f"{deep.scoring_history[-1]['train_auc']:.6f}; histogram launches "
         f"{deep_launches}, row partitions "
         f"{hist_op.PARTITION_LAUNCHES['row_partition']} [{card}]")
    deep_parts = hist_op.PARTITION_LAUNCHES["row_partition"]
    if deep_launches["partitioned"] <= 0 or deep_parts <= 0 or \
            sum(deep_launches.values()) != 10 * 2 + 1:
        raise RuntimeError("the depth-10 train did not launch 21 histograms"
                           f" with partitioned ones among them: "
                           f"{deep_launches}, {deep_parts} partitions")

    # -- 9. hist: kernel vs plain vs index_add_ at the path's inputs ---------
    u8, i16 = torch.uint8, torch.int16
    levels, sums = {}, {}

    def compare(train_name, rec, K, B, C, dtype, label, extra=()):
        """Every level of one kind the train handed the kernel, plus
        ``extra`` (name, inputs, n_bins, calls) cases, each held and
        timed; the train's calls x times are summed into ``sums``."""
        cases = [(f"{label} level {d}", inp, B, calls)
                 for d, inp, calls in rec.levels(K, B, C, dtype)]
        tot = sums.setdefault(train_name, [0, 0.0, 0.0])
        for name, (b, r, v, n), nb, calls in cases + list(extra):
            res = _hist_compare(torch, hist_op, b, r, v, n, nb,
                                _REPEATS * 2)
            res["calls_per_train"] = calls
            levels[name] = res
            _log_hist(name, res, card)
            tot[0] += calls
            tot[1] += calls * res["ms"]
            tot[2] += calls * res["bound_ms"]

    def auc(rec, label):
        (_, inp, calls), = rec.levels(1, 4096, 3, i16)
        return (f"auc ({label})", inp, 4096, calls)

    b, r, v, n = rec5.levels(1, 256, 3, u8)[0][1]
    compare("gbm depth 5", rec5, 1, 256, 3, u8, "gbm d5", [
        ("gbm d5 level 0 C=2", (b, r, v[..., [0, 2]].contiguous(), n), 256,
         0), auc(rec5, "gbm d5")])
    compare("gbm depth 10", rec10, 1, 256, 3, u8, "gbm d10",
            [auc(rec10, "gbm d10")])
    (_, (b, r, v, n), _), = [lv for lv in rec10.levels(1, 256, 3, u8)
                             if lv[0] == 9]
    parts = {"gbm d10 level 9": _partition_compare(
        torch, hist_op, b, r, v, n, _REPEATS * 2, "gbm d10 level 9", card)}
    _log_sums(sums, ("gbm depth 5", "gbm depth 10"), card)
    # -- 10. parity: the card against the CPU --------------------------------
    binned = frame.binned(gbm.bin_spec)
    yv = frame.vec("y").as_float()
    g = torch.where(yv > 0, 0.5, -0.5)
    h = torch.full_like(g, 0.25)
    w = torch.ones_like(g)
    tp = tree_core.TreeParams(max_depth=5, n_bins=256)
    t_card = tree_core.grow_tree(binned, g, h, w, tp)
    t_cpu = tree_core.grow_tree(binned.cpu(), g.cpu(), h.cpu(), w.cpu(), tp)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(t_card, t_cpu))
    _log(f"[parity] dyadic tree at {_TRAIN_ROWS} rows: card == CPU bitwise "
         f"{same} ({int(t_cpu.is_split.sum())} splits)")
    if not same:
        raise RuntimeError("the dyadic tree differs between card and CPU")
    n_s = _PARITY_ROWS
    small = {k: v[:n_s] for k, v in cols.items()}
    m_card = train(Frame.from_arrays(small)).scoring_history[-1]
    m_cpu = train(Frame.from_arrays(small, device="cpu")).scoring_history[-1]
    gaps = {k: abs(m_card[k] - m_cpu[k]) for k in ("train_auc",
                                                    "train_logloss")}
    _log(f"[parity] {n_s}-row train: card {m_card}, CPU {m_cpu}, "
         f"gaps {gaps}")
    if max(gaps.values()) > 1e-4:
        raise RuntimeError("card and CPU training disagree")

    # -- 11. serve the trained model -----------------------------------------
    Xt = gbm._design_matrix(frame)[:_ROWS].cpu().numpy()
    shap_kernel.reset_launches()
    p_t = gbm.score_numpy(Xt)
    phi_t = gbm.contrib_numpy(Xt)
    trained_launches = kern.launches
    add_t = float(np.abs(phi_t.astype(np.float64).sum(axis=1) - np.log(
        p_t[:, 1].astype(np.float64) / (1.0 - p_t[:, 1]))).max())
    serve_s = _host_s(lambda: gbm.contrib_numpy(Xt), 2)
    _log(f"[serve trained] {Xt.shape[0]} rows: additivity max "
         f"|sum(phi) - logit(p1)| = {add_t:.3e}; shap_tab launches "
         f"{trained_launches}; contrib_numpy {serve_s * 1e3:.3f} ms [{card}]")
    if not (np.isfinite(phi_t).all() and phi_t.shape == (_ROWS, 11)
            and add_t <= 1e-4):
        raise RuntimeError("serving the trained model failed")
    shap["trained gbm"] = _shap_compare(torch, shap_kernel, gbm, Xt,
                                        "trained gbm", card)
    if trained_launches != len(shap["trained gbm"]["groups"]):
        raise RuntimeError(f"contrib_numpy of the trained model made "
                           f"{trained_launches} shap_tab launches, not one "
                           "per group")
    hist_op.reset_launches()
    perf = gbm.model_performance(frame, y="y")
    perf_launches = dict(hk)
    _log(f"[serve trained] model_performance on {_TRAIN_ROWS} rows: "
         f"{perf}; histogram launches {perf_launches} (train_auc "
         f"{hist['train_auc']:.6f})")
    if sum(perf_launches.values()) != 1 \
            or abs(perf["auc"] - hist["train_auc"]) > 1e-4:
        raise RuntimeError("model_performance did not take the card's "
                           "histogram AUC or disagrees with the train AUC")
    if args.profile:
        _profile(torch, "train", lambda: train(frame), top=12)

    # -- 12. drf: a random forest at drf_higgs's shape ------------------------
    from h2o_kubernetes_tpu_torch import DRF

    bk = hist_op.BATCHED_LAUNCHES          # launches over K > 1 trees
    hcols, hdom = _higgs_cols(_DRF_ROWS, args.seed)
    t0 = time.perf_counter()
    hframe = Frame.from_arrays(hcols, domains=hdom)
    _log(f"[drf] HIGGS-shaped frame {_DRF_ROWS} rows x 28 features on "
         f"{hframe.device} in {time.perf_counter() - t0:.2f}s")

    def fit_drf(fr):
        return DRF(ntrees=_DRF_TREES, max_depth=_DRF_DEPTH, seed=1).train(
            y="y", training_frame=fr)

    with _HistRecorder(hist_op) as rec_drf:
        t0 = time.perf_counter()
        fit_drf(hframe)                    # first: bins and caches them
        drf_first_s = time.perf_counter() - t0
    hist_op.reset_launches()
    drf_times, drf = _warm_trains(lambda: fit_drf(hframe), _WARM_TRAINS)
    drf_launches, drf_batched = dict(hk), dict(bk)
    drf_parts = hist_op.PARTITION_LAUNCHES["row_partition"]
    drf_s = statistics.median(drf_times)
    dh = drf.scoring_history[-1]
    drf_G = tree_core.drf_group_size(
        _DRF_TREES, tree_core.TreeParams(max_depth=_DRF_DEPTH, n_bins=64,
                                         unit_hess=True), 28)[0]
    _log(f"[drf] DRF ntrees={_DRF_TREES} max_depth={_DRF_DEPTH} nbins="
         f"{drf.params.nbins} mtries={drf.params.mtries} sample_rate="
         f"{drf.params.sample_rate}: G={drf_G} trees per launch; "
         f"first train {drf_first_s:.3f}s (binning included); "
         f"{_WARM_TRAINS} warm trains {[round(t, 4) for t in drf_times]} s,"
         f" median {drf_s:.4f}s (min {min(drf_times):.4f}, max "
         f"{max(drf_times):.4f}) = drf rows·trees/s "
         f"{_DRF_ROWS * _DRF_TREES / drf_s:.0f} at the median; train_auc "
         f"{dh['train_auc']:.6f} train_logloss {dh['train_logloss']:.6f}; "
         f"histogram launches {drf_launches} ({drf_batched} over 10 trees) "
         f"and {drf_parts} row partitions over {_WARM_TRAINS} trains "
         f"[{card}]")
    if not (np.isfinite(dh["train_auc"]) and 0.5 < dh["train_auc"] <= 1):
        raise RuntimeError(f"bad DRF training metrics {dh}")
    if args.profile:
        _profile(torch, "drf train", lambda: fit_drf(hframe), top=12)
    # per train: the 8 histogrammed levels of one group of 10 trees (the
    # deeper ones partitioned) and the train AUC's one launch
    if sum(drf_batched.values()) != 8 * _WARM_TRAINS \
            or drf_batched["partitioned"] <= 0 or drf_parts <= 0 \
            or sum(drf_launches.values()) != 9 * _WARM_TRAINS:
        raise RuntimeError(f"unexpected DRF histogram launches "
                           f"{drf_launches} / batched {drf_batched}")
    t0 = time.perf_counter()
    drf_cpu = fit_drf(Frame.from_arrays(hcols, domains=hdom, device="cpu"))
    cpu_s = time.perf_counter() - t0
    struct = all(torch.equal(getattr(drf.trees, f).cpu(),
                             getattr(drf_cpu.trees, f))
                 for f in ("split_feat", "split_bin", "na_left", "is_split"))
    leaf_gap = float((drf.trees.value.cpu() - drf_cpu.trees.value).abs()
                     .max())
    _log(f"[drf] card vs CPU at {_DRF_ROWS} rows: split structure bitwise "
         f"{struct} ({int(drf_cpu.trees.is_split.sum())} splits), max leaf "
         f"gap {leaf_gap:.3e} (CPU train {cpu_s:.1f}s)")
    if not struct or leaf_gap > 1e-6:
        raise RuntimeError("the forest differs between card and CPU")
    Xh = drf._design_matrix(hframe)[:_ROWS].cpu().numpy()
    shap_kernel.reset_launches()
    p_h = drf.score_numpy(Xh)
    phi_h = drf.contrib_numpy(Xh)
    drf_shap_launches = kern.launches
    add_h = float(np.abs(phi_h.astype(np.float64).sum(axis=1)
                         - p_h[:, 1]).max())
    _log(f"[drf] serve {Xh.shape[0]} rows: additivity max |sum(phi) - p1| "
         f"= {add_h:.3e}; shap_tab launches {drf_shap_launches}")
    if not (np.isfinite(phi_h).all() and phi_h.shape == (_ROWS, 29)
            and add_h <= 1e-4):
        raise RuntimeError("serving the forest failed")
    shap["drf"] = _shap_compare(torch, shap_kernel, drf, Xh, "drf", card)
    if drf_shap_launches != len(shap["drf"]["groups"]):
        raise RuntimeError(f"contrib_numpy of the forest made "
                           f"{drf_shap_launches} shap_tab launches, not one "
                           "per group")
    held = {g["variant"] for r in shap.values() for g in r["groups"]}
    if not {"staged", "unstaged"} <= held:
        raise RuntimeError(f"shap_tab was held in variants {held}: both "
                           "ctab variants must run")

    # -- 13. multinomial: GBM at gbm_multinomial's shape --------------------
    mcols = _multinomial_cols(_MN_ROWS, args.seed)
    mframe = Frame.from_arrays(mcols)

    def fit_mn(fr):
        return GBM(ntrees=_MN_TREES, max_depth=5, learn_rate=0.2,
                   seed=1).train(y="y", training_frame=fr)

    with _HistRecorder(hist_op) as rec_mn:
        t0 = time.perf_counter()
        fit_mn(mframe)
        mn_first_s = time.perf_counter() - t0
    hist_op.reset_launches()
    mn_times, mn = _warm_trains(lambda: fit_mn(mframe), _WARM_TRAINS)
    mn_launches, mn_batched = dict(hk), dict(bk)
    mn_parts = hist_op.PARTITION_LAUNCHES["row_partition"]
    mn_s = statistics.median(mn_times)
    K = mn.nclasses
    mn_ll = mn.scoring_history[-1]["train_logloss"]
    _log(f"[multinomial] GBM ntrees={_MN_TREES} max_depth=5 K={K}: first "
         f"train {mn_first_s:.3f}s (binning included); {_WARM_TRAINS} warm "
         f"trains {[round(t, 4) for t in mn_times]} s, median {mn_s:.4f}s "
         f"(min {min(mn_times):.4f}, max {max(mn_times):.4f}) = "
         f"rows·classtrees/s {_MN_ROWS * _MN_TREES * K / mn_s:.0f} at the "
         f"median; train_logloss {mn_ll:.6f}; histogram launches "
         f"{mn_launches} ({mn_batched} over {K} trees) and {mn_parts} row "
         f"partitions over {_WARM_TRAINS} trains [{card}]")
    if not (K == 4 and np.isfinite(mn_ll) and 0 < mn_ll < np.log(4)):
        raise RuntimeError(f"bad multinomial training metrics {mn_ll}")
    if args.profile:
        _profile(torch, "multinomial train", lambda: fit_mn(mframe),
                 top=12)
    if sum(mn_batched.values()) != 5 * _MN_TREES * _WARM_TRAINS \
            or mn_launches != mn_batched:
        raise RuntimeError(f"unexpected multinomial histogram launches "
                           f"{mn_launches} / batched {mn_batched}")
    hist_op.reset_launches()
    mperf = mn.model_performance(mframe, y="y")
    mperf_launches = dict(hk)
    _log(f"[multinomial] model_performance on {_MN_ROWS} rows: {mperf}; "
         f"histogram launches {mperf_launches} (one AUC per class)")
    if sum(mperf_launches.values()) != K or not (
            0.5 < mperf["auc"] <= 1 and abs(mperf["logloss"] - mn_ll)
            <= 1e-4):
        raise RuntimeError("multinomial model_performance is wrong")
    small = {k: v[:_PARITY_ROWS] for k, v in mcols.items()}
    ll_card = fit_mn(Frame.from_arrays(small)).scoring_history[-1]
    ll_cpu = fit_mn(Frame.from_arrays(small, device="cpu")
                    ).scoring_history[-1]
    gap = abs(ll_card["train_logloss"] - ll_cpu["train_logloss"])
    _log(f"[multinomial] {_PARITY_ROWS}-row train: card {ll_card}, CPU "
         f"{ll_cpu}, gap {gap:.3e}")
    if gap > 1e-4:
        raise RuntimeError("card and CPU multinomial training disagree")

    # -- 14. B3: the batched launches at the two trains' inputs --------------
    compare("drf", rec_drf, _DRF_TREES, 64, 2, u8, "drf",
            [auc(rec_drf, "drf")])
    compare("multinomial", rec_mn, K, 256, 3, u8, "multinomial")
    (_, (b, r, v, n), _), = [lv for lv in rec_drf.levels(_DRF_TREES, 64, 2, u8)
                             if lv[0] == _DRF_DEPTH - 1]
    parts["drf level 7"] = _partition_compare(
        torch, hist_op, b, r, v, n, _REPEATS * 2, "drf level 7", card)
    _log_sums(sums, ("drf", "multinomial"), card)
    b3 = {k: v for k, v in levels.items() if v["K"] > 1}
    b3_modes = {r["mode"] for r in b3.values()}
    if len(b3) != _DRF_DEPTH + 5 or "partitioned" not in b3_modes or \
            not b3_modes & {"grouped", "replicated"} or \
            {r["C"] for r in b3.values()} != {2, 3}:
        raise RuntimeError("B3 was not compared at every level, in both "
                           f"regime families and widths: {b3_modes}")
    controls = [r["control_rel_err"] for r in levels.values()
                if r["bf16_changes_vals"]]
    _log(f"[hist] limit {_HIST_REL_LIMIT:.0e}: kernel at most "
         f"{max(r['max_rel_err'] for r in levels.values()):.3e}, control "
         f"at most {max(controls, default=0.0):.3e}")
    if max(controls, default=0.0) <= _HIST_REL_LIMIT:
        raise RuntimeError("the bf16 control stays within the histogram "
                           "limit: the check cannot tell f32 from bf16")

    # -- 15. report ----------------------------------------------------------
    sv = shap["serving"]
    record = {
        "name": "shap_tab", "route": "cuda",
        "source": "h2o_kubernetes_tpu_torch/csrc/shap_tab.cu",
        "replaces": "h2o_kubernetes_tpu/ops/shap_kernel.py:120 "
                    "(_shap_tab_kernel)",
        "launches": main_launches, "variants": main_variants,
        "max_abs_err": max(r["max_abs_err"] for r in shap.values()),
        "ms": sv["ms"], "plain_ms": sv["plain_ms"],
        "bound_ms": sv["bound_ms"], "bound_by": sv["bound_by"],
        "library_ms": None, "rows": rows,
        "launches_per_contrib_call": {"serving": per_call,
                                      "trained gbm": trained_launches,
                                      "drf": drf_shap_launches},
        "models": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "variants", "groups")}
                   for k, r in shap.items()},
    }
    records = [record]
    # the histogram kernel by the TPU kernel each level replaces: B1 the
    # depth-5 train (its root timed), B2 the depth-10 train's partitioned
    # levels (64 nodes and more; 256 timed), B3 the launches over K > 1
    # trees of the DRF and multinomial trains (DRF level 7 timed); each
    # with the regimes its launches ran in, every level it was held at,
    # and the per-train sums
    # the depth-10 train's partitioned launches are its calls at the
    # levels held in the partitioned regime (its deepest ones)
    deep_levels = {f"gbm d10 level {d}": c
                   for d, _, c in rec10.levels(1, 256, 3, u8)
                   if levels[f"gbm d10 level {d}"]["mode"] == "partitioned"}
    if deep_launches["partitioned"] != sum(deep_levels.values()) or \
            "gbm d10 level 9" not in deep_levels:
        raise RuntimeError(f"{deep_launches['partitioned']} partitioned "
                           "launches in the depth-10 train, calls at its "
                           f"partitioned levels {deep_levels}")
    fields = ("mode", "K", "n_nodes", "n_bins", "C", "calls_per_train",
              "ms", "plain_ms", "library_ms", "bound_ms", "max_rel_err",
              "plain_rel_err", "control_rel_err")
    for name, level, launches, regimes, replaces, trains, keep in (
            ("histogram", "gbm d5 level 0", sum(train_launches.values()),
             train_launches,
             "h2o_kubernetes_tpu/ops/histogram.py:141 (_hist_fact_kernel)",
             ("gbm depth 5",),
             lambda k, v: k.startswith(("gbm d5", "auc"))),
            ("histogram_deep", "gbm d10 level 9",
             deep_launches["partitioned"],
             {"partitioned": deep_launches["partitioned"]},
             "h2o_kubernetes_tpu/ops/histogram.py:300 (_hist_kernel)",
             ("gbm depth 10",),
             lambda k, v: k in deep_levels),
            ("histogram_batched", "drf level 7",
             sum(drf_batched.values()) + sum(mn_batched.values()),
             {r: drf_batched[r] + mn_batched[r] for r in drf_batched},
             "h2o_kubernetes_tpu/ops/histogram.py:399 (_hist_vmappable)",
             ("drf", "multinomial"), lambda k, v: v["K"] > 1)):
        res = levels[level]
        held = {k: v for k, v in levels.items() if keep(k, v)}
        records.append({
            "name": name, "route": "cuda",
            "source": "h2o_kubernetes_tpu_torch/csrc/histogram.cu",
            "replaces": replaces, "launches": launches, "regimes": regimes,
            "max_abs_err": max(v["max_abs_err"] for v in held.values()),
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"], "level": level,
            "max_rel_err": max(v["max_rel_err"] for v in held.values()),
            "rel_limit": _HIST_REL_LIMIT,
            "train_sums": {t: dict(zip(("launches", "ms", "bound_ms"),
                                       sums[t])) for t in trains},
            "levels": {k: {f: v[f] for f in fields}
                       for k, v in held.items()}})
    res = parts["drf level 7"]
    records.append({
        "name": "row_partition", "route": "cuda",
        "source": "h2o_kubernetes_tpu_torch/csrc/histogram.cu",
        "replaces": "h2o_kubernetes_tpu/ops/histogram.py:300 (_hist_kernel: "
                    "its node·bin blocking of the deep levels)",
        "launches": deep_parts + drf_parts + mn_parts,
        "max_abs_err": max(v["max_abs_err"] for v in parts.values()),
        "ms": res["ms"], "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
        "library_ms": None, "level": "drf level 7", "levels": parts})
    records[1]["warm_train_s"] = train_times
    records[3]["drf_warm_train_s"] = drf_times
    records[3]["multinomial_warm_train_s"] = mn_times
    _log(json.dumps({"kernels": records}))
    _log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
