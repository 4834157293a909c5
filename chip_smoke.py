#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (h2o_kubernetes_tpu_torch): the
scorer-replica serving path on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, in order; any failure exits non-zero:

1. device  — require CUDA; print the card (nvidia-smi name, power
   limit) and switch TF32 off for matmuls and cuDNN;
2. build   — compile the CUDA kernels from this checkout's sources;
3. model   — a seeded full-width binomial GBM (28 features, 20 trees
   grown out to depth 5) as MOJO-v2 artifact bytes, HIGGS-shaped rows
   (normals, ~1% NaN), and margins checked against a float64 numpy
   descent;
4. kernels — each kernel against its plain torch version at the shapes
   the serving path gives it (the 100,000-row batch, the contributions
   chunk, the smallest and largest warm buckets): max abs difference,
   and median times (CUDA events) at the batch and the chunk;
5. serve   — the main path: start_server on the card, load the
   artifact over REST, POST predictions and contributions requests,
   check them (additivity of contributions against logit(p1)), and
   count the kernel launches the path made;
6. direct  — score_numpy and contrib_numpy on 100,000 rows, warm, as
   rows/s;
7. report  — one JSON line of kernel records, the card line, and as
   the last line {"ok": true, "device": {...}}.
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


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, repeats: int) -> float:
    """Median milliseconds of fn() on the current stream, warm."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
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


def _profile(torch, name: str, fn) -> None:
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
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm score_numpy and contrib_numpy "
                         "call with torch.profiler and print where the "
                         "device time goes")
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
    build_s = shap_kernel.build()
    _log(f"[build] shap_tab.cu built+loaded in {build_s:.2f}s")
    for line in shap_kernel.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            _log(f"[build] ptxas: {line.strip()}")

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
    groups, ctabs = model._contrib_prepare()
    em = model._contrib_enum_mask()
    Xd = torch.as_tensor(X, device=dev)
    kern, plain = (shap_kernel.flat_shap_tab_kernel,
                   shap_kernel.flat_shap_tab_plain)
    max_err, k_ms, p_ms, c_ms = 0.0, 0.0, 0.0, 0.0
    bytes_moved, ops = 0, 0
    rows = X.shape[0]
    # contrib_numpy hands the kernel chunks of this many rows
    chunk = min(model._contrib_chunk(), rows)
    Xchunk = Xd[:chunk].contiguous()
    # the batch, the chunk, and the largest and smallest warm buckets
    compare_at = (Xd, Xchunk, Xd[:4096].contiguous(),
                  Xd[:128].contiguous())
    for gi, (g, ct) in enumerate(zip(groups, ctabs)):
        if ct is None:
            raise RuntimeError(f"group {gi} has no pattern table at the "
                               "bench shape")
        d = 0.0
        for Xc in compare_at:
            out_k = kern(g, ct, Xc, em)
            out_p = plain(g, ct, Xc, em)
            torch.cuda.synchronize()
            if not (torch.isfinite(out_k).all()
                    and torch.isfinite(out_p).all()):
                raise RuntimeError(f"group {gi}: output not finite at "
                                   f"{Xc.shape[0]} rows")
            d = max(d, float((out_k - out_p).abs().max()))
        gk = _cuda_ms(torch, lambda: kern(g, ct, Xd, em), _REPEATS)
        gp = _cuda_ms(torch, lambda: plain(g, ct, Xd, em), 2)
        gc = _cuda_ms(torch, lambda: kern(g, ct, Xchunk, em), _REPEATS)
        T, L, D = g.feat.shape
        slots = int((g.feat >= 0).sum())
        tab_bytes = sum(t.numel() * t.element_size() for t in
                        (g.feat, g.lo, g.hi, g.na_ok, g.bias, ct))
        bytes_moved += rows * (2 * F + 1) * 4 + tab_bytes
        ops += rows * (slots * _SHAP_OPS_PER_SLOT + T)
        _log(f"[kernels] shap_tab group {gi}: T={T} L={L} D={D} "
             f"real slots={slots} max|kernel-plain|={d:.3e} "
             f"kernel {gk:.4f} ms plain {gp:.4f} ms; kernel at the "
             f"{chunk}-row chunk {gc:.4f} ms")
        max_err = max(max_err, d)
        k_ms += gk
        c_ms += gc
        p_ms += gp
    bytes_s = bytes_moved / _HBM_BYTES_PER_S * 1e3
    ops_s = ops / _FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_s, ops_s)
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    _log(f"[kernels] shap_tab all {len(groups)} groups at {rows} rows: "
         f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms max err {max_err:.3e}"
         f"; bound {bound_ms:.4f} ms by {bound_by} ({bytes_moved} bytes, "
         f"{ops} ops); at the {chunk}-row chunk {c_ms:.4f} ms; "
         f"{kern.launches} comparison launches [{card}]")
    if max_err != 0.0:
        raise RuntimeError(f"kernel differs from its plain version by "
                           f"{max_err} (expected bitwise equality)")

    # -- 5. main path through REST -------------------------------------------
    kern.launches = 0
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
    _log(f"[serve] shap_tab launches: {main_launches} on the main path, "
         f"{launches_contrib} during the contributions requests")
    if worst_add > 1e-4 or worst_p > 1e-6 or worst_c > 1e-6:
        raise RuntimeError("served results are wrong")
    if launches_contrib <= 0 or main_launches <= 0:
        raise RuntimeError("the contributions requests did not launch the "
                           "shap_tab kernel")

    # -- 6. full width, direct -----------------------------------------------
    score_s = _host_s(lambda: model.score_numpy(X), _REPEATS)
    before = kern.launches
    contrib_s = _host_s(lambda: model.contrib_numpy(X), _REPEATS)
    per_call = (kern.launches - before) // (_REPEATS + 1)
    _log(f"[direct] score_numpy {rows} rows: {score_s * 1e3:.3f} ms "
         f"= {rows / score_s:.0f} rows/s [{card}]")
    _log(f"[direct] contrib_numpy {rows} rows: {contrib_s * 1e3:.3f} ms "
         f"= {rows / contrib_s:.0f} rows/s, {per_call} shap_tab launches "
         f"per call, chunk {model._contrib_chunk()} [{card}]")
    if args.profile:
        _profile(torch, "score_numpy", lambda: model.score_numpy(X))
        _profile(torch, "contrib_numpy", lambda: model.contrib_numpy(X))
    rest.BATCHER.stop(timeout=5.0)

    # -- 7. report -----------------------------------------------------------
    record = {
        "name": "shap_tab", "route": "cuda",
        "source": "h2o_kubernetes_tpu_torch/csrc/shap_tab.cu",
        "replaces": "h2o_kubernetes_tpu/ops/shap_kernel.py:120 "
                    "(_shap_tab_kernel)",
        "launches": main_launches, "max_abs_err": max_err,
        "max_abs_diff_vs_plain": max_err,
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "rows": rows, "ms_at_chunk": c_ms, "chunk_rows": chunk,
    }
    _log(json.dumps({"kernels": [record]}))
    _log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
