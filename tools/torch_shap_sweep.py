#!/usr/bin/env python3
"""TreeSHAP-kernel (B4) timing of the PyTorch port at the depth groups of
its three served models, for comparing launch plans, or two checkouts,
on one card.

    PYTHONPATH=<checkout> python3 tools/torch_shap_sweep.py
        [--model serving|gbm|drf ...] [--plans] [--repeats N]

It imports ``h2o_kubernetes_tpu_torch`` from PYTHONPATH (so the same
script times any checkout, the parent of the kernel's redesign
included) and builds on the CUDA card, at 100,000 rows each:

- ``serving``: ``chip_smoke.py``'s serving model, a seeded binomial GBM
  of 28 features and 20 trees grown out to depth 5
  (``random_tree_artifact(0, ..., p_leaf=0.0)``), and its HIGGS-shaped
  rows (``random_rows(1000, ...)``, ~1% NaN);
- ``gbm``: the GBM ``tools/torch_gbm_timing.py --model gbm`` trains
  (bench.py's table), scored on its first 100,000 training rows;
- ``drf``: the forest of ``--model drf`` (drf_higgs), likewise.

For each depth group it checks the wrapper bitwise against the plain
version and times it ([median, min, max] of ``--repeats`` CUDA-event
times, each from a flushed L2), with the bound as ``chip_smoke.py``
counts it; then it times ``contrib_numpy`` on the 100,000 rows (host
clock, median of ``--repeats``) and counts the kernel launches per
call. One JSON line per group and one per model. ``--plans`` also times
every launch plan that fits each group, the wrapper's own among them
(through the private ``_launch``; a checkout that has ``shap_plan``). It exits non-zero
without a CUDA card, or when a launch differs from the plain version.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time

_HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
_FP32_OPS_PER_S = 67e12
_SHAP_OPS_PER_SLOT = 6          # as chip_smoke.py counts them
_L2_FLUSH_BYTES = 128 << 20
_ROWS = 100_000


def _ms(torch, fn, flush, repeats):
    """[median, min, max] of ``repeats`` CUDA-event times (ms) of
    ``fn``, each from a flushed L2, after ten untimed calls (the card's
    clocks are low after the plain version's small launches). A spin of
    ~0.5 ms before the start event hides the wrapper's host work, so the
    time is the kernel's alone."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return [statistics.median(times), min(times), max(times)]


def _model(port, name):
    """(model on the card, [rows, F] float32 rows) of one ``--model``."""
    if name == "serving":
        from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
            random_rows, random_tree_artifact)
        blob = random_tree_artifact(0, n_features=28, ntrees=20,
                                    max_depth=5, p_leaf=0.0)
        return (port.load_artifact(blob),
                random_rows(1000, _ROWS, 28, nan_frac=0.01))
    from torch_gbm_timing import workload
    frame, make = workload(port, name)
    model = make().train(y="y", training_frame=frame)
    return model, model._design_matrix(frame)[:_ROWS].cpu().numpy()


def _plans(S, F, T, L, D, rows):
    """Every (rows per block, stage buffers) that fits one block, and the
    device-memory variant."""
    LD = L * D
    buf = -(-(4 * LD + (LD << D)) // 4) * 4
    out = []
    for R in (256, 128, 64, 32):
        for stages in (2, 1, 0):
            smem = 4 * (stages * buf + R * S._row_floats(F))
            if smem <= S.BLOCK_SMEM:
                out.append(S.ShapPlan(
                    "staged" if stages else "unstaged", R, stages,
                    buf if stages else 0, smem, -(-rows // R),
                    S._blocks_per_sm(smem, R)))
    out.append(S.ShapPlan("global_phi", 128, 0, 0, 0, -(-rows // 128), 16))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", nargs="+", default=["serving", "gbm", "drf"],
                    choices=("serving", "gbm", "drf"))
    ap.add_argument("--plans", action="store_true",
                    help="also time every plan that fits a group")
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_shap_sweep: no CUDA device", file=sys.stderr)
        return 2
    import h2o_kubernetes_tpu_torch as port
    from h2o_kubernetes_tpu_torch.ops import shap_kernel as S

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kern = S.flat_shap_tab_kernel
    takes_slots = "slots" in inspect.signature(kern).parameters
    ok = True
    for name in args.model:
        model, X = _model(port, name)
        groups, ctabs = model._contrib_prepare()
        slots = model.__dict__.get("_shap_slots") or [None] * len(groups)
        em = model._contrib_enum_mask()
        Xd = torch.as_tensor(X, device=model.device)
        flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8,
                            device=model.device)
        rows, F = Xd.shape
        for g, ct, sl in zip(groups, ctabs, slots):    # clocks up
            kw = {"slots": sl} if takes_slots else {}
            for _ in range(20):
                kern(g, ct, Xd, em, **kw)
        torch.cuda.synchronize()
        tot = {"ms": 0.0, "bound_ms": 0.0}
        for gi, (g, ct, sl) in enumerate(zip(groups, ctabs, slots)):
            if ct is None:
                raise RuntimeError(f"{name} group {gi} has no pattern table")
            kw = {"slots": sl} if takes_slots else {}
            T, L, D = g.feat.shape
            want = S.flat_shap_tab_plain(g, ct, Xd, em)
            same = torch.equal(kern(g, ct, Xd, em, **kw), want)
            ok &= same
            real = int((g.feat >= 0).sum())
            tab_bytes = sum(t.numel() * t.element_size() for t in
                            (g.feat, g.lo, g.hi, g.na_ok, g.bias, ct))
            bytes_ms = (rows * (2 * F + 1) * 4 + tab_bytes) \
                / _HBM_BYTES_PER_S * 1e3
            ops_ms = rows * (real * _SHAP_OPS_PER_SLOT + T) \
                / _FP32_OPS_PER_S * 1e3
            rec = {"model": name, "group": gi, "T": T, "L": L, "D": D,
                   "F": F, "rows": rows, "real_slots": real,
                   "ms": _ms(torch, lambda: kern(g, ct, Xd, em, **kw),
                             flush, args.repeats),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations", "bitwise": same, "card": card}
            if hasattr(S, "shap_plan"):
                rec["plan"] = vars(S.shap_plan(F, T, L, D, rows))
            tot["ms"] += rec["ms"][0]
            tot["bound_ms"] += rec["bound_ms"]
            print(json.dumps(rec), flush=True)
            if not (args.plans and hasattr(S, "shap_plan")):
                continue
            for p in _plans(S, F, T, L, D, rows):
                def run(p=p):
                    return S._launch(g, ct, Xd, em, sl, p)
                same = torch.equal(run(), want)
                ok &= same
                print(json.dumps({
                    "model": name, "group": gi, "variant": vars(p),
                    "ms": _ms(torch, run, flush, args.repeats),
                    "bitwise": same}), flush=True)
        before = kern.launches
        model.contrib_numpy(X)                  # warm
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            model.contrib_numpy(X)
            times.append(time.perf_counter() - t0)
        per_call = (kern.launches - before) // (args.repeats + 1)
        med = statistics.median(times)
        print(json.dumps({
            "model": name, "groups": len(groups), "rows": rows,
            "kernel_ms_sum": tot["ms"], "bound_ms_sum": tot["bound_ms"],
            "contrib_numpy_ms": [med * 1e3, min(times) * 1e3,
                                 max(times) * 1e3],
            "contrib_rows_per_s": rows / med,
            "launches_per_call": per_call, "package": port.__file__,
            "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
