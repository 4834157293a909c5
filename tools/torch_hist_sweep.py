#!/usr/bin/env python3
"""Histogram-kernel timing of the PyTorch port at the level shapes of its
four trains, for comparing launch plans, or two checkouts, on one card.

    PYTHONPATH=<checkout> python3 tools/torch_hist_sweep.py [--plans]
        [--train gbm|gbm10|drf|multinomial] [--repeats N]

It imports ``h2o_kubernetes_tpu_torch`` from PYTHONPATH (so the same
script times any checkout). For each level it times
``build_histogram_batched`` ([median, min, max] of ``--repeats``
CUDA-event times, each from a flushed L2), gives the byte bound as
``chip_smoke.py`` counts it, checks the result bitwise against the
plain version on dyadic values, and prints one JSON line. The levels
come from one of two sources:

- by default, seeded inputs of the four trains' level shapes on the
  card — uniform bin codes (an 8-level column among the GBM's, as
  bench.py's enum gives), each tree's rows live with the level's share
  and spread uniformly over its nodes, dyadic values: bench.py's GBM
  (1,000,000 rows, F=10, B=256, C=3; depth 5 and the depth-10 levels of
  64-256 nodes), its AUC (F=1, 4096 int16 bins), drf_higgs (K=10, F=28,
  B=64, C=2, levels 0-7) and gbm_multinomial (500,000 rows, K=4, F=10,
  B=256, C=3, levels 0-4);
- with ``--train``, the inputs one real train hands the kernel, one per
  level (the first call at each depth): the table and model of
  ``tools/torch_gbm_timing.py --model`` (``gbm10``: bench.py's table at
  max_depth=10, 2 trees), trained once on the card.

``--plans`` also times other launch plans of the same level (the other
regime family, replicas, partition tiles, row blocks), through
``ops.histogram``'s private ``_card_plan`` and ``_launch``; it needs a
checkout that has them. It exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import subprocess
import sys

import numpy as np

_HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
_L2_FLUSH_BYTES = 128 << 20


def _levels():
    """(name, K, rows, F, n_nodes, B, C, live share, code dtype)."""
    out = [("gbm root", 1, 1_000_000, 10, 1, 256, 3, 1.0, "u8"),
           ("gbm root C=2", 1, 1_000_000, 10, 1, 256, 2, 1.0, "u8"),
           ("gbm depth-4", 1, 1_000_000, 10, 8, 256, 3, 0.7, "u8"),
           ("auc", 1, 1_000_000, 1, 1, 4096, 3, 1.0, "i16")]
    out += [(f"gbm {n} nodes", 1, 1_000_000, 10, n, 256, 3, 0.5, "u8")
            for n in (64, 128, 256)]
    out += [(f"drf level {d}", 10, 1_000_000, 28, max(1, 2 ** (d - 1)), 64,
             2, 0.632 if d == 0 else 0.35, "u8") for d in range(8)]
    out += [(f"multinomial level {d}", 4, 500_000, 10, max(1, 2 ** (d - 1)),
             256, 3, 1.0 if d == 0 else 0.5, "u8") for d in range(5)]
    return out


def _inputs(torch, K, rows, F, n, B, C, live, dt, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B - 1, size=(F, rows))
    if F == 10:
        codes[8] = rng.integers(0, 8, size=rows)       # bench.py's enum
    rel = rng.integers(0, n, size=(K, rows))
    rel[rng.random((K, rows)) >= live] = -1
    vals = (rng.integers(-2, 3, size=(K, rows, C)) * 0.5).astype(np.float32)
    vals[rel < 0] = 0.0
    dev = "cuda"
    return (torch.as_tensor(codes.astype(np.uint8 if dt == "u8" else
                                         np.int16), device=dev),
            torch.as_tensor(rel.astype(np.int32), device=dev),
            torch.as_tensor(vals, device=dev))


def _ms(torch, fn, flush, repeats=10):
    """[median, min, max] of ``repeats`` CUDA-event times (ms) of ``fn``,
    each from a flushed L2."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return [statistics.median(times), min(times), max(times)]


def _variants(H, b, r, v, n, B, plan):
    """Other plans of the same level: the other regime family, streaming
    with 1-8 replicas, partitioned tiles sized for 1-3 CTAs per SM,
    half, twice and four times the row blocks."""
    seen, out = {plan}, []

    def add(p):
        if p not in seen and p.smem_bytes <= H.BLOCK_SMEM:
            seen.add(p)
            out.append(p)
    plans = {}
    for part in (False, True):
        try:
            plans[part] = H._card_plan(b, r, v, n, B, partition=part)
            add(plans[part])
        except ValueError:                  # no partitioned plan
            pass
    if False in plans:
        p = plans[False]
        slab = p.smem_bytes // p.replicas
        for R in (1, 2, 4, 8):
            add(dataclasses.replace(p, replicas=R, smem_bytes=R * slab,
                                    regime="replicated" if R > 1
                                    else "grouped"))
    if True in plans:
        p = plans[True]
        kn, cell = p.K * p.n_nodes, 4 * p.C * p.n_bins
        for ctas in (1, 2, 3):
            budget = min(H.BLOCK_SMEM, H._SM_SMEM // ctas
                         - H._BLOCK_RESERVED)
            tile = max(1, min(kn, (budget - 4) // (p.group * cell + 4)))
            add(dataclasses.replace(
                p, node_range=tile, ranges=-(-kn // tile),
                smem_bytes=tile * p.group * cell + 4 * (tile + 1)))
    for rb in (plan.row_blocks // 2, plan.row_blocks * 2,
               plan.row_blocks * 4):
        if rb >= 1:
            add(dataclasses.replace(plan, row_blocks=rb))
    return out


def _train_levels(torch, H, model):
    """(name, binned, rel, vals, n_nodes, n_bins) of the first call at
    each depth of one warm train of ``model`` on the card. After the
    root only left children are histogrammed, so depth d >= 1 has
    max(1, 2**(d-1)) nodes and a one-node call right after a root is
    depth 1; the AUC's 4096-bin call is its own level."""
    import h2o_kubernetes_tpu_torch as port
    from torch_gbm_timing import workload

    frame, make = workload(port, "gbm" if model == "gbm10" else model)
    if model == "gbm10":
        make = functools.partial(make, max_depth=10, ntrees=2)
    kernel, seen, last = H.build_histogram_batched, {}, {}

    def record(binned, rel, vals, n_nodes, n_bins):
        kind = (rel.shape[0], n_bins, vals.shape[2], binned.dtype)
        if n_nodes > 1:
            depth = n_nodes.bit_length()
        else:
            depth = 1 if last.get(kind) == 0 else 0
        last[kind] = depth
        seen.setdefault(kind + (depth,), (binned, rel, vals, n_nodes,
                                          n_bins))
        return kernel(binned, rel, vals, n_nodes, n_bins)

    make().train(y="y", training_frame=frame)     # bins the frame
    H.build_histogram_batched = record
    try:
        make().train(y="y", training_frame=frame)
    finally:
        H.build_histogram_batched = kernel
    torch.cuda.synchronize()
    return [(f"{model} " + ("auc" if key[1] == 4096 else
                            f"level {key[4]}"),) + inp
            for key, inp in sorted(seen.items(), key=lambda kv: (
                kv[0][1], kv[0][4]))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plans", action="store_true",
                    help="also time other launch plans of each level")
    ap.add_argument("--train", choices=("gbm", "gbm10", "drf",
                                        "multinomial"),
                    help="time at the level inputs of one real train")
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_hist_sweep: no CUDA device", file=sys.stderr)
        return 2
    from h2o_kubernetes_tpu_torch.ops import histogram as H

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    if args.train:
        levels = _train_levels(torch, H, args.train)
    else:
        levels = [(name, *_inputs(torch, K, rows, F, n, B, C, live, dt,
                                  seed=i), n, B)
                  for i, (name, K, rows, F, n, B, C, live, dt)
                  in enumerate(_levels())]
    ok = True
    for name, b, r, v, n, B in levels:
        (F, rows), (K, _, C) = b.shape, v.shape
        g = torch.Generator(device="cuda").manual_seed(K * n * B + C)
        dy = torch.randint(-2, 3, v.shape, generator=g, device="cuda"
                           ).float() * 0.5
        dy = torch.where(r[..., None] >= 0, dy, 0.0)
        want = H.histogram_batched_plain(b, r, dy, n, B)
        same = torch.equal(H.build_histogram_batched(b, r, dy, n, B), want)
        ok &= same
        nbytes = (F * rows * b.element_size() + 4 * K * rows
                  + 4 * K * C * rows + 4 * K * n * F * B * C)
        rec = {"level": name, "K": K, "n_nodes": n, "F": F, "n_bins": B,
               "C": C, "rows": rows, "live": int((r >= 0).sum()),
               "ms": _ms(torch, lambda: H.build_histogram_batched(
                   b, r, v, n, B), flush, args.repeats),
               "bound_ms": nbytes / _HBM_BYTES_PER_S * 1e3,
               "bitwise": same, "card": card}
        if hasattr(H, "_card_plan"):
            plan = H._card_plan(b, r, v, n, B)
            rec["plan"] = dataclasses.asdict(plan)
            try:                            # the row partition alone
                pp = H._card_plan(b, r, v, n, B, partition=True)
                rec["partition_ms"] = _ms(torch, lambda: H.row_partition(
                    b, r, v, n, pp.stride, pp), flush, args.repeats)
                if args.plans:              # other pair tiles per warp
                    for tile in (512, 1024, 2048, 4096):
                        tp = dataclasses.replace(
                            pp, part_tile=tile,
                            part_tiles=-(-K * rows // tile))
                        rec[f"partition_ms_tile{tile}"] = _ms(
                            torch, lambda: H.row_partition(
                                b, r, v, n, tp.stride, tp), flush,
                            args.repeats)
            except ValueError:
                pass
        print(json.dumps(rec), flush=True)
        if not args.plans:
            continue
        for p in _variants(H, b, r, v, n, B, plan):
            out = torch.zeros_like(want)

            def run(p=p, out=out, vals=v):
                out.zero_()
                H._launch(b, r, vals, out, p)
            try:
                run(vals=dy)
                same = torch.equal(out, want)
                t = _ms(torch, run, flush, args.repeats)
                err = None
            except RuntimeError as e:        # a plan the card refuses
                t, same, err = None, False, str(e)[:200]
            ok &= same or err is not None
            print(json.dumps({"level": name, "variant": {
                k: getattr(p, k) for k in ("regime", "group",
                                           "groups", "node_range", "ranges",
                                           "replicas", "row_blocks",
                                           "smem_bytes")},
                "ms": t, "bitwise": same, "error": err}), flush=True)
    return 0 if ok else 1

if __name__ == "__main__":
    sys.exit(main())
