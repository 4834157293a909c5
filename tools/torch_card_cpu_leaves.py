#!/usr/bin/env python3
"""Where a GBM trained on the card and the same GBM trained on the CPU
part: stage by stage, for one family at chip_smoke.py's parity shape.

    python3 tools/torch_card_cpu_leaves.py [--dist poisson] [--rows 65536]

It trains ``GBM(ntrees=10, max_depth=5, learn_rate=0.2, seed=1,
distribution=...)`` on chip_smoke.py's phase-15 table (bench.py's
columns with the derived responses) on the CUDA card and on the CPU,
then prints: whether the bin edges are equal; per tree the largest leaf
gap (absolute, and relative to the tree's largest |leaf|); and for the
first tree, from the same init on both devices, the gap of each stage
that turns a margin into a leaf: the gradients (in float32 ulps), the
root histogram (card kernel and CPU plain version against a float64
sum), the bin cumsum (the card's scan against the CPU's, on the same
histogram), and the leaf values of a tree grown on each device from
identical gradients. It exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _ulps(a, b) -> float:
    """Largest distance in float32 ulps between two float32 tensors."""
    import torch

    ia = a.cpu().contiguous().view(dtype=torch.int32).long()
    ib = b.cpu().contiguous().view(dtype=torch.int32).long()
    return float((ia - ib).abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dist", default="poisson")
    ap.add_argument("--rows", type=int, default=65_536)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from h2o_kubernetes_tpu_torch import GBM, Frame
    from h2o_kubernetes_tpu_torch.models.base import resolve_xy
    from h2o_kubernetes_tpu_torch.models.gbm import _init_margin
    from h2o_kubernetes_tpu_torch.models.tree import core
    from h2o_kubernetes_tpu_torch.ops import histogram as H

    print(cs._card_line(), flush=True)
    cols = cs._bench_cols(args.rows, 0)
    cols.update(cs._dist_responses(cols, 0))
    y = "yheavy" if args.dist in ("laplace", "quantile", "huber") \
        else "ypos"
    ign = [c for c in ("y", "ypos", "yheavy") if c != y]
    frames = {"card": Frame.from_arrays(cols),
              "cpu": Frame.from_arrays(cols, device="cpu")}
    models = {k: GBM(ntrees=10, max_depth=5, learn_rate=0.2, seed=1,
                     distribution=args.dist).train(
        y=y, training_frame=fr, ignored_columns=ign)
        for k, fr in frames.items()}
    ec, ep = (models[k].bin_spec.edges.cpu() for k in ("card", "cpu"))
    print(f"[leaves] {args.dist} at {args.rows} rows: bin edges equal "
          f"{torch.equal(ec, ep)}")
    vc, vp = (models[k].trees.value.cpu().double()
              for k in ("card", "cpu"))
    leaf = ~models["cpu"].trees.is_split.cpu()
    for t in range(vc.shape[0]):
        d = (vc[t] - vp[t]).abs()[leaf[t]]
        scale = vp[t].abs().max()
        print(f"[leaves] tree {t}: largest leaf gap {float(d.max()):.3e}, "
              f"{float(d.max() / scale):.3e} of the tree's largest |leaf| "
              f"({float(scale):.4f})")
    # the first tree's stages, from the same init on both devices
    data = {k: resolve_xy(fr, y, None, ign, None, args.dist)
            for k, fr in frames.items()}
    init_c, _ = _init_margin(data["card"].y, data["card"].w,
                             torch.zeros_like(data["card"].y), args.dist, 1)
    init_p, _ = _init_margin(data["cpu"].y, data["cpu"].w,
                             torch.zeros_like(data["cpu"].y), args.dist, 1)
    print(f"[leaves] init card {float(init_c)!r} cpu {float(init_p)!r}")
    bp = core.BoostParams(distribution=args.dist)
    m = torch.full_like(data["cpu"].y, float(init_p))
    g_p, h_p = core._boost_grad_hess(bp, m, data["cpu"].y, data["cpu"].w)
    g_c, h_c = core._boost_grad_hess(bp, m.cuda(), data["card"].y,
                                     data["card"].w)
    print(f"[leaves] tree-0 gradients from one init: g within "
          f"{_ulps(g_c, g_p):.0f} ulps, h within {_ulps(h_c, h_p):.0f}")
    spec = models["cpu"].bin_spec
    b_p = frames["cpu"].binned(spec)
    b_c = b_p.cuda()
    rel = torch.zeros(args.rows, dtype=torch.int32)
    vals = torch.stack([g_p * data["cpu"].w, h_p * data["cpu"].w,
                        data["cpu"].w], 1).contiguous()
    hist64 = H.histogram_plain(b_p, rel, vals.double(), 1, spec.n_bins)
    hist_p = H.histogram_plain(b_p, rel, vals, 1, spec.n_bins)
    hist_c = H.build_histogram_kernel(b_c, rel.cuda(), vals.cuda(), 1,
                                      spec.n_bins).cpu()
    for name, hh in (("card kernel", hist_c), ("cpu plain", hist_p)):
        err = (hh.double() - hist64).abs().max()
        print(f"[leaves] root histogram, {name}: largest cell gap from the "
              f"float64 sum {float(err):.3e}")
    cum_p = torch.cumsum(hist_p[..., :-1, :], dim=2)
    cum_c = torch.cumsum(hist_p.cuda()[..., :-1, :], dim=2).cpu()
    print(f"[leaves] bin cumsum of one histogram, card scan vs CPU: "
          f"{float((cum_c - cum_p).abs().max()):.3e} (largest |cumsum| "
          f"{float(cum_p.abs().max()):.3e})")
    tp = core.TreeParams(max_depth=5, n_bins=spec.n_bins,
                         unit_hess=args.dist in ("gaussian", "laplace",
                                                 "quantile", "huber"))
    w = data["cpu"].w
    t_p = core.grow_tree(b_p, g_p, h_p, w, tp)
    t_c = core.grow_tree(b_c, g_p.cuda(), h_p.cuda(), w.cuda(), tp)
    same = all(torch.equal(getattr(t_c, f).cpu(), getattr(t_p, f))
               for f in ("split_feat", "split_bin", "na_left", "is_split"))
    lf = ~t_p.is_split
    d = (t_c.value.cpu().double() - t_p.value.double()).abs()[lf]
    print(f"[leaves] tree 0 grown from identical gradients: structure "
          f"equal {same}, largest leaf gap {float(d.max()):.3e} "
          f"({float(d.max() / t_p.value.abs().max()):.3e} of its largest "
          f"|leaf|)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
