"""Rehearse chip_smoke.py's phases 18-30 (xgboost, lambdarank, glm,
efb, goss, ooc, deeplearning, word2vec, frame, automl, learners,
serving_remainder) on the CPU, without a card, at small sizes: the entry
points' default device resolves to
the CPU, the histogram and TreeSHAP kernels are replaced by counting
fakes over their plain versions (the histogram fake sums in float64 and
counts ``LAUNCHES``/``BATCHED_LAUNCHES`` under the regime ``hist_plan``
picks), and CUDA events, ``synchronize`` and ``_sleep`` are host
stand-ins. It finds wrong paths, shapes and launch counts; its times
are the CPU's and say nothing of the card.

    PYTHONPATH=. python3 tools/torch_rehearse_phases.py \
        [--rows 70000] [--rank-rows 20000] [--phases xgboost,lambdarank,glm]
        [--ws-rows 200000 --ws-groups 2 --efb-hist-budget 20000000]
        [--goss-rows 200000] [--ooc-rows 300000]
        [--dl-rows 70000] [--w2v-tokens 50000] [--text8-tokens 300000]
        [--frame-rows 100000]
        [--aml-wall-rows 20000 --aml-rows 30000 --aml-parity-rows 1500]
        [--learner-rows 200000 --learner-parity-rows 20000]
        [--sr-train-rows 20000 --sr-aml-rows 20000]
        [--storm-clients process|threads]

With ``--card`` it installs no fakes and runs the phases on the card at
the given sizes (kernels built on first use): a short check of new
phases before a whole chip_smoke.py run.

``--rows`` and ``--dl-rows`` must exceed 65,536 (phases 18 and 20
compare card and CPU on that many rows; the AUC takes its histogram
path past it, which phases 18 and 24 hold). The
xgboost phase takes ~1 min at the defaults on one CPU, lambdarank ~30 s,
glm ~10 s. ``--phases deeplearning,word2vec`` at the defaults takes
~2 min (the text8-sized corpus cut to ``--text8-tokens``; the profiled
launch counts are the card's alone, zero here). ``--phases frame``
(the airlines CSV -> munging -> split -> GBM at ``--frame-rows``, which
must exceed 81,920 so the 0.2 holdout's AUC takes B1's path) takes ~2
min at 100,000 rows, most of it the pure-Python CSV writer and the
export round trip. ``--phases automl`` runs phase 27's three parts at
the ``--aml-*`` rows (below 196,608 config #5's holdouts are too small
for the AUC's histogram path, and its hold is left out); its CPU leg
(the whole default plan on the CPU, in a process of its own) starts
first and takes ~4-8 min at any row count (the depth-12 forests).
``--phases learners`` trains the eight other learners at
``--learner-rows`` (first and warm trains, artifacts) and card against
CPU at ``--learner-parity-rows`` (both the CPU here).
``--phases serving_remainder`` (phase 29) trains its four base models
at ``--sr-train-rows``, imports the airlines CSV of ``--frame-rows``
(written first unless ``frame`` ran before it) over REST and runs
AutoML on its first ``--sr-aml-rows``; ~2 min at the defaults, its
sweep, explain and storm legs at their full lengths;
``--storm-clients threads`` runs the storm's clients in the server's
process (its tail then misses its deadline on a busy interpreter: the
spans line says where the time went).
``--phases fleet`` (phase 30) trains three base models at
``--sr-train-rows`` (phase 29's when it ran first) and drives the whole
fleet — a fake s3:// store, 3 shards and 3 direct pods as processes
(``--device cpu`` here, the card with ``--card``), the router process,
the five legs — at full size: 120 tenants, 10 s legs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


class _HostEvent:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _install_fakes():
    """CPU stand-ins for the card: device resolution, CUDA timing, and
    counting fakes of the two kernels."""
    torch.cuda.Event = _HostEvent
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda._sleep = lambda *a: None
    import h2o_kubernetes_tpu_torch as port
    from h2o_kubernetes_tpu_torch import rest
    from h2o_kubernetes_tpu_torch.frame import frame, parse
    from h2o_kubernetes_tpu_torch.operator import registry
    from h2o_kubernetes_tpu_torch.ops import histogram as H
    from h2o_kubernetes_tpu_torch.ops import shap_kernel as S
    from h2o_kubernetes_tpu_torch.runtime import backend

    for mod in (frame, parse, registry, rest, backend, port):
        mod.resolve_device = lambda device=None: torch.device("cpu")

    def hist(binned, rel, vals, n_nodes, n_bins):
        out = H.histogram_batched_plain(binned, rel, vals, n_nodes, n_bins)
        regime = H.hist_mode(rel.shape[0], n_nodes, binned.shape[0], n_bins,
                             vals.shape[2], binned.element_size(),
                             binned.shape[1])
        H.LAUNCHES[regime] += 1
        if regime == "partitioned":
            H.PARTITION_LAUNCHES["row_partition"] += 1
        if rel.shape[0] > 1:
            H.BATCHED_LAUNCHES[regime] += 1
        return out

    H.build_histogram_batched = hist
    H.build_histogram_kernel = lambda b, r, v, n, B: \
        H.build_histogram_batched(b, r[None], v[None], n, B)[0]

    def shap(tables, ctab, X, em, slots=None):
        shap.launches += 1
        return S.flat_shap_tab_plain(tables, ctab, X, em)

    shap.launches = 0
    S.flat_shap_tab_kernel = shap
    return H, S, rest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=70_000)
    ap.add_argument("--rank-rows", type=int, default=20_000)
    ap.add_argument("--phases", default="xgboost,lambdarank,glm")
    ap.add_argument("--ws-rows", type=int, default=70_000)
    ap.add_argument("--ws-groups", type=int, default=4)
    ap.add_argument("--goss-rows", type=int, default=200_000)
    ap.add_argument("--ooc-rows", type=int, default=300_000)
    ap.add_argument("--dl-rows", type=int, default=70_000)
    ap.add_argument("--w2v-tokens", type=int, default=50_000)
    ap.add_argument("--text8-tokens", type=int, default=300_000)
    ap.add_argument("--frame-rows", type=int, default=100_000)
    ap.add_argument("--aml-wall-rows", type=int, default=20_000)
    ap.add_argument("--aml-rows", type=int, default=30_000)
    ap.add_argument("--aml-parity-rows", type=int, default=1_500)
    ap.add_argument("--learner-rows", type=int, default=200_000)
    ap.add_argument("--learner-parity-rows", type=int, default=20_000)
    ap.add_argument("--sr-train-rows", type=int, default=20_000)
    ap.add_argument("--sr-aml-rows", type=int, default=20_000)
    ap.add_argument("--efb-hist-budget", type=int, default=None,
                    help="H2O_TPU_HIST_BYTES_BUDGET for the efb phase, so "
                         "that a small unbundled frame goes out of core "
                         "under the defaults as the full one does")
    ap.add_argument("--storm-clients", choices=("process", "threads"),
                    default="process",
                    help="where phase 29's storm clients run: a process "
                         "of their own, or threads beside the server")
    ap.add_argument("--card", action="store_true",
                    help="run on the card, with the real kernels")
    args = ap.parse_args()
    if args.card:
        from h2o_kubernetes_tpu_torch import rest
        from h2o_kubernetes_tpu_torch.ops import histogram as H
        from h2o_kubernetes_tpu_torch.ops import shap_kernel as S
    else:
        H, S, rest = _install_fakes()
    import chip_smoke as cs
    from h2o_kubernetes_tpu_torch import Frame, start_server

    cs._WARM_TRAINS, cs._REPEATS = 2, 2
    cs._RANK_ROWS = args.rank_rows
    if args.ooc_rows < cs._OOC_ROWS:       # keep ten chunks
        cs._OOC_SMALL_CHUNK = -(-args.ooc_rows // 10)
    cs._WS_ROWS, cs._WS_GROUPS = args.ws_rows, args.ws_groups
    cs._GOSS_ROWS, cs._OOC_ROWS = args.goss_rows, args.ooc_rows
    cs._DL_ROWS, cs._W2V_TOKENS = args.dl_rows, args.w2v_tokens
    cs._TEXT8_TOKENS = args.text8_tokens
    cs._FRAME_ROWS = args.frame_rows
    cs._AML_WALL_ROWS, cs._AML_ROWS = args.aml_wall_rows, args.aml_rows
    cs._AML_PARITY_ROWS = args.aml_parity_rows
    cs._LEARNER_ROWS = args.learner_rows
    cs._LEARNER_PARITY_ROWS = args.learner_parity_rows
    cs._LEARNER_MOJO_ROWS = min(cs._LEARNER_MOJO_ROWS, args.learner_rows)
    cs._SR_TRAIN_ROWS = args.sr_train_rows
    cs._SR_STORM_CLIENTS = args.storm_clients
    cs._SR_AML_ROWS = min(args.sr_aml_rows, args.frame_rows)
    if not args.card:
        cs._upload_gbs = lambda torch, nbytes: {"pinned": 0.0,
                                                "pageable": 0.0}
    hcols, hdom = cs._higgs_cols(args.rows, 0)
    ctx = types.SimpleNamespace(
        torch=torch, hist_op=H, shap_kernel=S, rest=rest,
        start_server=start_server,
        card=cs._card_line() if args.card else "CPU rehearsal",
        profile=False,
        hframe=Frame.from_arrays(hcols, domains=hdom), hcols=hcols,
        hdom=hdom, mframe=Frame.from_arrays(cs._multinomial_cols(
            args.rows // 2, 0)),
        book=cs._LevelBook(torch, H, "rehearsal", 2),
        profile_counts=cs._profile_counts if args.card else
        (lambda torch, fn: (fn(), (0, 0.0, 1.0))[1]))
    ctx.seed = 0
    ctx.fleet_device = None if args.card else "cpu"
    ctx.frame_work = str(Path(__file__).resolve().parent.parent / "build"
                         / "frame")
    Path(ctx.frame_work).mkdir(parents=True, exist_ok=True)
    phases = args.phases.split(",")
    if "serving_remainder" in phases and "frame" not in phases:
        from tools.datasets import airlines_csv

        airlines_csv(str(Path(ctx.frame_work) / "airlines.csv"),
                     args.frame_rows, seed=0)
    if "automl" in args.phases.split(","):
        # phase 27c's CPU leg, started first as chip_smoke.py starts it
        ctx.aml_cpu_leg = cs._start_automl_cpu_leg()
    for phase in args.phases.split(","):
        t0 = time.perf_counter()
        budget = args.efb_hist_budget if phase == "efb" else None
        with cs._env(**({} if budget is None else
                        {"H2O_TPU_HIST_BYTES_BUDGET": budget})):
            res = getattr(cs, f"_phase_{phase}")(ctx)
        print(f"[rehearsal] {phase} passed in "
              f"{time.perf_counter() - t0:.1f}s: {json.dumps(res)[:400]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
