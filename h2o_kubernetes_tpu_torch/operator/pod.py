"""Scorer-pool replica entry: ``python -m h2o_kubernetes_tpu_torch.operator.pod``.

The pod the reconciler provisions: the port's ``rest.py`` serving stack
(micro-batcher, admission queue, breaker, SIGTERM drain) on ``--device``
(default ``cuda``: the card; a pod without one exits at start unless it
is given ``--device cpu``), plus the replica-specific piece:

- the **model-registry readiness gate**: ``/readyz`` stays 503 until
  the declared artifacts have been pushed over
  ``POST /3/ModelRegistry/load`` AND warmed (``Model.warm_up``: the
  tables, and on the card the scoring graphs, of every pow2 batch
  bucket), so a Service never routes traffic to a replica that would
  build them on its first request.

Eager torch compiles nothing, so the JAX pod's persistent compile cache
has no counterpart here. ``/healthz`` is live from server start (the
reconciler uses it as the "process is up, push the artifact now"
signal); SIGTERM runs the drain (flush in-flight scoring, settle jobs,
exit 0) inside ``H2O_TPU_DRAIN_TIMEOUT``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--pool", default=None,
                    help="owning pool name (identity on /3/Stats)")
    ap.add_argument("--rid", default=None,
                    help="replica id assigned by the reconciler")
    ap.add_argument("--manifest", default=None,
                    help="pid/port manifest path — rewritten with "
                    "this process's authoritative pid so a restarted "
                    "operator can adopt the pod (it also marks this "
                    "pod ADOPTABLE to a preflight reaper)")
    ap.add_argument("--device", default="cuda",
                    help="the device the replica serves on (default "
                    "cuda, the card; cpu for the CPU)")
    args = ap.parse_args(argv)

    # replica identity before the package import reads the env
    os.environ.setdefault("H2O_TPU_POOL_REPLICA", "1")
    from .. import rest
    from ..runtime import lifecycle

    rest.install_pool_replica_gate()
    # identity fields on /3/Stats: the adoption probe of a restarted
    # operator verifies pool/rid/pid before trusting a manifest —
    # a recycled port cannot masquerade as this replica
    rest.IDENTITY.update({
        "pool": args.pool, "replica": args.rid,
        "pid": os.getpid(), "port": args.port,
        "started_at": time.time()})
    if args.manifest:
        # rewrite the controller-dropped manifest with the pid this
        # process actually has (authoritative), atomically
        import json

        doc = {"rid": args.rid, "pool": args.pool,
               "pid": os.getpid(), "port": args.port,
               "created_at": time.time()}
        try:
            with open(args.manifest) as f:
                old = json.load(f)
            for k in ("version", "model_key"):
                if k in old:
                    doc[k] = old[k]
        except (OSError, ValueError):
            pass
        os.makedirs(os.path.dirname(args.manifest), exist_ok=True)
        tmp = args.manifest + f".pod{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, args.manifest)
    rest.start_server(args.port, host=args.host, device=args.device,
                      background=True, install_signals=True)
    print(f"POD_UP port={args.port} pid={os.getpid()}", flush=True)
    # sleep is signal-interruptible; the SIGTERM drain thread
    # os._exit(0)s when the drain completes, so this loop only ends
    # via terminated() on an in-process drain
    while not lifecycle.terminated():
        time.sleep(0.2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
