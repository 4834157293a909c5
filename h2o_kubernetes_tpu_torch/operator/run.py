"""Operator process entry: ``python -m h2o_kubernetes_tpu_torch.operator.run``.

The control plane as its own process (what a Deployment would run):
one durable-store-backed Reconciler per pool, reconciling until
SIGTERM. Because the store is durable and replicas drop pid/port
manifests under the workdir, this process is RESTARTABLE: SIGKILL it
mid-rollout, start a fresh one against the same ``--store``/
``--workdir``, and it adopts the live pods, then finishes (or rolls
back) the rollout — the data plane never notices. The
``operator-restart`` chaos drill rehearses exactly that.

Usage::

    python -m h2o_kubernetes_tpu_torch.operator.run \
        --store /var/h2o/poolstore --registry /var/h2o/registry \
        --pool churn-pool --workdir /var/h2o/pools/churn-pool

SIGTERM = graceful: stop reconciling, drain every replica (the
pod drain path), exit 0. SIGKILL = crash: pods keep serving (own
sessions), manifests stay, the next operator adopts them.
``--leave-pods`` makes SIGTERM leave the data plane running too
(operator handoff: retire THIS controller, keep the fleet).

``--ha`` runs the lease-fenced high-availability mode: N replicas of
this process share one ``--store``/``--workdir``; exactly one (the
``<pool>.lease.json`` holder) reconciles and publishes the routing
table, the others poll the lease as hot standbys. The holder
heartbeats every ``H2O_TPU_LEASE_HEARTBEAT``; standbys take over
within ``H2O_TPU_LEASE_TTL`` of holder death (SIGKILL the holder and
watch), adopt the surviving pods, and RESUME whatever the dead holder
was mid-way through — a rollout continues, it does not restart. A
deposed holder (paused, partitioned, renewal missed) stops
reconciling the moment its fenced writes start bouncing and returns
to standby; its pods are never killed, just inherited.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def _lease_ttl() -> float:
    from ..runtime.retry import _env_float

    return max(0.5, _env_float("H2O_TPU_LEASE_TTL", 5.0))


def _lease_heartbeat(ttl: float) -> float:
    from ..runtime.retry import _env_float

    hb = _env_float("H2O_TPU_LEASE_HEARTBEAT", 0.0)
    return hb if hb > 0.0 else max(0.1, ttl / 3.0)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--store", required=True,
                    help="DurablePoolStore root (dir or mem://)")
    ap.add_argument("--registry", required=True,
                    help="ModelRegistry root")
    ap.add_argument("--pool", required=True)
    ap.add_argument("--workdir", required=True,
                    help="pool workdir: pod manifests + logs")
    ap.add_argument("--interval", type=float, default=None,
                    help="reconcile interval override (else "
                    "H2O_TPU_POOL_RECONCILE_INTERVAL)")
    ap.add_argument("--leave-pods", action="store_true",
                    help="on SIGTERM, exit WITHOUT draining replicas "
                    "(handoff to a successor operator)")
    ap.add_argument("--ha", action="store_true",
                    help="lease-fenced HA mode: run as one of N "
                    "operator replicas; only the lease holder "
                    "reconciles (ShardedPool control plane)")
    ap.add_argument("--holder-id", default=None,
                    help="lease holder identity (--ha; default "
                    "host-pid)")
    ap.add_argument("--device", default="cuda",
                    help="the device the pods serve on (default cuda, "
                    "the card; cpu for the CPU)")
    ap.add_argument("--status-port", type=int, default=None,
                    help="bind a tiny /metrics + /healthz listener on "
                    "this port (0 = ephemeral; default: "
                    "H2O_TPU_METRICS_PORT, unset/empty = no listener) "
                    "— the operator's Prometheus scrape surface")
    args = ap.parse_args(argv)

    from .reconcile import Reconciler
    from .registry import ModelRegistry
    from .store import DurablePoolStore

    store = DurablePoolStore(args.store)
    rec = Reconciler(store, ModelRegistry(args.registry), args.pool,
                     workdir=args.workdir, device=args.device)
    stop = threading.Event()

    # status listener: the operator's own /metrics scrape surface
    # (reconcile event counters, build info) — the control plane is a
    # fleet member too, scraped like any replica
    status_port = args.status_port
    if status_port is None:
        raw = os.environ.get("H2O_TPU_METRICS_PORT")
        if raw:
            try:
                status_port = int(raw)
            except ValueError:
                print(f"OPERATOR_BAD_METRICS_PORT {raw!r} (ignored)",
                      flush=True)
    status_srv = None
    if status_port is not None:
        from ..runtime.telemetry import start_status_listener

        def _operator_groups():
            try:
                return {"operator": {
                    "pool": args.pool,
                    "status": store.get_status(args.pool) or {}}}
            except Exception:  # noqa: BLE001 — scrape must survive
                return None

        status_srv = start_status_listener(
            status_port, extra_groups=_operator_groups)
        print(f"OPERATOR_METRICS port="
              f"{status_srv.server_address[1]}", flush=True)

    def _sigterm(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _sigterm)

    # the store file is the API wire: starting the operator BEFORE a
    # client applies the pool spec is a supported ordering — wait for
    # the spec instead of crashing on a missing pool
    while not stop.is_set():
        try:
            store.get(args.pool)
            break
        except KeyError:
            print(f"OPERATOR_WAITING pool={args.pool} (no spec yet)",
                  flush=True)
            stop.wait(1.0)
    if stop.is_set():
        return 0
    if args.ha:
        rc = _run_ha(args, store, stop)
    else:
        adopted = rec.adopt_existing()
        print(f"OPERATOR_UP pool={args.pool} pid={os.getpid()} "
              f"adopted={adopted}", flush=True)
        rec.run(stop, interval=args.interval)
        if not args.leave_pods:
            rec.shutdown()
        rc = 0
    if status_srv is not None:
        status_srv.shutdown()
        status_srv.server_close()
    print("OPERATOR_DOWN", flush=True)
    return rc


def _run_ha(args, store, stop: threading.Event) -> int:
    """The lease loop: standby-poll -> hold (reconcile + heartbeat) ->
    deposed-or-stopped. Deposition leaves every pod running — the new
    holder adopts them off their manifests; only a user SIGTERM while
    HOLDING drains the fleet (unless --leave-pods)."""
    import socket

    from .reconcile import ShardedPool
    from .registry import ModelRegistry

    holder = args.holder_id or f"{socket.gethostname()}-{os.getpid()}"
    registry = ModelRegistry(args.registry)
    ttl = _lease_ttl()
    heartbeat = _lease_heartbeat(ttl)
    print(f"OPERATOR_HA pool={args.pool} holder={holder} "
          f"ttl={ttl:g} heartbeat={heartbeat:g}", flush=True)
    while not stop.is_set():
        epoch = store.acquire_lease(args.pool, holder, ttl)
        if epoch is None:
            stop.wait(heartbeat)        # hot standby: poll the lease
            continue
        print(f"OPERATOR_LEASE_ACQUIRED pool={args.pool} "
              f"holder={holder} epoch={epoch}", flush=True)
        ctl = ShardedPool(store, registry, args.pool,
                          workdir=args.workdir, device=args.device)
        ctl.lease_epoch = epoch
        ctl_stop = threading.Event()
        t = threading.Thread(target=ctl.run, args=(ctl_stop,),
                             kwargs={"interval": args.interval},
                             name="h2o-torch-ha-reconcile", daemon=True)
        t.start()
        deposed = False
        while not stop.is_set():
            stop.wait(heartbeat)
            if stop.is_set():
                break
            if ctl.deposed or not store.renew_lease(
                    args.pool, holder, epoch):
                deposed = True
                break
        ctl_stop.set()
        t.join(timeout=30.0)
        if deposed:
            # back to standby with the pods untouched; the reconcile
            # thread already stopped (fence or renewal failure)
            ctl.deposed = True
            print(f"OPERATOR_DEPOSED pool={args.pool} "
                  f"holder={holder} epoch={epoch}", flush=True)
            continue
        # user-initiated stop while holding: hand the lease back so a
        # standby takes over on its next poll, not after a TTL
        store.release_lease(args.pool, holder)
        if not args.leave_pods:
            ctl.shutdown()
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
