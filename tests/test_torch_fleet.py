"""PyTorch port, runtime and fleet surface, the slice as a whole: a
``ShardedPool`` of 2 shards × 1 port pod (real subprocesses,
``python -m h2o_kubernetes_tpu_torch.operator.pod --device cpu``) over a
registry of small tenants, and the port's front-door router in
process.

Predictions through the router are bitwise to the JAX package's serving
scorer of the same artifact (and within 1e-6 of its numpy
``MojoModel``, which sums in float64); contributions are within the
serving contract (atol 1e-6, rtol 1e-5) of the JAX package's and
bitwise to the port's in-process ones; a SIGKILLed pod's tenants are
re-placed and served again; and no pod outlives the fleet's
teardown."""

import io
import json
import os
import signal
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import h2o_kubernetes_tpu.mojo as jmojo
import h2o_kubernetes_tpu.operator.registry as jregistry
from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
    random_rows, random_tree_artifact)
from h2o_kubernetes_tpu_torch.operator import (ModelRegistry, PoolStore,
                                               ScorerPoolSpec, ShardedPool,
                                               load_artifact, start_router)

F = 6
TENANTS = [f"t{i}" for i in range(6)]
_POD = "h2o_kubernetes_tpu_torch.operator.pod"


def _children_pods() -> list[int]:
    """Live pod processes whose parent is this test process."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid() and _POD in cmd:
            out.append(int(d))
    return out


class _Fleet:
    def __init__(self):
        self.td = tempfile.mkdtemp(prefix="torch_fleet_")
        self.blobs = {f"b{b}": random_tree_artifact(
            40 + b, n_features=F, ntrees=3 + b, max_depth=3)
            for b in range(2)}
        self.registry = ModelRegistry(os.path.join(self.td, "registry"))
        for name, blob in self.blobs.items():
            self.registry.publish(load_artifact(blob, device="cpu"), name)
        self.art = {k: f"b{i % 2}" for i, k in enumerate(TENANTS)}
        self.store = PoolStore()
        self.store.apply(ScorerPoolSpec(
            name="pool", artifact="b0", version=1, model_key=TENANTS[0],
            replicas=1, shards=2, head_models=1, warm_buckets=(128,),
            extra_artifacts=tuple((self.art[k], 1, k)
                                  for k in TENANTS[1:])))
        self.pool = ShardedPool(self.store, self.registry, "pool",
                                log_dir=os.path.join(self.td, "logs"),
                                device="cpu")
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.pool.run,
                                       args=(self.stop,),
                                       kwargs={"interval": 0.1},
                                       daemon=True)
        self.srv = self.router = None
        self.closed = False
        self.thread.start()
        assert self.pool.wait_converged(timeout=60), \
            self.store.get_status("pool")
        self.srv, self.router = start_router(self.pool.routing_table)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def close(self):
        if self.closed:
            return
        self.closed = True
        try:
            if self.router is not None:
                self.router.stop()
                self.srv.shutdown()
                self.srv.server_close()
        finally:
            self.stop.set()
            self.thread.join(timeout=15)
            self.pool.shutdown(timeout=30)
            for pid in _children_pods():      # a failed shutdown's pods
                try:
                    os.killpg(pid, signal.SIGKILL)
                except OSError:
                    pass
                try:
                    os.waitpid(pid, 0)
                except ChildProcessError:
                    pass
            import shutil

            shutil.rmtree(self.td, ignore_errors=True)


@pytest.fixture(scope="module")
def fleet():
    fx = _Fleet()
    try:
        yield fx
    finally:
        fx.close()


def _post(url, key, rows, route="", timeout=60):
    body = {"rows": [[None if np.isnan(v) else float(v) for v in r]
                     for r in rows],
            "columns": [f"x{i}" for i in range(F)]}
    req = urllib.request.Request(
        f"{url}/3/Predictions/models/{key}{route}",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    except (urllib.error.URLError, ConnectionError):
        return -1, None


def test_routed_predictions_bitwise_to_reference(fleet, mesh8):
    rows = random_rows(141, 40, F)
    for name, blob in fleet.blobs.items():
        ref = np.asarray(jregistry.load_artifact(blob).score_numpy(rows),
                         np.float32)
        mojo = jmojo.MojoModel(io.BytesIO(blob)).predict(rows)
        for key in (k for k, a in fleet.art.items() if a == name):
            code, out = _post(fleet.url, key, rows)
            assert code == 200, out
            p1 = np.float32(out["p1"])
            np.testing.assert_array_equal(p1, ref[:, 1])
            np.testing.assert_allclose(p1, mojo[:, 1], rtol=0, atol=1e-6)
    snap = fleet.router.snapshot()
    assert snap["stats"]["forwarded"] >= len(TENANTS)


def test_routed_contributions_within_contract(fleet, mesh8):
    rows = random_rows(142, 24, F)
    for name, blob in fleet.blobs.items():
        ref = np.asarray(jregistry.load_artifact(blob).contrib_numpy(rows))
        mine = load_artifact(blob, device="cpu").contrib_numpy(rows)
        key = next(k for k, a in fleet.art.items() if a == name)
        code, out = _post(fleet.url, key, rows, "/contributions")
        assert code == 200, out
        got = np.asarray(out["contributions"], np.float32)
        assert got.shape == (24, F + 1)
        np.testing.assert_array_equal(got, mine)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_pod_sigkill_replaced_and_served(fleet):
    """One shard's pod dies (its capacity gone): its tail tenants get
    the typed 503 or are re-placed onto the survivor and served there;
    the shard comes back and the pool reconverges."""
    victim = "pool-s0"
    orphans = sorted(set(fleet.pool.plan.keys_for(victim))
                     - {TENANTS[0]})
    assert orphans, fleet.pool.plan.assignments
    rec = fleet.pool.recs[victim]
    pids = [r.pid() for r in list(rec.replicas) if r.pid()]
    fleet.store.apply_update(victim, replicas=0)
    for pid in pids:
        os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and \
            not all(k in fleet.pool.overrides for k in orphans):
        time.sleep(0.1)
    assert all(k in fleet.pool.overrides for k in orphans), \
        fleet.store.get_status("pool")
    rows = random_rows(143, 8, F)
    for k in orphans + [TENANTS[0]]:
        for _ in range(40):
            code, out = _post(fleet.url, k, rows, timeout=10)
            if code == 200:
                break
            assert code in (-1, 503), out        # typed, retryable
            time.sleep(0.1)
        assert code == 200, (k, out)
    kinds = {e["kind"] for e in fleet.store.events("pool")}
    assert {"shard_down", "tenant_replaced"} <= kinds
    fleet.store.apply_update(victim, replicas=1)
    assert fleet.pool.wait_converged(timeout=30)


def test_no_pod_outlives_the_fleet(fleet):
    assert len(_children_pods()) == 2
    fleet.close()
    assert _children_pods() == []


def test_kernel_build_publishes_the_library_atomically(tmp_path,
                                                       monkeypatch):
    """Several pods share one card and one ``build/kernels/``: while one
    builds, another must never load a half-written library. nvcc writes
    a per-process temporary file, and the library appears under its
    final name only whole (a rename)."""
    from h2o_kubernetes_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    seen = []

    def fake_nvcc(argv, **kw):
        out = argv[argv.index("-o") + 1]
        assert out.endswith(f".{os.getpid()}.tmp")
        with open(out, "wb") as f:
            f.write(b"half")
            seen.append(sorted(p.name for p in tmp_path.iterdir()))
            f.write(b" and the rest")

        class R:
            returncode, stdout, stderr = 0, "", ""
        return R()

    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    lib = _build.KernelLib("shap_tab", {})
    so = lib.load()
    assert seen and all(n.endswith(".tmp") for n in seen[0])
    assert open(so, "rb").read() == b"half and the rest"
    assert [p.name for p in tmp_path.iterdir()] == [os.path.basename(so)]
