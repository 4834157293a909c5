"""PyTorch port, ``runtime/mesh.py`` and ``runtime/mrtask.py``: MRTask
on a row group of CPU ranks (gloo, processes of their own:
``tests/torch_rank_worker.py``), one group of two and one of three,
spawned once for the module. Held:
- ``doall`` with every reduce kind (sum, min, max, mean, concat with
  ragged leaves, none) and a pytree of kinds, at world sizes 2 and 3,
  the same on every rank;
- ``shard_rows`` on an odd row count, shard for shard against the JAX
  package's ``shard_rows`` on a two-row-shard mesh (its
  ``addressable_shards``): floats padded with NaN, signed integers with
  -1, unsigned with 0;
- a sharded Frame's rollups against numpy's float64 two-pass values
  (``rows``, ``nacnt``, ``zeros``, min and max exact), its global
  ``nrows``, its shard's rows and ``to_numpy`` without the padding;
- ``import_file`` on a group (numeric, enum and time columns with NAs)
  gathers back to one process's import bitwise;
- ``cluster_status()`` on a group;
- a rank that exits: the survivor's heartbeat fails and its next train
  raises ``ClusterHealthError``;
- alone (no group) every reduction is the identity and ``doall`` still
  passes through its health gate and fault point;
- in this process, with no collective: every rank's ``shard_rows`` and
  ``shard_bounds`` at world sizes 2, 4 and 8 (the four-card leg's
  world among them), and every rank's Frame shard (numeric, enum and
  time columns with NAs, and its valid mask), against the JAX
  package's shards on a mesh of that many row shards;
- ``initialize_distributed``'s refusals and its no-op cases, which form
  no process group.
"""

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu import Frame as JFrame
from h2o_kubernetes_tpu.runtime.mesh import make_mesh
from h2o_kubernetes_tpu.runtime.mesh import use_mesh as juse_mesh
from h2o_kubernetes_tpu.runtime.mrtask import shard_rows as jshard_rows
from h2o_kubernetes_tpu_torch import Frame
from h2o_kubernetes_tpu_torch.runtime import faults, health, mrtask
from h2o_kubernetes_tpu_torch.runtime import mesh as tmesh
from torch_f64_rollups import two_pass
from torch_rank_worker import CSV_TEXT, collect, mr_data, rollup_cols, spawn


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{world: per-rank results} for a group of 2 (which then loses its
    rank 1) and a group of 3, run side by side."""
    runs = {}
    for world in (2, 3):
        out = str(tmp_path_factory.mktemp(f"mrtask{world}"))
        runs[world] = (spawn(world, "mrtask", out), out)
    res = {}
    for world, (procs, out) in runs.items():
        rcs, outs, res[world] = collect(procs, out)
        want = [0, 17] if world == 2 else [0] * world
        assert rcs == want, "\n".join(o[-3000:] for o in outs)
    return res


@pytest.mark.parametrize("world", [2, 3])
def test_doall_reduce_kinds(groups, world):
    x = mr_data()["x"]
    n = x.shape[0]
    m = -(-n // world)
    padded = np.concatenate([x, np.full(m * world - n, np.nan,
                                        np.float32)])
    for r, res in enumerate(groups[world]):
        assert abs(res["sum"] - np.nansum(x.astype(np.float64))) <= 1e-9
        assert res["min"] == np.nanmin(x) and res["max"] == np.nanmax(x)
        assert res["mean"] == (world + 1) / 2
        np.testing.assert_array_equal(res["concat"], padded)
        np.testing.assert_array_equal(
            res["ragged"], np.concatenate([np.full(k + 1, float(k))
                                           for k in range(world)]))
        np.testing.assert_array_equal(res["none"],
                                      2 * padded[r * m: (r + 1) * m])
        t = res["tree"]
        assert int(t["n"]) == int((~np.isnan(x)).sum())
        np.testing.assert_array_equal(t["lo"].numpy(), [world - 1, 0])
        assert float(t["pair"][0]) == world
        np.testing.assert_array_equal(
            t["pair"][1].numpy(),
            np.concatenate([padded[k * m: k * m + 2] for k in range(world)]))


def test_shard_rows_matches_the_two_shard_mesh(groups):
    mesh = make_mesh(n_rows=2)
    for name, arr in mr_data().items():
        ref = jshard_rows(arr, mesh=mesh)
        shards = sorted(ref.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert len(shards) == 2
        for r, sh in enumerate(shards):
            got = groups[2][r]["shards"][name]
            want = np.asarray(sh.data)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    last = groups[2][1]["shards"]
    assert np.isnan(last["x"][-1]) and last["i"][-1] == -1 and \
        last["u"][-1] == 0


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_rollups_against_numpy(groups, world):
    cols = rollup_cols()
    for res in groups[world]:
        assert res["nrows"] == 777
        assert res["local_rows"] == -(-777 // world)
        np.testing.assert_array_equal(res["to_numpy"], cols["a"])
        for name in ("a", "b"):
            x = cols[name]
            r = res["rollups"][name]
            n, mean, sigma = two_pass(x)
            assert r["rows"] == n and r["nacnt"] == 777 - n
            assert r["zeros"] == int((x == 0).sum())
            assert r["min"] == np.nanmin(x) and r["max"] == np.nanmax(x)
            assert abs(r["mean"] - mean) <= 1e-12 * abs(mean)
            assert abs(r["sigma"] - sigma) <= 1e-12 * sigma
        assert res["rollups"]["c"]["rows"] == 777
    assert groups[world][0]["rollups"] == groups[world][-1]["rollups"]


@pytest.mark.parametrize("world", [2, 3])
def test_import_file_on_a_group(groups, world, tmp_path):
    """Every rank parses the whole CSV and keeps its shard: the
    gathered columns equal one process's import bitwise."""
    from h2o_kubernetes_tpu_torch import import_file

    path = tmp_path / "small.csv"
    path.write_text(CSV_TEXT)
    want = import_file(str(path), device="cpu")
    for res in groups[world]:
        got = res["csv"]
        assert got["sharded"] and got["nrows"] == want.nrows == 5
        assert got["local_rows"] == -(-5 // world)
        assert list(got["cols"]) == want.names
        for n, (kind, dom, arr) in got["cols"].items():
            v = want.vec(n)
            assert kind == v.kind and dom == v.domain
            np.testing.assert_array_equal(arr, v.to_numpy())


def test_cluster_status_on_a_group(groups):
    st = groups[3][2]["status"]
    assert st["cloud_size"] == st["process_count"] == 3
    assert st["mesh_shape"] == {"rows": 3} and st["cloud_healthy"]
    assert st["devices"] == [f"rank {r}: cpu" for r in range(3)]


def test_a_lost_rank_fails_the_heartbeat_and_the_next_train(groups):
    d0, d1 = groups[2][0]["drop"], groups[2][1]["drop"]
    assert d0["before"] and d1["before"]
    assert d0["after"] is False
    assert "row group" in d0["raised"] or "unhealthy" in d0["raised"]
    assert d0["error"].startswith("heartbeat probe")


def test_alone_reductions_are_the_identity():
    assert tmesh.n_row_shards() == 1 and tmesh.rank() == 0
    x = torch.arange(5.0)
    for kind in ("sum", "min", "max", "mean", "concat", "none"):
        assert mrtask.allreduce(x, kind) is x
    assert mrtask.doall(lambda c: {"s": c.sum(), "c": c[:2]}, x,
                        reduce={"s": "sum", "c": "concat"})["s"] == 10.0
    got = mrtask.shard_rows(np.arange(7, dtype=np.int32))
    np.testing.assert_array_equal(got.numpy(), np.arange(7))
    assert mrtask.shard_bounds(7) == (0, 7, 7)
    assert tmesh.initialize_distributed() is tmesh.global_mesh()
    with pytest.raises(ValueError, match="reduce kind"):
        mrtask.allreduce(x, "median")


def test_doall_keeps_its_health_gate_and_fault_point():
    health.reset()
    try:
        with faults.inject("mrtask.doall:error"):
            with pytest.raises(Exception, match="injected"):
                mrtask.doall(lambda c: c.sum(), torch.ones(3))
        health.mark_unhealthy("test")
        with pytest.raises(health.ClusterHealthError):
            mrtask.doall(lambda c: c.sum(), torch.ones(3))
    finally:
        health.reset()


def test_single_process_paths_refuse_a_group():
    from h2o_kubernetes_tpu_torch import Frame, KMeans

    fr = Frame.from_arrays({"x": np.arange(6.0)}, device="cpu")
    with tmesh.use_mesh(tmesh.RowGroup(rank=0, world_size=2)):
        with pytest.raises(NotImplementedError, match="KMeans"):
            KMeans(k=2).train(training_frame=fr)
        sh = Frame.from_arrays({"x": np.arange(6.0)}, device="cpu")
        assert sh.sharded and sh.local_rows == 3 and sh.nrows == 6
        with pytest.raises(NotImplementedError, match="sort"):
            sh.sort("x")
        with pytest.raises(NotImplementedError, match="select_rows"):
            sh.vec("x").select_rows([0])
        np.testing.assert_array_equal(sh.valid_mask().numpy(), [1, 1, 1])
        assert (sh.vec("x") * 2).sharded


def _row_shards(arr) -> list:
    """A JAX array's row shards in row order, as numpy arrays."""
    shards = sorted(arr.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return [np.asarray(s.data) for s in shards]


def _layout_input(n: int, dtype: str) -> np.ndarray:
    rng = np.random.default_rng(n)
    if dtype == "int32":
        return rng.integers(-50, 50, size=n).astype(np.int32)
    if dtype == "uint8":
        return rng.integers(0, 255, size=n).astype(np.uint8)
    x = rng.normal(size=(n, 3) if dtype == "float32x3" else n)
    x = x.astype(np.float32)
    x[::3] = np.nan
    return x


@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8", "float32x3"])
@pytest.mark.parametrize("n", [1, 7, 8, 1001])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_shard_rows_matches_the_mesh_on_every_rank(world, n, dtype):
    """Rank r's ``shard_rows`` is the JAX mesh's r-th row shard, padding
    and dtype included, and ``shard_bounds`` names its padded rows."""
    x = _layout_input(n, dtype)
    want = _row_shards(jshard_rows(x, mesh=make_mesh(n_rows=world)))
    assert len(want) == world
    for r in range(world):
        g = tmesh.RowGroup(rank=r, world_size=world)
        got = mrtask.shard_rows(x, group=g).numpy()
        assert got.dtype == want[r].dtype and got.shape == want[r].shape
        np.testing.assert_array_equal(got, want[r])
        lo, hi, m = mrtask.shard_bounds(n, g)
        assert (lo, hi, m) == (r * m, (r + 1) * m, want[r].shape[0])


def _frame_cols(n: int) -> dict:
    rng = np.random.default_rng(11)
    x = rng.normal(size=n)
    x[::4] = np.nan
    c = np.array(["b", "a", None, "c"], dtype=object)[np.arange(n) % 4]
    t = np.datetime64("2024-01-02T03:04:05", "ms") + \
        rng.integers(0, 10 ** 9, size=n).astype("timedelta64[ms]")
    t[1::5] = np.datetime64("NaT")
    return {"x": x, "k": rng.integers(-3, 3, size=n), "c": c, "t": t}


@pytest.mark.parametrize("n", [5, 1001])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_frame_shards_match_the_mesh_on_every_rank(world, n):
    """A Frame built on rank r of a group keeps the JAX Frame's r-th
    row shard of every column (codes, NA sentinels, time offsets and
    origin, domain) and the r-th shard of its valid mask."""
    cols = _frame_cols(n)
    with juse_mesh(make_mesh(n_rows=world)):
        jf = JFrame.from_arrays(cols)
        jmask = _row_shards(jf.valid_mask())
        jcols = {k: (jf.vec(k), _row_shards(jf.vec(k).data))
                 for k in cols}
    for r in range(world):
        with tmesh.use_mesh(tmesh.RowGroup(rank=r, world_size=world)):
            fr = Frame.from_arrays(cols, device="cpu")
            mask = fr.valid_mask().numpy()
        assert fr.sharded and fr.nrows == n
        assert fr.local_rows == jmask[r].shape[0]
        np.testing.assert_array_equal(mask, jmask[r])
        for k, (jv, shards) in jcols.items():
            v = fr.vec(k)
            assert (v.kind, v.domain, v.nrows) == (jv.kind, jv.domain,
                                                   jv.nrows)
            assert v.origin == jv.origin
            got = v.data.numpy()
            assert got.dtype == shards[r].dtype
            np.testing.assert_array_equal(got, shards[r])


@pytest.mark.parametrize("case", ["no_coordinator", "one_process",
                                  "unknown_backend", "nccl_on_cpu",
                                  "no_card"])
def test_initialize_distributed_refuses_or_forms_nothing(case, monkeypatch):
    """The argument checks run before any process group is formed, and
    a missing coordinator or a world of one forms nothing."""
    for var in ("H2O_TPU_COORDINATOR", "H2O_TPU_NUM_PROCESSES",
                "H2O_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = tmesh.global_mesh()
    coord = "localhost:1"          # never dialled: every case stops first
    if case == "no_coordinator":
        assert tmesh.initialize_distributed(num_processes=2) is before
    elif case == "one_process":
        monkeypatch.setenv("H2O_TPU_COORDINATOR", coord)
        monkeypatch.setenv("H2O_TPU_NUM_PROCESSES", "1")
        assert tmesh.initialize_distributed(device="cpu") is before
    elif case == "unknown_backend":
        with pytest.raises(ValueError, match="backend must be"):
            tmesh.initialize_distributed(coord, 2, 0, backend="mpi",
                                         device="cpu")
    elif case == "nccl_on_cpu":
        with pytest.raises(ValueError, match="nccl backend needs"):
            tmesh.initialize_distributed(coord, 2, 0, backend="nccl",
                                         device="cpu")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.initialize_distributed(coord, 2, 1)
    assert tmesh.global_mesh() is before and tmesh.n_row_shards() == 1
    assert not torch.distributed.is_initialized()
