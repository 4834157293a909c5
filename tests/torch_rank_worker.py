"""One rank of the port's row-group tests, a process of its own.

    python tests/torch_rank_worker.py PORT RANK WORLD SUITE OUTDIR

joins a gloo group of WORLD CPU ranks at ``localhost:PORT`` through the
port's ``init(coordinator=...)``, runs SUITE's workloads on its row
shard of seeded numpy inputs (the same on every rank) and pickles what
they return to ``OUTDIR/rankRANK.pkl``. The suites and the seeded
input generators live here so that the tests make the same inputs for
their references. Imports torch and the port, never jax.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np

GBM_ROWS = 3001            # odd: the last shard carries a padding row


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world: int, suite: str, outdir: str) -> list:
    """Start the WORLD rank processes of one group (not waited for)."""
    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.dirname(here) + os.pathsep + \
        env.get("PYTHONPATH", "")
    os.makedirs(outdir, exist_ok=True)
    return [subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_rank_worker.py"),
         str(port), str(r), str(world), suite, outdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for r in range(world)]


def collect(procs, outdir: str, timeout: float = 240.0) -> list:
    """Wait for a group's ranks; (return codes, outputs, per-rank
    results or None)."""
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    res = []
    for r in range(len(procs)):
        path = os.path.join(outdir, f"rank{r}.pkl")
        res.append(pickle.load(open(path, "rb"))
                   if os.path.exists(path) else None)
    return [p.returncode for p in procs], outs, res


# -- inputs -------------------------------------------------------------------

def mr_data(seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=1001).astype(np.float32)
    x[::17] = np.nan
    return {"x": x,
            "i": rng.integers(-50, 50, size=1001).astype(np.int32),
            "u": rng.integers(0, 255, size=1001).astype(np.uint8)}


def rollup_cols(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    a = (1997.0 + 6.3 * rng.normal(size=777)).astype(np.float32)
    a[::11] = np.nan
    b = rng.normal(size=777).astype(np.float32)
    b[::5] = 0.0
    return {"a": a, "b": b,
            "c": np.array(list("pqr"), dtype=object)[
                rng.integers(0, 3, 777)]}


def gbm_cols(rows: int = GBM_ROWS, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(5)}
    X["x2"][::13] = np.nan
    X["c"] = np.array(list("abcd"))[rng.integers(0, 4, rows)]
    logit = X["x0"] - X["x1"] + 0.5 * X["x4"] + rng.normal(size=rows)
    X["yb"] = np.where(logit > 0, "p", "n")
    X["yr"] = (logit + 0.1 * X["x3"]).astype(np.float32)
    X["y3"] = np.array(list("ABC"))[np.digitize(logit, [-0.7, 0.7])]
    return X


def dyadic_cols(rows: int = 2048, seed: int = 1) -> dict:
    """Values and response on a 1/8 grid: the first GBM tree's and every
    forest tree's histogram sums, and the mean, are exact in float32
    (later boosting rounds' gradients are not dyadic)."""
    rng = np.random.default_rng(seed)
    X = {f"x{i}": (rng.integers(-40, 40, rows) / 8).astype(np.float32)
         for i in range(4)}
    X["y"] = ((rng.integers(-16, 16, rows)) / 8 + (X["x0"] > 0)
              ).astype(np.float32)
    return X


def glm_cols(rows: int = 2001, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(3)}
    X["x2"] = (1997.0 + 6.3 * X["x2"]).astype(np.float32)   # Year-like
    X["x1"][::13] = np.nan
    X["c"] = np.array(list("abc"), dtype=object)[rng.integers(0, 3, rows)]
    lin = 0.5 * X["x0"] - 0.3 * np.nan_to_num(X["x1"]) + \
        0.2 * (X["c"] == "b")
    X["yb"] = np.where(lin + rng.logistic(size=rows) > 0, "y", "n")
    return X


def dl_cols(rows: int = 2000, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(3)}
    X["c"] = np.array(list("abc"), dtype=object)[rng.integers(0, 3, rows)]
    r2 = X["x0"] ** 2 + X["x1"] ** 2
    X["y"] = np.array(["out", "in"])[(r2 < 1.2).astype(int)]
    return X


def huber_inputs(rows: int = 1001, seed: int = 5) -> tuple:
    rng = np.random.default_rng(seed)
    y = rng.standard_cauchy(rows).astype(np.float32)
    m = (0.3 * rng.normal(size=rows)).astype(np.float32)
    w = (rng.random(rows) < 0.9).astype(np.float32)
    return m, y, w


CSV_TEXT = "x,c,t\n1.5,a,2024-01-02\n,b,2024-01-03\n-2,a,\n7,,2024-02-01\n" \
    "0.25,b,2024-03-04\n"

# every configuration both the workers and the references train
GBM_CASES = {
    "bernoulli_sampled": ("yb", dict(ntrees=3, max_depth=3, learn_rate=0.3,
                                     sample_rate=0.7, seed=5)),
    "gaussian": ("yr", dict(ntrees=3, max_depth=3, learn_rate=0.3, seed=5)),
    "multinomial": ("y3", dict(ntrees=2, max_depth=3, learn_rate=0.3,
                               seed=5)),
}
GBM_RESP = ("yb", "yr", "y3")
DRF_KW = dict(ntrees=3, max_depth=3, seed=3)
DYADIC_KW = dict(ntrees=1, max_depth=3, learn_rate=0.5, seed=1)
DYADIC_DRF_KW = dict(ntrees=3, max_depth=3, sample_rate=1.0, seed=1)
DL_KW = dict(hidden=(8, 8), epochs=1, seed=1)


def tree_arrays(trees) -> dict:
    return {f: getattr(trees, f).cpu().numpy() for f in trees._fields}


# -- suites -------------------------------------------------------------------

def suite_mrtask(rank: int, world: int) -> dict:
    import torch

    from h2o_kubernetes_tpu_torch import Frame
    from h2o_kubernetes_tpu_torch.runtime import mrtask

    d = mr_data()
    x = mrtask.shard_rows(d["x"])
    out = {"shards": {k: mrtask.shard_rows(v).numpy()
                      for k, v in d.items()}}
    out["sum"] = float(mrtask.doall(
        lambda c: torch.nansum(c.double()), x))
    out["min"] = float(mrtask.doall(
        lambda c: torch.where(torch.isnan(c), float("inf"), c).min(), x,
        reduce="min"))
    out["max"] = float(mrtask.doall(
        lambda c: torch.where(torch.isnan(c), float("-inf"), c).max(), x,
        reduce="max"))
    out["mean"] = float(mrtask.doall(
        lambda c: torch.tensor(float(rank + 1)), x, reduce="mean"))
    out["concat"] = mrtask.doall(lambda c: c, x, reduce="concat").numpy()
    # ragged leaves: rank r contributes r + 1 rows
    out["ragged"] = mrtask.doall(
        lambda c: torch.full((rank + 1,), float(rank)), x,
        reduce="concat").numpy()
    out["none"] = mrtask.doall(lambda c: c * 2, x, reduce="none").numpy()
    out["tree"] = mrtask.doall(
        lambda c: {"n": (~torch.isnan(c)).sum(),
                   "lo": torch.tensor([rank, -rank], dtype=torch.int64),
                   "pair": (torch.tensor(1.0), c[:2].clone())},
        x, reduce={"n": "sum", "lo": "max",
                   "pair": ("sum", "concat")})
    fr = Frame.from_arrays(rollup_cols(), device="cpu")
    out["rollups"] = {n: fr.vec(n).rollups() for n in fr.names}
    import tempfile

    from h2o_kubernetes_tpu_torch import import_file

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "small.csv")
        with open(path, "w") as f:
            f.write(CSV_TEXT)
        cf = import_file(path, device="cpu")
    out["csv"] = {"sharded": cf.sharded, "nrows": cf.nrows,
                  "local_rows": cf.local_rows,
                  "cols": {n: (cf.vec(n).kind, cf.vec(n).domain,
                               cf.vec(n).to_numpy()) for n in cf.names}}
    out["nrows"], out["local_rows"] = fr.nrows, fr.local_rows
    out["to_numpy"] = fr.vec("a").to_numpy()
    return out


def drop_check(rank: int) -> dict:
    """Rank 1 leaves the group; rank 0's heartbeat must fail and its
    next train raise ClusterHealthError."""
    import torch.distributed as dist

    from h2o_kubernetes_tpu_torch import GBM, Frame
    from h2o_kubernetes_tpu_torch.runtime import health

    fr = Frame.from_arrays(gbm_cols(64), device="cpu")
    before = health.heartbeat(timeout=30.0)
    dist.barrier()
    if rank == 1:
        return {"before": before}
    time.sleep(1.0)
    after = health.heartbeat(timeout=10.0)
    try:
        GBM(ntrees=1, max_depth=2).train(y="yb", training_frame=fr,
                                         ignored_columns=["yr", "y3"])
        raised = ""
    except health.ClusterHealthError as e:
        raised = str(e)
    return {"before": before, "after": after, "raised": raised,
            "error": health.health_status()["error"]}


def suite_train(rank: int, world: int) -> dict:
    import torch

    from h2o_kubernetes_tpu_torch import DRF, GBM, GLM, DeepLearning, Frame
    from h2o_kubernetes_tpu_torch.models import deeplearning as DLM
    from h2o_kubernetes_tpu_torch.models.tree import core as tcore
    from h2o_kubernetes_tpu_torch.runtime import prng

    out = {}
    fr = Frame.from_arrays(gbm_cols(), device="cpu")
    for name, (y, kw) in GBM_CASES.items():
        m = GBM(**kw).train(y=y, training_frame=fr, ignored_columns=[
            r for r in GBM_RESP if r != y])
        out[name] = {"trees": tree_arrays(m.trees),
                     "init": np.asarray(m.init_score),
                     "edges": m.bin_spec.edges_matrix().numpy(),
                     "history": m.scoring_history,
                     "perf": m.model_performance(fr, y)}
        if name == "bernoulli_sampled":
            out[name]["confusion"] = m.confusion_matrix(fr, y)
    m = DRF(**DRF_KW).train(y="yb", training_frame=fr,
                            ignored_columns=["yr", "y3"])
    out["drf"] = {"trees": tree_arrays(m.trees), "mtries": m.params.mtries,
                  "history": m.scoring_history}
    # huber's δ and gradient on this rank's shard
    from h2o_kubernetes_tpu_torch.runtime import mrtask

    mg, yh, wh = (mrtask.shard_rows(a, 0.0) for a in huber_inputs())
    bp = tcore.BoostParams(distribution="huber", huber_alpha=0.9)
    out["huber"] = {
        "delta": float(tcore.huber_delta(yh - mg, wh, 0.9)),
        "g": tcore._boost_grad_hess(bp, mg, yh, wh)[0].numpy()}
    gf = Frame.from_arrays(glm_cols(), device="cpu")
    gm = GLM(family="binomial").train(y="yb", training_frame=gf)
    out["glm"] = {"coef": gm.coef(), "iters": gm.n_iterations}
    df = Frame.from_arrays(dl_cols(), device="cpu")
    dm = DeepLearning(**DL_KW).train(y="y", training_frame=df)
    sizes = (dm.net.layers[0].in_features,) + tuple(DL_KW["hidden"]) + (2,)
    init = DLM._init_net(prng.split(prng.key(DL_KW["seed"]))[1], sizes,
                         "rectifier")
    out["dl"] = {"net": dm.net_numpy(),
                 "init": [{"w": lyr.weight.detach().T.numpy(),
                           "b": lyr.bias.detach().numpy()}
                          for lyr in init.layers],
                 "history": dm.scoring_history}
    yf = Frame.from_arrays(dyadic_cols(), device="cpu")
    for name, est, kw in (("dyadic_gbm", GBM, DYADIC_KW),
                          ("dyadic_drf", DRF, DYADIC_DRF_KW)):
        ym = est(**kw).train(y="y", training_frame=yf)
        out[name] = {"trees": tree_arrays(ym.trees),
                     "init": np.asarray(ym.init_score),
                     "history": ym.scoring_history,
                     "pred": ym.predict_raw(yf),
                     "pred_frame": ym.predict(yf).vec("predict")
                     .to_numpy()}
    out["torch_threads"] = torch.get_num_threads()
    return out


SUITES = {"mrtask": suite_mrtask, "train": suite_train}


def main() -> None:
    port, rank, world = (int(a) for a in sys.argv[1:4])
    suite, outdir = sys.argv[4], sys.argv[5]
    import torch

    torch.set_num_threads(1)
    import h2o_kubernetes_tpu_torch as port_pkg

    port_pkg.init("cpu", coordinator=f"localhost:{port}",
                  num_processes=world, process_id=rank, backend="gloo")
    res = SUITES[suite](rank, world)
    res["status"] = port_pkg.cluster_status()
    if suite == "mrtask" and world == 2:
        res["drop"] = drop_check(rank)
    path = os.path.join(outdir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(path + ".tmp", path)
    sys.stdout.flush()
    # a rank of a dropped group may hold a collective thread that never
    # returns: leave without joining it
    os._exit(17 if (suite == "mrtask" and world == 2 and rank == 1) else 0)


if __name__ == "__main__":
    main()
