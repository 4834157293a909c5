"""PyTorch port, grid search (``grid.py``) against the JAX package's on
the CPU: the Cartesian walk and the seeded RandomDiscrete draws give
the reference's combos in the reference's order (numpy's generator);
``max_models`` counts built models and a failing combo is recorded and
skipped; the grid registers a Job; and one small GBM grid (depth 2 or
3 × learn rate 0.1 or 0.2, one-row-shard mesh; the cross-validated
grid runs in chip_smoke.py phase 27) ranks its four models as the
reference does, with the training metrics that do not rank rows
(logloss, rmse) within 1e-5.
"""

import numpy as np
import pytest

import h2o_kubernetes_tpu as h2o
from h2o_kubernetes_tpu import grid as jgrid
from h2o_kubernetes_tpu import models as J
from h2o_kubernetes_tpu.runtime.mesh import make_mesh, use_mesh
import h2o_kubernetes_tpu_torch as port
from h2o_kubernetes_tpu_torch import grid as tgrid

_MESH1 = make_mesh(n_rows=1)
TOL = 1e-5
_HP = {"max_depth": [3, 2], "learn_rate": [0.1, 0.2]}


def grid_cols(rows=600, seed=0):
    rng = np.random.default_rng(seed)
    X = {f"x{i}": rng.normal(size=rows).astype(np.float32)
         for i in range(3)}
    s = X["x0"] - 0.7 * X["x1"] + 0.4 * rng.normal(size=rows)
    X["y"] = np.where(s > 0.2, "yes", "no")
    return X


def test_walks_match_the_reference():
    hp = {"b": [1, 2, 3], "a": [0.1, 0.2], "c": ["x", "y"]}
    jc = jgrid.GridSearch(J.GBM, hp)
    tc = tgrid.GridSearch(port.GBM, hp)
    assert list(tc._cartesian()) == list(jc._cartesian())
    crit = {"strategy": "RandomDiscrete", "max_models": 5, "seed": 11}
    jr = jgrid.GridSearch(J.GBM, hp, search_criteria=crit)
    tr = tgrid.GridSearch(port.GBM, hp, search_criteria=crit)
    got, want = list(tr._random()), list(jr._random())
    assert got == want and len(got) == 12
    for mod in (jgrid, tgrid):
        with pytest.raises(ValueError, match="unknown strategy"):
            mod.GridSearch(J.GBM, hp, search_criteria={"strategy": "x"})
        with pytest.raises(ValueError, match="unknown search_criteria"):
            mod.GridSearch(J.GBM, hp, search_criteria={"nope": 1})


def test_max_models_counts_built_models_and_failures_are_recorded():
    fr = port.Frame.from_arrays(grid_cols(200), device="cpu")
    g = port.GridSearch(
        port.GBM(ntrees=2, seed=1),
        {"nbins": [2, 3, 16, 32, 64]},     # < 4 bins cannot train
        grid_id="g_fail",
        search_criteria={"strategy": "Cartesian", "max_models": 2}).train(
        y="y", training_frame=fr)
    assert [p["nbins"] for p in g.failed_params] == [2, 3]
    assert all("n_bins" in p["error"] for p in g.failed_params)
    assert len(g.models) == 2
    assert sorted(m.grid_params["nbins"] for m in g.models) == [16, 32]
    assert g.model_ids[0].startswith("g_fail_model_")
    assert {"dest": "g_fail", "description": "grid GBM",
            "status": "DONE", "progress": 1.0, "msg": ""} in port.jobs()
    assert repr(g) == "GridSearch(GBM, 2 models, 2 failed)"


def test_grid_ranking_matches_the_reference():
    cols = grid_cols()
    base = dict(ntrees=3, seed=1)
    with use_mesh(_MESH1):
        jg = jgrid.GridSearch(J.GBM(**base), _HP, grid_id="g").train(
            y="y", training_frame=h2o.Frame.from_arrays(cols))
    tg = port.GridSearch(port.GBM(**base), _HP, grid_id="g").train(
        y="y", training_frame=port.Frame.from_arrays(cols, device="cpu"))
    want, got = jg.get_grid(), tg.get_grid()
    assert [r["model_id"] for r in got] == [r["model_id"] for r in want]
    for a, b in zip(got, want):
        assert (a["max_depth"], a["learn_rate"]) == \
            (b["max_depth"], b["learn_rate"])
        for k in ("logloss", "rmse"):
            assert abs(a[k] - b[k]) <= TOL, (a["model_id"], k)
    by_ll = tg.get_grid(sort_by="logloss")
    assert [r["logloss"] for r in by_ll] == sorted(r["logloss"]
                                                    for r in got)
    assert tg.leader is tg.models[0]
