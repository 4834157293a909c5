"""PyTorch port, package boundary: the port and chip_smoke.py import
neither jax nor the JAX package, and the entry points refuse to fall
back to the CPU when no CUDA card is present."""

import io
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import h2o_kubernetes_tpu_torch as port
from h2o_kubernetes_tpu_torch.mojo import read_mojo_parts
from h2o_kubernetes_tpu_torch.models.tree.synthetic import \
    random_tree_artifact

ROOT = Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|h2o_kubernetes_tpu)\b",
                        re.M)


def test_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['h2o_kubernetes_tpu'] = None\n"
        "import h2o_kubernetes_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in {k for k, v in sys.modules.items() if v}\n"
        "print(' '.join(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 20
    # the training slices' modules are among them
    assert {f"h2o_kubernetes_tpu_torch.{m}" for m in (
        "frame.frame", "models.tree.binning", "ops.histogram", "ops._build",
        "metrics", "models.gbm", "models.drf", "runtime.prng", "mojo",
        "persist", "operator.registry", "runtime.retry", "models.xgboost",
        "models.glm", "models.datainfo", "models.tree.efb",
        "models.tree.ooc", "models.deeplearning",
        "models.word2vec", "frame.parse", "frame.munge",
        "runtime.quantile", "runtime.xla_math", "diagnostics",
        "runtime.faults",
        "runtime.scheduler", "models.cv", "models.stackedensemble",
        "automl", "grid", "estimators", "models.targetencoder",
        "models.naivebayes", "models.pca", "models.kmeans", "models.glrm",
        "models.coxph", "models.isolationforest", "models.aggregator",
        "runtime.telemetry", "runtime.health", "runtime.lifecycle",
        "runtime.mesh", "runtime.mrtask", "rest")} <= names


def test_no_source_imports_jax_or_reference():
    files = sorted((ROOT / "h2o_kubernetes_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert not bad


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = random_tree_artifact(3, n_features=4, ntrees=2, max_depth=2)
    meta, arrays, _ = read_mojo_parts(io.BytesIO(blob))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.FlatTreeScorer(meta, arrays)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.load_artifact(blob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.start_server(port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.FlatTreeScorer(meta, arrays, device="cuda")
    assert port.FlatTreeScorer(meta, arrays, device="cpu").device.type \
        == "cpu"


def test_training_entry_points_raise_without_cuda(monkeypatch):
    """Frame.from_arrays (and so GBM.train, DRF.train, XGBoost.train,
    GLM.train, DeepLearning.train and Word2Vec.train, which train where
    the frame lives) and the carried-across models default to the
    card."""
    from h2o_kubernetes_tpu_torch.models.deeplearning import (
        carry_net, deeplearning_model_from_arrays)
    from h2o_kubernetes_tpu_torch.models.gbm import gbm_model_from_arrays
    from h2o_kubernetes_tpu_torch.models.glm import glm_model_from_arrays
    from h2o_kubernetes_tpu_torch.models.xgboost import \
        xgboost_model_from_arrays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols = {"x": [1.0, 2.0, 3.0], "y": ["a", "b", "a"]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Frame.from_arrays(cols)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gbm_model_from_arrays({}, [[0.0, 1.0]], [False], 0.0, ["x"],
                              "bernoulli", 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xgboost_model_from_arrays({}, [[0.0, 1.0]], [False], 0.0, ["x"],
                                  "bernoulli", 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        glm_model_from_arrays([0.5, 0.0], ["x", "Intercept"], [0], [],
                              [0.0], [1.0], True, ["x"], "binomial")
    net = [{"w": [[0.5]], "b": [0.0]}]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        carry_net(net)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deeplearning_model_from_arrays(net, ["x", "Intercept"], [0], [],
                                       [0.0], [1.0], ["x"], "mse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Word2Vec(min_word_freq=1).train(port.Frame.from_arrays(
            {"w": ["a", "b", None, "a"]}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.DeepLearning(hidden=(2,), epochs=1).train(
            y="y", training_frame=port.Frame.from_arrays(cols))
    fr = port.Frame.from_arrays(cols, device="cpu")
    assert fr.device.type == "cpu" and fr["y"].is_enum()
    model = port.DeepLearning(hidden=(2,), epochs=1).train(
        y="y", training_frame=fr)
    assert model.device.type == "cpu" and model.algo == "deeplearning"
    w2v = port.Word2Vec(min_word_freq=1, vec_size=4).train(
        port.Frame.from_arrays({"w": ["a", "b", None, "a"]}, device="cpu"))
    assert w2v.W.shape == (2, 4) and w2v.algo == "word2vec"
    model = port.DRF(ntrees=1, max_depth=1, min_rows=1.0).train(
        y="y", training_frame=fr)
    assert model.device.type == "cpu" and model.algo == "drf"
    model = port.XGBoost(ntrees=1, max_depth=1).train(y="y",
                                                      training_frame=fr)
    assert model.device.type == "cpu" and model.algo == "xgboost"
    model = port.GLM(family="binomial").train(y="y", training_frame=fr)
    assert model.device.type == "cpu" and model.algo == "glm"


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_checkout", "alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """Without a CUDA card (and, alone, without the package beside it)
    chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        cwd = tmp_path
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_load_model_defaults_to_the_card(monkeypatch, tmp_path):
    """load_model places a saved model on the card unless told the CPU,
    and raises without one."""
    cols = {"x": [1.0, 2.0, 3.0, 4.0], "y": ["a", "b", "a", "b"]}
    fr = port.Frame.from_arrays(cols, device="cpu")
    model = port.GBM(ntrees=1, max_depth=1, min_rows=1.0).train(
        y="y", training_frame=fr)
    path = port.save_model(model, str(tmp_path / "m"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.load_model(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.load_model(path, device="cuda")
    assert port.load_model(path, device="cpu").device.type == "cpu"


def test_mojo_model_is_numpy_only(tmp_path):
    """mojo.py loads on its own, with torch and jax unimportable, and
    MojoModel scores an artifact there."""
    blob = random_tree_artifact(5, n_features=4, ntrees=3, max_depth=3)
    (tmp_path / "a.mojo").write_bytes(blob)
    code = (
        "import sys, importlib.util, numpy as np\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        f"spec = importlib.util.spec_from_file_location('mojo', "
        f"{str(ROOT / 'h2o_kubernetes_tpu_torch' / 'mojo.py')!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        f"mm = m.MojoModel({str(tmp_path / 'a.mojo')!r})\n"
        "p = mm.predict(np.zeros((5, 4), np.float32))\n"
        "assert p.shape == (5, 2) and np.isfinite(p).all()\n"
        "assert not any(k.startswith(('torch', 'jax')) and v is not None\n"
        "               for k, v in sys.modules.items())\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
