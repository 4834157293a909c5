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
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15


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
