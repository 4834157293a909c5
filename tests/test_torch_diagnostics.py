"""PyTorch port, runtime and fleet surface: configuration tiers
(``config.get_config``/``set_config``), the profiler and memory hooks
(``diagnostics.profile``/``device_memory``) and ``init`` /
``cluster_status``, held against the JAX package where it has the same
surface. Without a card the device entry points raise unless asked for
the CPU."""

import json
import logging
import os

import pytest
import torch

import h2o_kubernetes_tpu as jpkg
import h2o_kubernetes_tpu.config as jconfig
import h2o_kubernetes_tpu_torch as port
import h2o_kubernetes_tpu_torch.config as pconfig
from h2o_kubernetes_tpu_torch import diagnostics

_NO_CARD = not torch.cuda.is_available()


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("key,value", [
    ("nbins", 4), ("nbins", 256), ("nbins", "64"), ("nbins", 3),
    ("nbins", 257), ("nbins", "sixty"), ("nbins", 31.9),
    ("log_level", "INFO"), ("log_level", "debug"), ("log_level", "verbose"),
    ("log_level", "WARNING")])
def test_validate_equals_reference(key, value):
    assert _outcome(pconfig._validate, key, value) == \
        _outcome(jconfig._validate, key, value)


def test_get_and_set_config_tiers(monkeypatch):
    monkeypatch.delenv("H2O_TPU_NBINS", raising=False)
    monkeypatch.setattr(pconfig, "CONFIG", {})
    assert pconfig.get_config("nbins") == pconfig.default_nbins() == 256
    assert pconfig.get_config("log_level") == "WARNING"
    monkeypatch.setenv("H2O_TPU_NBINS", "64")
    assert pconfig.get_config("nbins") == 64       # read at use time
    assert port.GBM(ntrees=1).params.nbins == 64
    pconfig.set_config("nbins", 32)                # programmatic wins
    assert pconfig.get_config("nbins") == 32
    assert port.GBM(ntrees=1).params.nbins == 32
    assert port.GBM(ntrees=1, nbins=16).params.nbins == 16
    for bad in (("nbins", 3), ("log_level", "verbose")):
        with pytest.raises(ValueError):
            pconfig.set_config(*bad)
    assert pconfig.get_config("nbins") == 32       # refused, not stored
    for call in (lambda: pconfig.get_config("hist_impl"),
                 lambda: pconfig.set_config("hist_impl", "auto"),
                 lambda: pconfig.get_config("no_such_key")):
        with pytest.raises(KeyError) as e:
            call()
        # the same message as the reference, less the unported key
        assert "unknown config key" in str(e.value)
    monkeypatch.setattr(pconfig, "CONFIG", {})
    monkeypatch.setenv("H2O_TPU_NBINS", "3")
    with pytest.raises(ValueError, match="bad H2O_TPU_NBINS='3'"):
        pconfig.get_config("nbins")
    level = diagnostics.log.level
    try:
        pconfig.set_config("log_level", "info")
        assert diagnostics.log.level == logging.INFO
    finally:
        diagnostics.log.setLevel(level)


def test_profile_writes_a_trace(tmp_path):
    before = diagnostics.timeline.kind_counts()
    with diagnostics.profile(str(tmp_path), device="cpu") as prof:
        torch.ones(64).cumsum(0).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "aten::cumsum" in names
    assert any(a.key == "aten::cumsum" for a in prof.key_averages())
    after = diagnostics.timeline.kind_counts()
    for kind in ("profile_start", "profile_stop"):
        assert after.get(kind, 0) == before.get(kind, 0) + 1
    assert diagnostics.timeline.events("profile_stop")[-1]["logdir"] == \
        str(tmp_path)


def test_profile_raises_when_the_card_records_no_kernel(tmp_path,
                                                       monkeypatch):
    """A card session whose trace holds no device event (CUPTI recorded
    nothing) writes its trace and then raises, rather than hand back an
    empty CUDA trace. The session is made here as such a process makes
    it: the device resolves to the card, the profiler records the host
    only."""
    from torch.profiler import ProfilerActivity

    import h2o_kubernetes_tpu_torch.models.base as pbase
    import h2o_kubernetes_tpu_torch.runtime.backend as pbackend

    real = torch.profiler.profile
    asked = []

    def host_only(activities):
        asked.append(list(activities))
        return real(activities=[ProfilerActivity.CPU])

    monkeypatch.setattr(pbackend, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(pbase, "device_synchronize", lambda device: None)
    monkeypatch.setattr(torch.profiler, "profile", host_only)
    with pytest.raises(RuntimeError, match="no device event"):
        with diagnostics.profile(str(tmp_path)):
            torch.ones(64).cumsum(0).sum()
    assert asked == [[ProfilerActivity.CPU, ProfilerActivity.CUDA]]
    assert (tmp_path / "trace.json").exists()
    assert diagnostics.timeline.events("profile_stop")[-1]["logdir"] == \
        str(tmp_path)


def test_device_memory_and_cluster_status_on_the_cpu():
    assert diagnostics.device_memory("cpu") == [
        {"device": "cpu", "bytes_in_use": None, "bytes_free": None,
         "bytes_limit": None}]
    st = port.cluster_status("cpu")
    assert st["devices"] == ["cpu"] and st["cloud_size"] == 1
    assert st["process_count"] == 1 and st["cloud_healthy"] is True
    assert str(port.init("cpu")) == "cpu"


def test_cluster_status_keys_equal_reference(mesh8):
    assert set(port.cluster_status("cpu")) == set(jpkg.cluster_status())


@pytest.mark.skipif(not _NO_CARD, reason="a card is present")
def test_device_entry_points_raise_without_a_card(tmp_path):
    for call in (diagnostics.device_memory, port.cluster_status, port.init,
                 lambda: diagnostics.device_memory("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(RuntimeError, match="CUDA"):
        with diagnostics.profile(str(tmp_path)):
            pass
    assert not os.path.exists(tmp_path / "trace.json")
