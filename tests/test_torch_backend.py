"""The port's CUDA liveness probe (``projected_langevin_sampling_torch/utils/backend.py``)
on a machine with no card: the probe fails, ``ensure_live_backend`` raises
rather than switching device, a request for the CPU needs no probe, and a
child that hangs is cut at the timeout."""

import pytest

from projected_langevin_sampling_torch.utils import backend


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.setattr(backend, "_PROBE_CACHE", {})


def test_probe_fails_without_a_card_and_ensure_raises(capsys):
    assert backend.backend_initialises(120.0) is False
    assert "CUDA init subprocess failed" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match=r"CUDA backend failed to initialise \[smoke\]"):
        backend.ensure_live_backend(120.0, context="smoke")


def test_probe_is_memoised_per_timeout(monkeypatch):
    assert backend.backend_initialises(120.0) is False
    monkeypatch.setattr(backend, "PROBE_CODE", "raise SystemExit(0)")
    assert backend.backend_initialises(120.0) is False  # the first answer stands
    assert backend.backend_initialises(119.0) is True  # another timeout probes again


def test_the_cpu_needs_no_probe(monkeypatch):
    monkeypatch.setattr(backend, "PROBE_CODE", "raise SystemExit(1)")
    assert backend.backend_initialises(120.0, device="cpu") is True
    backend.ensure_live_backend(120.0, device="cpu")
    assert backend._PROBE_CACHE == {}


def test_a_hanging_child_times_out(monkeypatch, capsys):
    monkeypatch.setattr(backend, "PROBE_CODE", "import time; time.sleep(60)")
    assert backend.backend_initialises(1.0) is False
    assert "timed out after 1 s" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="timed out after 1 s"):
        backend.ensure_live_backend(1.0)
