"""The step-time probe (`precondition_tpu_torch/probes/step_time.py`) on the
CPU at a narrow width: it imports the fixture and the port from the checkout
it is given and times the plain twin's updates."""

import os
import sys

import numpy as np
import pytest

from precondition_tpu_torch.probes import step_time


def test_step_time_runs_on_the_cpu():
  out = step_time.measure(steps=2, device="cpu", d=32, ff=64, vocab=64,
                          layers=1)
  assert out["root"] == step_time._DEFAULT_ROOT
  assert os.path.isfile(os.path.join(out["root"], "chip_smoke.py"))
  assert len(out["step_ms"]) == 2 and out["peak_bytes"] is None
  assert np.all(np.isfinite(out["step_ms"])) and out["median_ms"] > 0


def test_step_time_refuses_a_second_checkout(tmp_path, monkeypatch):
  """The port is already imported from this checkout; another root would
  time this checkout's code under the other's name."""
  step_time._load(step_time._DEFAULT_ROOT)
  monkeypatch.setattr(sys, "path", list(sys.path))
  (tmp_path / "chip_smoke.py").write_text("")
  with pytest.raises(RuntimeError, match="not from"):
    step_time.measure(root=str(tmp_path), steps=1, device="cpu")
