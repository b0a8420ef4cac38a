"""The port's examples and entry point run end to end on the CPU.

Each runs in a fresh interpreter, as a user runs it (``python -m``), with
``--device cpu``; the test holds it to exit 0 and to its own printout: a
loss that falls (below the first step's at the last logged step; for
`spmd_transformer`, whose random tokens carry nothing to learn but their
uniform distribution, at some logged step), and the entry point's forward
shape and both dry-run modes.
"""

import pathlib
import re
import subprocess
import sys

import pytest

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(module):
  out = subprocess.run(
      [sys.executable, "-m", module, "--device", "cpu"], cwd=_ROOT,
      capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr[-3000:]
  return out.stdout


def _losses(stdout):
  return [float(x) for x in re.findall(r"loss ([0-9.]+)", stdout)]


@pytest.mark.parametrize("example", ["quickstart", "tearfree_sketchy"])
def test_example_trains(example):
  losses = _losses(_run(f"precondition_tpu_torch.examples.{example}"))
  assert len(losses) >= 5
  assert losses[-1] < losses[0], losses


def test_spmd_transformer_trains_over_two_ranks():
  stdout = _run("precondition_tpu_torch.examples.spmd_transformer")
  assert "mesh: {'data': 2, 'model': 1}" in stdout
  assert "item 13b" in stdout
  losses = _losses(stdout)
  assert len(losses) == 6  # steps 0, 2, 4, 6, 8, then the first again
  assert min(losses[1:5]) < losses[0], losses


def test_entry_runs_forward_and_both_dryrun_modes():
  stdout = _run("precondition_tpu_torch.entry")
  assert "entry forward ok: (2, 64, 512)" in stdout
  assert "[dryrun] mode 1 ok" in stdout and "[dryrun] mode 2 ok" in stdout
  assert "item 15" in stdout
  assert stdout.rstrip().endswith("dryrun_multichip ok")
