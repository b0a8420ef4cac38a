"""Step time of `distributed_shampoo` on the bench fixture, for holding two
checkouts of the port against each other on one GPU.

Run from any directory, one process per checkout:

    python precondition_tpu_torch/probes/step_time.py [--root DIR] [--steps N]

The port (`precondition_tpu_torch`) and the fixture of chip_smoke.py
(`HYPERS`, `bench_tree_shapes`) are imported from the checkout at ``DIR``
(default: the one that holds this file), so an older checkout that lacks
this probe is timed by the same code.  The probe builds the 58.7M-parameter
tree of chip_smoke.py's phase (c) from the seed 0 on the card (parameters
``0.02 randn``, gradients ``0.01 randn`` from one generator), runs one
update (it builds the Newton kernel and pays lazy set-up), resets the peak
memory counter and runs ``N`` more, each timed on the host clock up to a
``torch.cuda.synchronize()``.  It prints one JSON object: the root, each
timed step's ms, their median, and the peak device memory over them.  With
``--device cpu`` and a smaller tree (``measure(..., d=64)``) the plain
twins run and the peak is null.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_DEFAULT_ROOT = os.path.dirname(os.path.dirname(_HERE))


def _load(root: str):
  """chip_smoke and the port's shampoo module, both from ``root``."""
  root = os.path.abspath(root)
  if root not in sys.path:
    sys.path.insert(0, root)
  import chip_smoke  # pylint: disable=import-outside-toplevel
  from precondition_tpu_torch.optim import shampoo  # pylint: disable=import-outside-toplevel
  for module in (chip_smoke, shampoo):
    if os.path.commonpath([root, os.path.abspath(module.__file__)]) != root:
      raise RuntimeError(f"{module.__name__} came from {module.__file__}, "
                         f"not from {root}")
  return chip_smoke, shampoo


def measure(root: str = _DEFAULT_ROOT, steps: int = 20, device: str = "cuda",
            **tree) -> dict:
  """One warm-up update and ``steps`` timed ones of the bench fixture (cut
  by ``tree``, the keywords of chip_smoke's `bench_tree_shapes`)."""
  chip_smoke, shampoo = _load(root)
  device = torch.device(device)
  cuda = device.type == "cuda"
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  gen = torch.Generator(device=device).manual_seed(0)
  shapes = chip_smoke.bench_tree_shapes(**tree)
  params = {n: 0.02 * torch.randn(s, generator=gen, device=device)
            for n, s in shapes.items()}
  grads = lambda: {n: 0.01 * torch.randn(s, generator=gen, device=device)
                   for n, s in shapes.items()}
  opt = shampoo.distributed_shampoo(**chip_smoke.HYPERS)
  state = opt.init(params)
  _, state = opt.update(grads(), state, params)
  sync()
  if cuda:
    torch.cuda.reset_peak_memory_stats(device)
  times = []
  for _ in range(steps):
    g = grads()
    sync()
    start = time.perf_counter()
    updates, state = opt.update(g, state, params)
    sync()
    times.append(1e3 * (time.perf_counter() - start))
    for n, u in updates.items():
      params[n] += u
  return {"root": root, "step_ms": times,
          "median_ms": float(np.median(times)),
          "peak_bytes": (torch.cuda.max_memory_allocated(device) if cuda
                         else None)}


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--root", default=_DEFAULT_ROOT)
  parser.add_argument("--steps", type=int, default=20)
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)
  print(json.dumps({"step_time": measure(args.root, args.steps,
                                         args.device)}), flush=True)


if __name__ == "__main__":
  main()
