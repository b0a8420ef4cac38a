"""Tearfree with Sketchy (frequent-directions) preconditioning.

Run:  python -m precondition_tpu_torch.examples.tearfree_sketchy \\
          [--device cpu]

The port's counterpart of the JAX package's `examples/tearfree_sketchy.py`.
The tearfree stack is the modular composition
``grafting o (merge -> second-order -> unmerge) o momentum``; Sketchy
replaces full Kronecker factors with rank-k FD sketches per tensor axis
(memory ~ rank/dim of blocked Shampoo). ``memory_alloc`` overrides the
rank per layer.  The JAX example ends with the count of its state's
praxis partition specs; the port keeps no praxis specs (they describe
JAX arrays' sharding), so it counts its state's tensors.
"""

import argparse

import numpy as np
import torch

from precondition_tpu_torch.tearfree import grafting
from precondition_tpu_torch.tearfree import momentum
from precondition_tpu_torch.tearfree import optimizer
from precondition_tpu_torch.tearfree import second_order
from precondition_tpu_torch.tearfree import sketchy
from precondition_tpu_torch.train import loop


def _tensors(tree):
  """The tensors of a state: dataclasses, dicts, lists and tuples walked."""
  if isinstance(tree, torch.Tensor):
    return [tree]
  if hasattr(tree, "__dataclass_fields__"):
    tree = [getattr(tree, f) for f in tree.__dataclass_fields__]
  elif isinstance(tree, dict):
    tree = list(tree.values())
  elif not isinstance(tree, (list, tuple)):
    return []
  return [t for x in tree for t in _tensors(x)]


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--steps", type=int, default=80)
  args = parser.parse_args(argv)
  device = args.device
  options = optimizer.TearfreeOptions(
      grafting_options=grafting.Options(
          grafting_type=grafting.GraftingType.RMSPROP,
          second_moment_decay=0.999,
          start_preconditioning_step=8,
      ),
      second_order_options=second_order.Options(
          second_order_type=second_order.SecondOrderType.SKETCHY,
          shampoo_options=None,
          sketchy_options=sketchy.Options(
              rank=16,                    # FD sketch size per tensor axis
              second_moment_decay=0.999,
              # memory_alloc={"dense1": {"w": [32, 8]}},  # per-layer ranks
          ),
      ),
      momentum_options=momentum.Options(momentum_decay=0.9),
  )
  tx = optimizer.tearfree(0.003, options)

  generator = torch.Generator().manual_seed(0)
  params = {
      "dense1/w": (torch.randn(96, 128, generator=generator) * 0.1).to(device),
      "dense2/w": (torch.randn(128, 8, generator=generator) * 0.1).to(device),
  }
  state = tx.init(params)

  def loss_fn(p, batch):
    h = torch.tanh(batch["x"] @ p["dense1/w"])
    return ((h @ p["dense2/w"] - batch["y"]) ** 2).mean()

  step = loop.make_train_step(loss_fn, tx)
  rng = np.random.RandomState(0)
  target = rng.randn(96, 8) * 0.3
  for i in range(args.steps):
    x = rng.randn(64, 96).astype(np.float32)
    y = (np.tanh(x) @ target).astype(np.float32)
    loss, params, state = step(params, state, {
        "x": torch.from_numpy(x).to(device),
        "y": torch.from_numpy(y).to(device)})
    if i % 10 == 0 or i == args.steps - 1:
      print(f"step {i:3d}  loss {float(loss):.5f}")

  print("state tensors:", len(_tensors(state)))


if __name__ == "__main__":
  main()
