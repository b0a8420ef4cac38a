"""Quickstart: distributed Shampoo on a small MLP, one device.

Run:  python -m precondition_tpu_torch.examples.quickstart [--device cpu]

The port's counterpart of the JAX package's `examples/quickstart.py`:
build the transformation, init its state from the params (a flat dict of
name -> tensor), and train with `train.loop.make_train_step`.  Runs on the
card unless ``--device cpu`` is given.
"""

import argparse

import torch
import torch.nn.functional as F

from precondition_tpu_torch import GraftingType, distributed_shampoo
from precondition_tpu_torch.train import loop


def init_mlp(generator, sizes=(64, 256, 256, 10), device="cuda"):
  """The JAX example's list of layers, flattened as ``"0/w"``, ``"0/b"``."""
  params = {}
  for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:])):
    params[f"{i}/b"] = torch.zeros(n, device=device)
    params[f"{i}/w"] = (torch.randn(m, n, generator=generator)
                        / m ** 0.5).to(device)
  return params


def forward(params, x):
  layers = len(params) // 2
  for i in range(layers - 1):
    x = torch.relu(x @ params[f"{i}/w"] + params[f"{i}/b"])
  return x @ params[f"{layers - 1}/w"] + params[f"{layers - 1}/b"]


def loss_fn(params, batch):
  return F.cross_entropy(forward(params, batch["x"]), batch["y"])


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--steps", type=int, default=50)
  args = parser.parse_args(argv)
  tx = distributed_shampoo(
      learning_rate=0.003,
      block_size=128,
      graft_type=GraftingType.RMSPROP,
      start_preconditioning_step=10,
      preconditioning_compute_steps=2,  # solve roots every other step
      generate_training_metrics=True,   # root errors/iters ride in state
  )

  generator = torch.Generator().manual_seed(0)
  params = init_mlp(generator, device=args.device)
  state = tx.init(params)
  step = loop.make_train_step(loss_fn, tx)

  x = torch.randn(256, 64, generator=generator)
  y = (x[:, 0] > 0).long() * 5 + (x[:, 1] > 0).long()
  batch = {"x": x.to(args.device), "y": y.to(args.device)}
  for i in range(args.steps):
    loss, params, state = step(params, state, batch)
    if i % 10 == 0 or i == args.steps - 1:
      print(f"step {i:3d}  loss {float(loss):.4f}")

  # Root-solve health, read from the optimizer state:
  metrics = state.stats["2/w"].training_metrics
  print("max root error:", float(metrics.error.max()))


if __name__ == "__main__":
  main()
