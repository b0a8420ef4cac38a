"""Data-parallel training: the transformer + Shampoo over a mesh of ranks.

Run:  python -m precondition_tpu_torch.examples.spmd_transformer \\
          [--device cpu] [--ranks N]

The port's counterpart of the JAX package's `examples/spmd_transformer.py`.
It starts N ranks on this host (`parallel.local.run_local_ranks`: NCCL
with one card a rank where there are enough cards, else gloo) on an
``(N, 1)`` ("data", "model") mesh.  Each rank takes its slice of every
global batch, the gradients are all-reduced over ``data``, and the
stacked root solves split over the mesh through the partition specs
passed to the optimizer.  The JAX example's ``(N/2, 2)`` mesh also splits
the layers' kernels over ``model`` (tensor parallelism), which the port
has not taken yet (ROADMAP.md queue 1, item 13b): its `TP_RULES` place
every parameter whole on a mesh whose ``model`` axis has size 1.
"""

import argparse

import numpy as np
import torch

from precondition_tpu_torch import distributed_shampoo
from precondition_tpu_torch.models import transformer
from precondition_tpu_torch.parallel import local
from precondition_tpu_torch.parallel import mesh as mesh_lib
from precondition_tpu_torch.train import loop


def print_none(line):
  del line


def rank_main(rank, world, device):
  """One rank's training run; returns its losses."""
  if device == "cuda":
    torch.cuda.set_device(rank % torch.cuda.device_count())
  mesh = mesh_lib.make_mesh((world, 1), device_type=device)
  if rank == 0:
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    print(f"mesh: {shape}; the JAX example's (n/2, 2) tensor-parallel mesh "
          "waits for ROADMAP item 13b", flush=True)

  cfg = transformer.TransformerConfig(
      vocab_size=512, d_model=128, n_heads=4, n_layers=2, d_ff=256,
      max_seq_len=64, dtype=torch.float32)
  params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   device=device)

  spec = mesh_lib.sharding(mesh, ("data", "model"))
  tx = distributed_shampoo(
      learning_rate=1e-3,
      block_size=128,
      start_preconditioning_step=2,
      # Split the stacked [N, m, m] root solves across every rank of the
      # mesh; the roots all-gather back.
      statistics_partition_spec=spec,
      preconditioner_partition_spec=spec,
      generate_training_metrics=False,
  )

  rng = np.random.RandomState(0)
  batches = ({"tokens": torch.from_numpy(rng.randint(0, 512, (16, 64))).to(
      device)} for _ in range(10))
  log = (lambda line: print(line, flush=True)) if rank == 0 else print_none
  _, _, losses = loop.train(
      lambda p, b: transformer.loss_terms(p, b, cfg), tx, params, batches,
      mesh=mesh, param_rules=transformer.TP_RULES, log_every=2,
      log_fn=log)
  return [float(x) for x in losses]


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--ranks", type=int, default=2)
  args = parser.parse_args(argv)
  from precondition_tpu_torch.examples import spmd_transformer
  losses = local.run_local_ranks(
      spmd_transformer.rank_main, args.ranks, args=(args.device,),
      backend=local.backend_for(args.device, args.ranks), timeout=300.0)
  first = losses[0]
  print(f"first loss {first[0]:.4f} -> last {first[-1]:.4f}")


if __name__ == "__main__":
  main()
