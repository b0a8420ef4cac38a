"""Entry points: the LM's forward on one device, and a data-parallel dry run
of its training step.

Run:  python -m precondition_tpu_torch.entry [--device cpu] [--ranks N]

The port's counterpart of the JAX package's `__graft_entry__.py`.
`entry` returns the forward at the graft entry's config and its
arguments; `dryrun_multichip` runs the full training step (forward,
backward, Shampoo) on N local ranks over an ``(N, 1)`` ("data", "model")
mesh in the JAX dry run's two optimizer modes: the root solve split
over the mesh, and the memory-sharded state (``shard_optimizer_states``,
state from ``tx.init(None).init_fn``).  The JAX dry run's tensor-parallel
``model`` axis of size 2 waits for ROADMAP.md queue 1, item 13b, and its
third mode, the sampler's sharded decode, for item 15.  Everything runs
on the card unless ``device="cpu"`` is given.
"""

import argparse
import math

import torch

from precondition_tpu_torch.models import transformer
from precondition_tpu_torch.optim import shampoo
from precondition_tpu_torch.parallel import local
from precondition_tpu_torch.parallel import mesh as mesh_lib
from precondition_tpu_torch.train import loop

# The dry run's LM: width 256 at block 128 gives a solve batch of about
# 130 statistics of [128, 128].
DRYRUN_CONFIG = transformer.TransformerConfig(
    vocab_size=256, d_model=256, n_heads=4, n_layers=2, d_ff=512,
    max_seq_len=32, remat=False)


def entry(device="cuda"):
  """Returns (fn, example_args): the forward of the flagship LM."""
  cfg = transformer.TransformerConfig(
      vocab_size=512, d_model=128, n_heads=4, n_layers=2, d_ff=512,
      max_seq_len=128)
  params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   device=device)
  tokens = torch.zeros((2, 64), dtype=torch.long, device=device)

  def fn(params, tokens):
    return transformer.forward(params, tokens, cfg)

  return fn, (params, tokens)


def optimizer_options(spec, world: int) -> dict:
  """The dry run's Shampoo options (the JAX dry run's)."""
  return dict(learning_rate=0.01, block_size=128,
              start_preconditioning_step=0,
              graft_type=shampoo.GraftingType.RMSPROP,
              statistics_partition_spec=spec,
              preconditioner_partition_spec=spec,
              num_devices_for_pjit=world)


def dryrun_rank(rank, world, device):
  """Both modes' training step on one rank; returns their losses."""
  if device == "cuda":
    torch.cuda.set_device(rank % torch.cuda.device_count())
  mesh = mesh_lib.make_mesh((world, 1), ("data", "model"), device_type=device)
  spec = mesh_lib.sharding(mesh, ("data", "model"))
  cfg = DRYRUN_CONFIG
  params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   device=device)
  params = mesh_lib.shard_params(params, mesh, transformer.TP_RULES)
  # Random tokens, not zeros: a constant batch is memorized by one step-0
  # Shampoo update.
  batch = {"tokens": torch.randint(
      0, cfg.vocab_size, (world * 2, 33),
      generator=torch.Generator().manual_seed(1)).to(device)}
  loss = lambda p, b: transformer.loss_terms(p, b, cfg)

  tx = shampoo.distributed_shampoo(**optimizer_options(spec, world))
  step = loop.make_sharded_train_step(loss, tx, mesh, transformer.TP_RULES)
  loss1, params, _ = step(params, tx.init(params), batch)

  ztx = shampoo.distributed_shampoo(**optimizer_options(spec, world),
                                    shard_optimizer_states=True)
  zstep = loop.make_sharded_train_step(loss, ztx, mesh, transformer.TP_RULES)
  loss2, params, _ = zstep(params, ztx.init(None).init_fn(params), batch)
  return float(loss1), float(loss2)


def dryrun_multichip(n_ranks: int, device="cuda") -> None:
  """The full training step over ``n_ranks`` local ranks, both modes."""
  losses = local.run_local_ranks(
      dryrun_rank, n_ranks, args=(device,),
      backend=local.backend_for(device, n_ranks), timeout=300.0)
  for mode in range(2):
    values = [r[mode] for r in losses]
    if not all(math.isfinite(v) and v == values[0] for v in values):
      raise RuntimeError(f"mode {mode + 1}: the ranks' losses {values}")
  print(f"[dryrun] mode 1 ok: distributed-solve step executed on "
        f"{n_ranks}x1 (data, model) mesh, loss {losses[0][0]:.4f}",
        flush=True)
  print(f"[dryrun] mode 2 ok: shard_optimizer_states step executed (global "
        f"stats stack sharded over {n_ranks} ranks), loss "
        f"{losses[0][1]:.4f}", flush=True)
  print("[dryrun] mode 3 (the sampler's sharded decode) waits for ROADMAP "
        "item 15; the (n/2, 2) tensor-parallel mesh for item 13b", flush=True)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--ranks", type=int, default=None,
                      help="default: the cards on the host, 2 on the CPU")
  args = parser.parse_args(argv)
  if args.device == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device; pass --device cpu")
  ranks = args.ranks or (torch.cuda.device_count() if args.device == "cuda"
                         else 2)
  fn, fn_args = entry(args.device)
  with torch.no_grad():
    out = fn(*fn_args)
  print("entry forward ok:", tuple(out.shape))
  dryrun_multichip(ranks, args.device)
  print("dryrun_multichip ok")


if __name__ == "__main__":
  main()
