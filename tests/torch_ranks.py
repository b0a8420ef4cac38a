"""Rank bodies of the port's distribution tests: torch, numpy and the port.

`tests/test_torch_distributed.py` and `tests/test_torch_sharded.py` run
these functions on CPU ranks joined by gloo
(`precondition_tpu_torch.parallel.local.run_local_ranks`).  Spawned ranks
import this module, not the test files, so they never load JAX
(`tests/test_torch_imports.py` checks that this module loads none).  Inputs
arrive as numpy arrays and results leave as numpy arrays in the port's own
state classes (`to_numpy`, `to_torch`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from precondition_tpu_torch.ops import lowrank
from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.kernels import newton_root
from precondition_tpu_torch.optim import shampoo
from precondition_tpu_torch.parallel import mesh as mesh_lib

# The solvers whose batch sizes a rank records: (module, function name).
_SOLVERS = ((newton_root, "batched_inverse_pth_root"),
            (pth_root, "batched_inverse_pth_root"),
            (lowrank, "low_rank_root"), (lowrank, "fd_update_root"))


def tree_map(fn, tree):
  """``fn`` on every array leaf of the port's states: dataclasses,
  NamedTuples, dicts, lists and tuples keep their classes."""
  if isinstance(tree, (torch.Tensor, np.ndarray)):
    return fn(tree)
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: tree_map(fn, getattr(tree, f.name))
        for f in dataclasses.fields(tree) if f.init})
  if isinstance(tree, tuple) and hasattr(tree, "_fields"):
    return type(tree)(*(tree_map(fn, x) for x in tree))
  if isinstance(tree, dict):
    return {k: tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(tree_map(fn, x) for x in tree)
  return tree


def to_numpy(tree):
  return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def to_torch(tree):
  return tree_map(torch.from_numpy, tree)


def _setup(v0):
  """One thread; JAX's power-iteration start vectors (``{m: [m]}``);
  returns the list each solver call appends its batch size to."""
  torch.set_num_threads(1)
  if v0:
    pth_root.default_v0 = lambda n, dtype=torch.float32, device=None: (
        torch.from_numpy(v0[n]).to(dtype=dtype, device=device))
  sizes = []
  for module, name in _SOLVERS:
    def counted(stats, *args, _solve=getattr(module, name), **kwargs):
      sizes.append(int(stats.shape[0]))
      return _solve(stats, *args, **kwargs)
    setattr(module, name, counted)
  return sizes


def _spec(spec):
  """``("mesh", shape, axis names, *spec)`` as a `Sharding` of CPU ranks."""
  if spec is None:
    return None
  _, shape, names, *rest = spec
  return mesh_lib.sharding(
      mesh_lib.make_mesh(shape, names, device_type="cpu"), *rest)


def _steps(hypers, params, grads, init=None):
  """The port's updates of ``params`` by ``grads`` (numpy): per step the
  updates and the state, as numpy."""
  opt = shampoo.distributed_shampoo(**hypers)
  params = {k: torch.from_numpy(v) for k, v in params.items()}
  state = init(opt, params) if init else opt.init(params)
  out = []
  for g in grads:
    upd, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                            state, params)
    out.append((to_numpy(upd), to_numpy(state)))
  return out


def distributed_jobs(rank, world, jobs, v0=None):
  """Runs each job, ``dict(k, hypers, params, grads, spec=None)``, on the
  ranks it names: ``k`` ranks under ``batch_axis_name`` (the default group
  by its string when ``k`` is the world, else a `ProcessGroup` of the
  first ``k``; ``k = 0`` runs no distribution option), or every rank under
  the partition ``spec``.  Per job: the steps and the solvers' batch sizes
  on this rank, or None where the rank is not in the job."""
  sizes = _setup(v0)
  out = []
  for job in jobs:
    hypers = dict(job["hypers"])
    k = job.get("k")
    if job.get("spec") is not None:
      spec = _spec(job["spec"])
      hypers.update(statistics_partition_spec=spec,
                    preconditioner_partition_spec=spec)
    elif k:
      group = "batch" if k == world else dist.new_group(list(range(k)))
      if rank >= k:
        out.append(None)
        continue
      hypers["batch_axis_name"] = group
    sizes.clear()
    steps = _steps(hypers, job["params"], job["grads"])
    out.append((steps, list(sizes)))
  return out


def sharded_job(rank, world, job, v0=None):
  """``job["hypers"]`` with ``shard_optimizer_states`` over the spec
  ``job["spec"]``: the steps from ``init(None).init_fn``, and from the
  JAX state ``job["resume"]`` (a rank's slice as numpy, from
  `utils.convert.sharded_state_from_numpy` in the parent) when given,
  once with the params and grads dicts in their order and once reversed;
  with the bytes this rank's global and local state hold after init."""
  _setup(v0)
  spec = _spec(job["spec"])
  hypers = dict(job["hypers"], shard_optimizer_states=True,
                statistics_partition_spec=spec,
                preconditioner_partition_spec=spec)
  held = {}

  def init(opt, params):
    state = opt.init(None).init_fn(params)
    nbytes = lambda tree: sum(
        t.numel() * t.element_size()
        for t in _leaves(tree) if isinstance(t, torch.Tensor))
    held["global"] = nbytes(state.stats.global_stats)
    held["local"] = nbytes(state.stats.local_stats)
    return state

  out = {"steps": _steps(hypers, job["params"], job["grads"], init),
         "bytes": held}
  if job.get("resume") is not None:
    # Resumed twice: with the dicts in the job's order, then reversed.
    for key, order in (("resumed", 1), ("resumed_reversed", -1)):
      resumed = to_torch(job["resume"][rank])
      out[key] = _steps(
          hypers, _ordered(job["params"], order),
          [_ordered(g, order) for g in job["resume_grads"]],
          lambda opt, params, resumed=resumed: resumed)
  return out


def _ordered(tree, order):
  """``tree``'s items in their order (``order`` 1) or reversed (-1)."""
  return dict(list(tree.items())[::order])


def _leaves(tree):
  found = []
  tree_map(found.append, tree)
  return found


def train_job(rank, world, job, v0=None):
  """The LM's data-parallel train step on a ``(world, 1)`` ("data",
  "model") mesh: ``job["steps"]`` steps of the global batches
  ``job["batches"]`` (numpy) from ``job["params"]``, once per mode of
  ``job["modes"]``: "batch_axis" (``batch_axis_name``), "specs" (the
  solve split by partition specs over both axes) and "sharded"
  (``shard_optimizer_states`` with those specs).  Per mode: the losses
  and the final params, as numpy."""
  from precondition_tpu_torch.models import transformer
  from precondition_tpu_torch.train import loop

  _setup(v0)
  cfg = transformer.TransformerConfig(**job["config"])
  mesh = mesh_lib.make_mesh((world, 1), ("data", "model"), device_type="cpu")
  spec = mesh_lib.sharding(mesh, ("data", "model"))
  options = {
      "batch_axis": dict(batch_axis_name="batch"),
      "specs": dict(statistics_partition_spec=spec,
                    preconditioner_partition_spec=spec,
                    num_devices_for_pjit=world),
      "sharded": dict(statistics_partition_spec=spec,
                      preconditioner_partition_spec=spec,
                      num_devices_for_pjit=world,
                      shard_optimizer_states=True)}
  out = {}
  for mode in job["modes"]:
    tx = shampoo.distributed_shampoo(**job["hypers"], **options[mode])
    params = mesh_lib.shard_params(
        {k: torch.from_numpy(v.copy()) for k, v in job["params"].items()},
        mesh, transformer.TP_RULES)
    state = (tx.init(None).init_fn(params) if mode == "sharded"
             else tx.init(params))
    step = loop.make_sharded_train_step(
        lambda p, b: transformer.loss_terms(p, b, cfg), tx, mesh,
        transformer.TP_RULES)
    losses = []
    for batch in job["batches"]:
      loss, params, state = step(
          params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
      losses.append(float(loss))
    out[mode] = (losses, to_numpy(params))
  return out


def shard_params_job(rank, world):
  """`shard_params` of the LM's params under its `TP_RULES`: whether over
  a ``(world, 1)`` mesh every param came back whole and unchanged, and
  what a ``(1, world)`` mesh raised."""
  from precondition_tpu_torch.models import transformer

  cfg = transformer.TransformerConfig(vocab_size=16, d_model=8, n_heads=2,
                                      n_layers=1, d_ff=16, max_seq_len=4)
  params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
  names = ("data", "model")
  placed = mesh_lib.shard_params(
      params, mesh_lib.make_mesh((world, 1), names, device_type="cpu"),
      transformer.TP_RULES)
  whole = list(placed) == list(params) and all(
      torch.equal(placed[n], p) for n, p in params.items())
  try:
    mesh_lib.shard_params(
        params, mesh_lib.make_mesh((1, world), names, device_type="cpu"),
        transformer.TP_RULES)
    refused = ""
  except NotImplementedError as e:
    refused = f"NotImplementedError: {e}"
  return whole, refused
