"""Training loop: a train step on one process, or data-parallel over a mesh.

Port of `precondition_tpu/train/loop.py`.  JAX jits one step over a mesh
and lets XLA insert the gradient all-reduce; here each rank of the mesh's
``data`` axis takes its slice of the global batch, and the step
all-reduces the gradients over that axis's process group itself.

A loss function is ``loss_fn(params, batch)``, ``params`` the flat dict of
the optimizers.  It returns the loss, or a pair ``(numerator, weight)``
whose loss is ``numerator / max(weight, 1)`` (`models.transformer.
loss_terms`).  The pair matters under data parallelism: JAX's jit sees
the whole batch, so a masked or weighted mean is over every rank's
positions, not the mean of per-rank means; the step sums both terms over
the ranks before it divides.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from precondition_tpu_torch.parallel import mesh as mesh_lib


def _terms(out):
  """``(numerator, weight)`` of a loss function's result; a plain loss is
  its own numerator with weight None."""
  return tuple(out) if isinstance(out, (tuple, list)) else (out, None)


def _divide(numerator, weight):
  return numerator if weight is None else numerator / weight.clamp(min=1.0)


def _grads(loss, params):
  """Gradients of ``loss`` by name; zeros for a param it does not use."""
  grads = torch.autograd.grad(loss, list(params.values()),
                              materialize_grads=True)
  return dict(zip(params, grads))


@torch.no_grad()
def _apply(tx, grads, opt_state, params):
  """``tx``'s update added to ``params`` in place (JAX donates them)."""
  updates, opt_state = tx.update(grads, opt_state, params)
  for name, p in params.items():
    p.add_(updates[name])
  return params, opt_state


def _leaves(params):
  return {name: p.detach().requires_grad_(True) for name, p in params.items()}


def make_train_step(loss_fn: Callable, tx) -> Callable:
  """``step(params, opt_state, batch) -> (loss, params, opt_state)``.

  Gradients by `torch.autograd.grad` over the flat dict, then
  ``tx.update``, then ``params + updates``, written into ``params``.
  """

  def step(params, opt_state, batch):
    leaves = _leaves(params)
    loss = _divide(*_terms(loss_fn(leaves, batch)))
    grads = _grads(loss, leaves)
    params, opt_state = _apply(tx, grads, opt_state, params)
    return loss.detach(), params, opt_state

  return step


def _all_reduce(tensors, group):
  """Sums each tensor over ``group`` in one collective."""
  flat = torch.cat([t.reshape(-1) for t in tensors])
  dist.all_reduce(flat, group=group)
  return [x.view_as(t) for x, t in zip(flat.split([t.numel() for t in tensors]),
                                       tensors)]


def _batch_slice(batch, shards: Optional[mesh_lib.ShardGroup]):
  """This rank's rows of every entry of a global ``batch``."""
  if shards is None:
    return batch
  out = {}
  for key, value in batch.items():
    rows = value.shape[0]
    if rows % shards.size:
      raise ValueError(f"batch entry {key!r} has {rows} rows, which "
                       f"{shards.size} ranks do not split evenly")
    per = rows // shards.size
    out[key] = value[shards.index * per:(shards.index + 1) * per]
  return out


def make_sharded_train_step(loss_fn: Callable, tx, mesh, param_rules=(),
                            batch_spec=("data",)) -> Callable:
  """The train step, data-parallel over ``mesh``.

  Each rank of the axes that ``batch_spec`` names for the batch's first
  dimension takes its contiguous slice of the global batch; the
  gradients are summed over those axes' group, and so are the loss's
  terms where ``loss_fn`` returns ``(numerator, weight)`` (a plain loss
  is averaged over the ranks).  ``tx`` is the caller's optimizer, built
  with ``batch_axis_name`` or partition specs over the same mesh when its
  solve should split.  Params arrive as `parallel.mesh.shard_params`
  placed them (``param_rules``, as in JAX, are applied there).
  """
  del param_rules
  batch_sharding = mesh_lib.sharding(mesh, *batch_spec)

  def step(params, opt_state, batch):
    shards = mesh_lib.shard_group(batch_sharding)
    leaves = _leaves(params)
    numerator, weight = _terms(loss_fn(leaves, _batch_slice(batch, shards)))
    if shards is None:
      loss = _divide(numerator, weight)
      grads = _grads(loss, leaves)
    else:
      if weight is not None:
        (weight,) = _all_reduce([weight.detach()], shards.group)
      else:
        numerator = numerator / shards.size
      grads = _grads(_divide(numerator, weight), leaves)
      *values, total = _all_reduce(list(grads.values())
                                   + [numerator.detach()], shards.group)
      grads = dict(zip(grads, values))
      loss = _divide(total, weight)
    params, opt_state = _apply(tx, grads, opt_state, params)
    return loss.detach(), params, opt_state

  return step


def train(loss_fn: Callable, tx, params, batches, mesh=None, param_rules=(),
          log_every: int = 0, log_fn=print) -> Tuple[Any, Any, list]:
  """Inits the optimizer state and takes one step per batch; returns
  ``(params, opt_state, losses)``."""
  opt_state = tx.init(params)
  if mesh is not None:
    params = mesh_lib.shard_params(params, mesh, param_rules)
    step = make_sharded_train_step(loss_fn, tx, mesh, param_rules)
  else:
    step = make_train_step(loss_fn, tx)
  losses = []
  for i, batch in enumerate(batches):
    loss, params, opt_state = step(params, opt_state, batch)
    losses.append(loss)
    if log_every and (i % log_every == 0):
      log_fn(f"step {i}: loss {float(loss):.4f}")
  return params, opt_state, losses
