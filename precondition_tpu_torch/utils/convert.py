"""Moves parameters and optimizer state between the JAX package and the port.

Both directions go through numpy, so nothing here imports JAX: a JAX tree
is handed over as the same tree with numpy leaves
(``jax.tree.map(np.asarray, tree)``).  Nested dicts, lists and tuples
flatten to the port's flat ``{"a/b": tensor}`` dicts in JAX's flattening
order (sorted keys, list entries by index: ``blocks/0/attn/qkv``), and
`params_to_numpy` rebuilds the nested tree.
Both state layouts travel, as do `QuantizedValue` leaves, packed
low-rank and frequent-directions roots, the FD gradient average and every
report of the metrics (LOBPCG, the residuals of the root and of the
deflated problem, FD); a report JAX masks is None in the port.  SM3 and
tearfree states travel too (`sm3_state_from_numpy`,
`tearfree_state_from_numpy` and their inverses), so that a run can start
in JAX and continue in the port, and so does the memory-sharded state
(`sharded_state_from_numpy` takes one rank's rows of JAX's global arrays,
`sharded_state_to_numpy` joins the ranks' rows back).

Every ``*_from_numpy`` builds its tensors on the card (``device="cuda"``)
unless the caller names another device, and raises where there is no card
and none was named.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from precondition_tpu_torch.ops.pth_root import REPORTS, RootMetrics
from precondition_tpu_torch.optim import sharded_shampoo
from precondition_tpu_torch.optim import sm3
from precondition_tpu_torch.optim.shampoo import ParameterStats, ShampooState
from precondition_tpu_torch.tearfree import grafting as tf_grafting
from precondition_tpu_torch.tearfree import momentum as tf_momentum
from precondition_tpu_torch.tearfree import shampoo as tf_shampoo
from precondition_tpu_torch.tearfree import sketchy as tf_sketchy
from precondition_tpu_torch.utils.quantization import QuantizedValue

_METRIC_FIELDS = ("error", "iterations", "error_ratio", "max_eigenvalue",
                  "retries")


def _is_sequence(tree) -> bool:
  """A list or plain tuple, whose entries JAX's trees index; a NamedTuple
  is one of the states' classes here, a leaf."""
  return isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields")


def _flatten(tree, prefix="") -> List[Tuple[str, Any]]:
  """``(path, leaf)`` pairs in JAX's flattening order: dict keys sorted,
  list and tuple entries by index (``blocks/0/attn/qkv``)."""
  if isinstance(tree, dict):
    items = [(key, tree[key]) for key in sorted(tree)]
  elif _is_sequence(tree):
    items = list(enumerate(tree))
  else:
    return [(prefix[:-1], tree)]
  out = []
  for key, value in items:
    out += _flatten(value, f"{prefix}{key}/")
  return out


def _map_like(tree, fn, prefix=""):
  """Rebuilds the nested dict, list and tuple structure of ``tree`` with
  ``fn(path, leaf)``."""
  if isinstance(tree, dict):
    return {key: _map_like(value, fn, f"{prefix}{key}/")
            for key, value in tree.items()}
  if _is_sequence(tree):
    return type(tree)(_map_like(value, fn, f"{prefix}{i}/")
                      for i, value in enumerate(tree))
  return fn(prefix[:-1], tree)


def _device(device) -> torch.device:
  """``device`` as a `torch.device`; a CUDA one must exist."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "no CUDA device: the converters build on the card by default; pass "
        "device='cpu' to build on the CPU")
  return device


def _tensor(x, device):
  return torch.as_tensor(np.array(x)).to(device)


def _numpy(x: torch.Tensor) -> np.ndarray:
  return x.detach().cpu().numpy()


def _is_quantized(x) -> bool:
  return hasattr(x, "quantized_dtype")


def _leaf_from_numpy(x, device):
  """A tensor, or a JAX `QuantizedValue` with numpy leaves as the port's."""
  if not _is_quantized(x):
    return _tensor(x, device)
  dtype = getattr(torch, np.dtype(x.quantized_dtype).name)
  opt = lambda t: None if isinstance(t, (list, tuple)) else _tensor(t, device)
  return QuantizedValue(_tensor(x.quantized, device), opt(x.diagonal),
                        opt(x.bucket_size), dtype, bool(x.extract_diagonal),
                        tuple(x.shape))


def _leaf_to_numpy(x, like):
  if isinstance(x, QuantizedValue):
    opt = lambda t, default: default if t is None else _numpy(t)
    return like.replace(quantized=_numpy(x.quantized),
                        diagonal=opt(x.diagonal, like.diagonal),
                        bucket_size=opt(x.bucket_size, like.bucket_size))
  return _numpy(x)


def _is_array(x) -> bool:
  return hasattr(x, "shape")


def _report_from_numpy(cls, node, device):
  """A JAX report as the port's ``cls``, or None for a masked one."""
  fields = [f.name for f in dataclasses.fields(cls)]
  if not _is_array(getattr(node, fields[0], None)):
    return None
  return cls(**{f: _tensor(getattr(node, f), device) for f in fields})


def _metrics_from_numpy(m, device):
  if not hasattr(m, "error"):
    return None
  return RootMetrics(
      **{f: _tensor(getattr(m, f), device) for f in _METRIC_FIELDS},
      **{f: _report_from_numpy(cls, getattr(m, f), device)
         for f, cls in REPORTS.items()})


def _metrics_to_numpy(m: RootMetrics, like):
  out = like.replace(**{f: _numpy(getattr(m, f)) for f in _METRIC_FIELDS})
  for f in REPORTS:
    report = getattr(m, f)
    if report is not None:
      out = out.replace(**{f: getattr(like, f).replace(**{
          g.name: _numpy(getattr(report, g.name))
          for g in dataclasses.fields(report)})})
  return out


def params_from_numpy(tree, device="cuda") -> Dict[str, torch.Tensor]:
  """A tree of numpy arrays (nested dicts, lists and tuples) as the port's
  flat tensor dict."""
  device = _device(device)
  return {path: _tensor(leaf, device) for path, leaf in _flatten(tree)}


def params_to_numpy(params: Dict[str, torch.Tensor]):
  """The port's flat tensor dict as JAX's nested tree of numpy arrays: a
  level whose keys are the indices ``0..n-1`` becomes a list."""
  tree = {}
  for path, value in params.items():
    *parents, leaf = path.split("/")
    node = tree
    for key in parents:
      node = node.setdefault(key, {})
    node[leaf] = _numpy(value)

  def lists(node):
    if not isinstance(node, dict):
      return node
    node = {key: lists(value) for key, value in node.items()}
    if set(node) == {str(i) for i in range(len(node))}:
      return [node[str(i)] for i in range(len(node))]
    return node

  return lists(tree)


def state_from_numpy(state, device="cuda") -> ShampooState:
  """A JAX `ShampooState` with numpy leaves as the port's state.

  Stacked ``[nb, d, d]`` and legacy per-block entries keep their layout;
  `QuantizedValue` leaves become the port's.
  """
  device = _device(device)
  stats = {}
  for path, ps in _flatten(state.stats):
    diag = ps.diagonal_statistics
    stats[path] = ParameterStats(
        diagonal_statistics=(None if isinstance(diag, (list, tuple))
                             else _tensor(diag, device)),
        statistics=[_leaf_from_numpy(s, device) for s in ps.statistics],
        preconditioners=[_leaf_from_numpy(p, device)
                         for p in ps.preconditioners],
        diagonal_momentum=_leaf_from_numpy(ps.diagonal_momentum, device),
        momentum=_leaf_from_numpy(ps.momentum, device),
        avg_grad=(_tensor(ps.avg_grad, device) if _is_array(ps.avg_grad)
                  else None),
        training_metrics=_metrics_from_numpy(ps.training_metrics, device))
  return ShampooState(count=int(state.count), stats=stats)


def state_to_numpy(state: ShampooState, like):
  """The port's state in the structure of a JAX `ShampooState` ``like``.

  ``like`` (numpy leaves, e.g. the JAX state the port's state was made
  from) supplies the classes and the tree; every value comes from
  ``state``.  The result can be fed back to the JAX optimizer.
  """
  def convert(path, like_ps):
    ps = state.stats[path]
    metrics = like_ps.training_metrics
    if ps.training_metrics is not None:
      metrics = _metrics_to_numpy(ps.training_metrics, metrics)
    leaves = lambda xs, likes: [_leaf_to_numpy(x, lk)
                                for x, lk in zip(xs, likes, strict=True)]
    return like_ps._replace(
        diagonal_statistics=(like_ps.diagonal_statistics
                             if ps.diagonal_statistics is None
                             else _numpy(ps.diagonal_statistics)),
        statistics=leaves(ps.statistics, like_ps.statistics),
        preconditioners=leaves(ps.preconditioners, like_ps.preconditioners),
        diagonal_momentum=_leaf_to_numpy(ps.diagonal_momentum,
                                         like_ps.diagonal_momentum),
        momentum=_leaf_to_numpy(ps.momentum, like_ps.momentum),
        avg_grad=(like_ps.avg_grad if ps.avg_grad is None
                  else _numpy(ps.avg_grad)),
        training_metrics=metrics)

  return like._replace(
      count=np.asarray(state.count, dtype=np.asarray(like.count).dtype),
      stats=_map_like(like.stats, convert))


def sharded_state_from_numpy(state, rank: int, world_size: int,
                             device="cuda") -> ShampooState:
  """This rank's port state from a JAX memory-sharded `ShampooState` with
  numpy leaves: rows ``[rank N/k, (rank+1) N/k)`` of the global statistics
  and roots (``k = world_size``, the shard count of the statistics spec,
  ``rank`` this process's shard), every exponent, and the replicated
  per-parameter stats."""
  device = _device(device)
  g = state.stats.global_stats
  n = np.shape(g.statistics)[0]
  if n % world_size:
    raise ValueError(f"{n} global rows do not split over {world_size} ranks")
  rows = slice(rank * (n // world_size), (rank + 1) * (n // world_size))
  local = {}
  for path, ls in _flatten(state.stats.local_stats):
    diag = ls.diagonal_statistics
    local[path] = sharded_shampoo.LocalShardedParameterStats(
        None if isinstance(diag, (list, tuple)) else _tensor(diag, device),
        _leaf_from_numpy(ls.diagonal_momentum, device),
        _leaf_from_numpy(ls.momentum, device),
        _metrics_from_numpy(ls.training_metrics, device),
        int(ls.index_start), [int(d) for d in ls.sizes])
  return ShampooState(count=int(state.count), stats=(
      sharded_shampoo.ShardedShampooStats(
          sharded_shampoo.GlobalShardedParameterStats(
              _tensor(np.asarray(g.statistics)[rows], device),
              _tensor(np.asarray(g.preconditioners)[rows], device),
              _tensor(g.exponents, device)), local)))


def sharded_state_to_numpy(states, like):
  """The ranks' port states (``states``, in shard order) joined into the
  structure of a JAX memory-sharded `ShampooState` ``like``: the global
  rows concatenated, the per-parameter stats from the first rank."""
  first = states[0].stats
  cat = lambda field: np.concatenate(
      [_numpy(getattr(s.stats.global_stats, field)) for s in states])

  def convert(path, like_ls):
    ls = first.local_stats[path]
    metrics = like_ls.training_metrics
    if ls.training_metrics is not None:
      metrics = _metrics_to_numpy(ls.training_metrics, metrics)
    return like_ls.replace(
        diagonal_statistics=(like_ls.diagonal_statistics
                             if ls.diagonal_statistics is None
                             else _numpy(ls.diagonal_statistics)),
        diagonal_momentum=_leaf_to_numpy(ls.diagonal_momentum,
                                         like_ls.diagonal_momentum),
        momentum=_leaf_to_numpy(ls.momentum, like_ls.momentum),
        training_metrics=metrics, index_start=np.int32(ls.index_start),
        sizes=list(ls.sizes))

  like_g = like.stats.global_stats
  return like._replace(
      count=np.asarray(states[0].count, dtype=np.asarray(like.count).dtype),
      stats=like.stats._replace(
          global_stats=like_g.replace(
              statistics=cat("statistics"),
              preconditioners=cat("preconditioners"),
              exponents=_numpy(first.global_stats.exponents)),
          local_stats=_map_like(like.stats.local_stats, convert)))


def sm3_state_from_numpy(state, device="cuda") -> sm3.SM3State:
  """A JAX `SM3State` with numpy leaves as the port's state."""
  device = _device(device)
  return sm3.SM3State(count=int(state.count), stats={
      path: sm3.ParameterStats(
          [_tensor(a, device) for a in ps.diagonal_statistics],
          _leaf_from_numpy(ps.diagonal_momentum, device))
      for path, ps in _flatten(state.stats)})


def sm3_state_to_numpy(state: sm3.SM3State, like):
  """The port's SM3 state in the structure of a JAX `SM3State` ``like``."""
  def convert(path, like_ps):
    ps = state.stats[path]
    return like_ps._replace(
        diagonal_statistics=[_numpy(a) for a in ps.diagonal_statistics],
        diagonal_momentum=_leaf_to_numpy(ps.diagonal_momentum,
                                         like_ps.diagonal_momentum))

  return like._replace(
      count=np.asarray(state.count, dtype=np.asarray(like.count).dtype),
      stats=_map_like(like.stats, convert))


# The tearfree state.  JAX's chain is (grafting, momentum chain, lr):
# grafting is `GraftingState(count, direction, norm)` (or the direction
# alone without grafting), the direction the second-order chain
# (MaskedNode, Shampoo or Sketchy state, MaskedNode), whose trees hold an
# empty `_GraftMask` node for each param left out of preconditioning, and
# optax states elsewhere: the `TraceState` among the momentum chain's,
# Adafactor's `FactoredState` first in its chains, the lr schedule's
# count.  The port keeps the chain's tuple and, inside it, only the states
# that hold values (`tearfree.optimizer`).

def _count(x, like):
  return np.asarray(x, dtype=np.asarray(like).dtype)


def _tearfree_precond_from_numpy(pre, device):
  if hasattr(pre, "blocks"):
    return tf_shampoo.ShampooState(int(pre.count), {
        path: tf_shampoo.AxesBlocks([_tensor(s, device) for s in b.stats],
                                    [_tensor(r, device) for r in b.roots])
        for path, b in _flatten(pre.blocks) if hasattr(b, "stats")})
  fields = [f.name for f in dataclasses.fields(tf_sketchy.AxisState)]
  return tf_sketchy.SketchyState(int(pre.count), {
      path: tf_sketchy.TensorState([tf_sketchy.AxisState(**{
          f: _tensor(getattr(a, f), device) if _is_array(getattr(a, f))
          else None for f in fields}) for a in t.axes])
      for path, t in _flatten(pre.sketches) if hasattr(t, "axes")})


def _tearfree_precond_to_numpy(pre, like):
  if hasattr(like, "blocks"):
    def blocks(path, lk):
      b = pre.blocks.get(path)
      if b is None:
        return lk
      return lk._replace(stats=[_numpy(s) for s in b.stats],
                         roots=[_numpy(r) for r in b.roots])
    return like._replace(count=_count(pre.count, like.count),
                         blocks=_map_like(like.blocks, blocks))

  def sketches(path, lk):
    t = pre.sketches.get(path)
    if t is None:
      return lk
    return lk._replace(axes=[la._replace(**{
        f.name: _numpy(getattr(a, f.name)) for f in dataclasses.fields(a)
        if getattr(a, f.name) is not None}) for a, la in zip(t.axes, lk.axes)])
  return like._replace(count=_count(pre.count, like.count),
                       sketches=_map_like(like.sketches, sketches))


def _factored_from_numpy(fs, device):
  """optax's `FactoredState` as the port's; a param whose ``v_row`` and
  ``v_col`` are both the ``[1]`` placeholders is unfactored."""
  v_row, v_col, v = {}, {}, {}
  for (path, r), (_, c), (_, full) in zip(
      _flatten(fs.v_row), _flatten(fs.v_col), _flatten(fs.v)):
    factored = not (np.shape(r) == (1,) and np.shape(c) == (1,))
    v_row[path] = _tensor(r, device) if factored else None
    v_col[path] = _tensor(c, device) if factored else None
    v[path] = None if factored else _tensor(full, device)
  return tf_grafting.FactoredState(int(fs.count), v_row, v_col, v)


def _has_field(node, name) -> bool:
  """Whether a JAX state node is a NamedTuple with field ``name`` (a plain
  ``hasattr`` also finds tuple methods such as ``count``)."""
  return name in getattr(node, "_fields", ())


def _factored_node(node):
  """The `FactoredState` at the head of Adafactor's nested chains, or
  None."""
  while isinstance(node, tuple) and not _has_field(node, "v_row"):
    node = node[0] if node else None
  return node


def tearfree_state_from_numpy(state, device="cuda"):
  """A JAX tearfree state with numpy leaves as the port's state."""
  device = _device(device)
  graft, mom, lr = state

  def direction(node):
    return _tearfree_precond_from_numpy(node[1], device)

  if hasattr(graft, "norm"):
    norm = graft.norm
    if hasattr(norm, "acc"):
      norm = tf_grafting.RMSPropAccumulator(params_from_numpy(norm.acc,
                                                              device))
    elif _factored_node(norm) is not None:
      norm = _factored_from_numpy(_factored_node(norm), device)
    else:
      norm = None
    graft = tf_grafting.GraftingState(int(graft.count),
                                      direction(graft.direction), norm)
  else:
    graft = direction(graft)
  traces = [s for s in mom if hasattr(s, "trace")]
  mom = (tf_momentum.TraceState(params_from_numpy(traces[0].trace, device))
         if traces else None)
  lr = int(lr.count) if _has_field(lr, "count") else None
  return graft, mom, lr


def _replace_first(node, new):
  """``node`` with the `FactoredState` at the head of its chains replaced."""
  if _has_field(node, "v_row"):
    return new
  return (_replace_first(node[0], new),) + tuple(node[1:])


def tearfree_state_to_numpy(state, like):
  """The port's tearfree state in the structure of a JAX state ``like``."""
  graft, mom, lr = state
  like_graft, like_mom, like_lr = like

  def direction(pre, lk):
    return (lk[0], _tearfree_precond_to_numpy(pre, lk[1]), lk[2])

  def tree(values, lk):
    return _map_like(lk, lambda path, leaf: _numpy(values[path]))

  if hasattr(like_graft, "norm"):
    norm, like_norm = graft.norm, like_graft.norm
    if isinstance(norm, tf_grafting.RMSPropAccumulator):
      like_norm = like_norm._replace(acc=tree(norm.acc, like_norm.acc))
    elif isinstance(norm, tf_grafting.FactoredState):
      fs = _factored_node(like_norm)
      keep = lambda values, lk: _map_like(
          lk, lambda path, leaf: leaf if values[path] is None
          else _numpy(values[path]))
      new = fs._replace(count=_count(norm.count, fs.count),
                        v_row=keep(norm.v_row, fs.v_row),
                        v_col=keep(norm.v_col, fs.v_col),
                        v=keep(norm.v, fs.v))
      like_norm = _replace_first(like_norm, new)
    like_graft = like_graft._replace(
        count=_count(graft.count, like_graft.count),
        direction=direction(graft.direction, like_graft.direction),
        norm=like_norm)
  else:
    like_graft = direction(graft, like_graft)
  like_mom = tuple(s._replace(trace=tree(mom.trace, s.trace))
                   if hasattr(s, "trace") else s for s in like_mom)
  if lr is not None:
    like_lr = like_lr._replace(count=_count(lr, like_lr.count))
  return like_graft, like_mom, like_lr
