"""Moves parameters and Shampoo state between the JAX package and the port.

Both directions go through numpy, so nothing here imports JAX: a JAX tree
is handed over as the same tree with numpy leaves
(``jax.tree.map(np.asarray, tree)``).  Nested dicts flatten to the port's
flat ``{"a/b": tensor}`` dicts in JAX's flattening order (sorted keys).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from precondition_tpu_torch.ops.pth_root import RootMetrics
from precondition_tpu_torch.optim.shampoo import ParameterStats, ShampooState

_METRIC_FIELDS = ("error", "iterations", "error_ratio", "max_eigenvalue",
                  "retries")


def _flatten(tree, prefix="") -> List[Tuple[str, Any]]:
  if isinstance(tree, dict):
    out = []
    for key in sorted(tree):
      out += _flatten(tree[key], f"{prefix}{key}/")
    return out
  return [(prefix[:-1], tree)]


def _map_like(tree, fn, prefix=""):
  """Rebuilds the nested-dict structure of ``tree`` with ``fn(path, leaf)``."""
  if isinstance(tree, dict):
    return {key: _map_like(value, fn, f"{prefix}{key}/")
            for key, value in tree.items()}
  return fn(prefix[:-1], tree)


def _tensor(x, device):
  return torch.as_tensor(np.array(x)).to(device)


def _numpy(x: torch.Tensor) -> np.ndarray:
  return x.detach().cpu().numpy()


def params_from_numpy(tree, device=None) -> Dict[str, torch.Tensor]:
  """A (nested-dict) tree of numpy arrays as the port's flat tensor dict."""
  return {path: _tensor(leaf, device) for path, leaf in _flatten(tree)}


def state_from_numpy(state, device=None) -> ShampooState:
  """A JAX `ShampooState` with numpy leaves as the port's state.

  The JAX state must use the stacked layout (the default mode's layout
  for params with uniform blocks).
  """
  stats = {}
  for path, ps in _flatten(state.stats):
    metrics = None
    if hasattr(ps.training_metrics, "error"):
      metrics = RootMetrics(**{
          f: _tensor(getattr(ps.training_metrics, f), device)
          for f in _METRIC_FIELDS})
    diag = ps.diagonal_statistics
    stats[path] = ParameterStats(
        diagonal_statistics=(None if isinstance(diag, (list, tuple))
                             else _tensor(diag, device)),
        statistics=[_tensor(s, device) for s in ps.statistics],
        preconditioners=[_tensor(p, device) for p in ps.preconditioners],
        diagonal_momentum=_tensor(ps.diagonal_momentum, device),
        momentum=_tensor(ps.momentum, device),
        training_metrics=metrics)
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
      metrics = metrics.replace(**{
          f: _numpy(getattr(ps.training_metrics, f)) for f in _METRIC_FIELDS})
    return like_ps._replace(
        diagonal_statistics=(like_ps.diagonal_statistics
                             if ps.diagonal_statistics is None
                             else _numpy(ps.diagonal_statistics)),
        statistics=[_numpy(s) for s in ps.statistics],
        preconditioners=[_numpy(p) for p in ps.preconditioners],
        diagonal_momentum=_numpy(ps.diagonal_momentum),
        momentum=_numpy(ps.momentum),
        training_metrics=metrics)

  return like._replace(
      count=np.asarray(state.count, dtype=np.asarray(like.count).dtype),
      stats=_map_like(like.stats, convert))
