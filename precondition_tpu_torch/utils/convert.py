"""Moves parameters and Shampoo state between the JAX package and the port.

Both directions go through numpy, so nothing here imports JAX: a JAX tree
is handed over as the same tree with numpy leaves
(``jax.tree.map(np.asarray, tree)``).  Nested dicts flatten to the port's
flat ``{"a/b": tensor}`` dicts in JAX's flattening order (sorted keys).
Both state layouts travel, as do `QuantizedValue` leaves, packed
low-rank and frequent-directions roots, the FD gradient average and every
report of the metrics (LOBPCG, the residuals of the root and of the
deflated problem, FD); a report JAX masks is None in the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from precondition_tpu_torch.ops.pth_root import REPORTS, RootMetrics
from precondition_tpu_torch.optim.shampoo import ParameterStats, ShampooState
from precondition_tpu_torch.utils.quantization import QuantizedValue

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


def params_from_numpy(tree, device=None) -> Dict[str, torch.Tensor]:
  """A (nested-dict) tree of numpy arrays as the port's flat tensor dict."""
  return {path: _tensor(leaf, device) for path, leaf in _flatten(tree)}


def state_from_numpy(state, device=None) -> ShampooState:
  """A JAX `ShampooState` with numpy leaves as the port's state.

  Stacked ``[nb, d, d]`` and legacy per-block entries keep their layout;
  `QuantizedValue` leaves become the port's.
  """
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
