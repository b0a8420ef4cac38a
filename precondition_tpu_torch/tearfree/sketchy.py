"""Sketchy: frequent-directions low-rank covariance sketching.

PyTorch counterpart of `precondition_tpu/tearfree/sketchy.py` (Feinberg et
al., https://arxiv.org/abs/2302.03764).  Per tensor axis it tracks a
rank-``k`` sketch ``(eigvecs [d, k], eigvals [k])`` of the square root of
the gradient covariance and a scalar ``tail`` of escaped mass.  An update:

1. scales the sketch by its eigenvalues and ``sqrt(decay)`` and appends
   the unrolled gradient matrix ``[d, m]``;
2. QR-reduces the result, then takes its SVD; a member with a non-finite
   entry gets NaN outputs (`pth_root.nan_safe`) where LAPACK under JAX
   returns them and torch would raise;
3. deflates by the (k+1)-th singular value and accumulates the escaped
   mass into ``tail``, or extrapolates it from the eigenvalues' log-log
   slope (``linear_approx_tail``);
4. inverts the shifted spectrum to the ``-1/(2 ndim)`` power.

Preconditioning applies the low-rank factor plus ``inv_tail`` times the
orthogonal complement, axis by axis.  Options: per-layer ranks
(``memory_alloc``, a nested dict that the param's name, split at "/",
walks), the exact EMA of ``G G^T`` (``add_ggt``), and the EKFAC-SVD
variant (the preconditioner refreshed every step even when the sketch is
frozen).  Each axis's QR and SVD is one library call; the update
frequency is a host ``if`` on the Python-int step count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.optim.shampoo import GradientTransformation


@dataclasses.dataclass
class Options:
  """Sketchy options (see the module docstring).

  Attributes:
    epsilon: diagonal perturbation added before inversion.
    rank: FD sketch size per tensor axis.
    relative_epsilon: scale epsilon by the top eigenvalue.
    second_moment_decay: EMA decay of the sketched covariance (1.0 = sum).
    update_freq: steps between sketch updates.
    add_ggt: also track the exact EMA of G G^T (diagnostics).
    memory_alloc: optional per-layer nested dict name -> [rank per axis].
    ekfac_svd: use the EKFAC-SVD preconditioner (refreshed every step).
    linear_approx_tail: estimate the tail from a log-log linear fit of the
      eigenvalue decay instead of accumulating deflated mass.
  """

  epsilon: float = 1e-7
  rank: int = 128
  relative_epsilon: bool = True
  second_moment_decay: float = 0.999
  update_freq: int = 1
  add_ggt: bool = False
  memory_alloc: Optional[dict] = None
  ekfac_svd: bool = False
  linear_approx_tail: bool = False


def _validate(options: Options) -> None:
  if options.update_freq <= 0:
    raise ValueError(f"update_freq ({options.update_freq}) must be positive")
  if not 0 <= options.second_moment_decay <= 1:
    raise ValueError(
        f"second_moment_decay ({options.second_moment_decay}) "
        "should be in [0, 1]")
  if options.rank <= 0:
    raise ValueError(f"rank ({options.rank}) must be at least 1")


@dataclasses.dataclass
class AxisState:
  """Sketch state of one tensor axis; the EKFAC and GGT fields are None
  unless their option is on."""
  eigvecs: torch.Tensor                  # [d, k] basis of the covariance sqrt
  eigvals: torch.Tensor                  # [k] eigenvalues of the sqrt
  inv_eigvals: torch.Tensor              # [k] -(1/2 ndim) root
  tail: torch.Tensor                     # [] escaped mass
  inv_tail: torch.Tensor                 # [] its -(1/2 ndim) root
  ema_ggt: Optional[torch.Tensor]        # [d, d] if add_ggt
  svd_result_u: Optional[torch.Tensor]   # [d, m] if ekfac_svd
  svd_result_s: Optional[torch.Tensor]   # [m] if ekfac_svd
  inv_prev_tail: Optional[torch.Tensor]  # [] if ekfac_svd


@dataclasses.dataclass
class TensorState:
  axes: List[AxisState]


@dataclasses.dataclass
class SketchyState:
  count: int
  sketches: Dict[str, TensorState]


def _axis_rank(options: Options, name: str, dim: int, d: int) -> int:
  if options.memory_alloc:
    ranks = options.memory_alloc
    for key in name.split("/"):
      ranks = ranks[key]
    if not isinstance(ranks, list):
      raise ValueError(f"memory_alloc of {name} is not a list of ranks")
    return min(d, ranks[dim])
  return min(d, options.rank)


def _init(options: Options, params) -> SketchyState:
  sketches = {}
  for name, param in params.items():
    total = param.numel()
    dev = param.device
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=dev)
    axes = []
    for i, d in enumerate(param.shape):
      if d == 1:
        raise ValueError(
            f"param {name} shape ({list(param.shape)}) has unit dimensions")
      k = _axis_rank(options, name, i, d)
      m = min(d, k + (total // d if d else 0))
      axes.append(AxisState(
          eigvecs=zeros(d, k), eigvals=zeros(k), inv_eigvals=zeros(k),
          tail=zeros(), inv_tail=zeros(),
          ema_ggt=zeros(d, d) if options.add_ggt else None,
          svd_result_u=zeros(d, m) if options.ekfac_svd else None,
          svd_result_s=zeros(m) if options.ekfac_svd else None,
          inv_prev_tail=zeros() if options.ekfac_svd else None))
    sketches[name] = TensorState(axes)
  return SketchyState(count=0, sketches=sketches)


def _safe_svd(x: torch.Tensor):
  """``(u, s)`` of a reduced SVD; all NaN for a non-finite operand."""
  return pth_root.nan_safe(
      lambda y: torch.linalg.svd(y, full_matrices=False)[:2], x[None])


def _linear_tail(axis_state: AxisState, k: int, d: int) -> torch.Tensor:
  """Escaped mass extrapolated from the log-log eigenvalue decay slope."""
  num_points = (k + 1) // 2
  vals = axis_state.eigvals[:num_points]
  ranks = torch.arange(1, num_points + 1, dtype=vals.dtype,
                       device=vals.device)
  if num_points > 1:
    # jnp.cov(ranks, vals) with one degree of freedom removed; JAX's
    # "s_x > 0" holds exactly when there are two points or more.
    dr, dv = ranks - ranks.mean(), vals - vals.mean()
    s_x = (dr * dr).sum() / (num_points - 1)
    s_xy = (dr * dv).sum() / (num_points - 1)
    slope = s_xy / s_x ** 2
  else:
    slope = torch.zeros((), dtype=vals.dtype, device=vals.device)
  intercept = vals.mean() - slope * ranks.mean()
  log_ranks = torch.log(torch.arange(k + 1, d + 1, dtype=vals.dtype,
                                     device=vals.device))
  fitted = slope * log_ranks + intercept
  return torch.exp(torch.logsumexp(fitted * 2, dim=0)) / (d - k)


def _update_axis(options: Options, dim: int, name: str, update,
                 axis_state: AxisState,
                 update_sketches: bool = True) -> AxisState:
  """One FD sketch-and-invert step for one tensor axis."""
  d = update.shape[dim]
  k = _axis_rank(options, name, dim, d)
  weighted_sketch = axis_state.eigvecs * axis_state.eigvals[None, :]
  g_dm = update.movedim(dim, 0).reshape(d, -1)
  decay = torch.sqrt(torch.tensor(options.second_moment_decay,
                                  dtype=torch.float32))
  decay = decay.to(update.device)

  concat = torch.cat([weighted_sketch * decay, g_dm], dim=1)
  # QR first, a mathematical no-op that keeps the SVD operand about
  # [d, d] where the gradient matrix is wide.
  reduced = torch.linalg.qr(concat.T, mode="r")[1].T
  u, s = (x[0] for x in _safe_svd(reduced))

  cutoff = torch.clamp(s[k], min=0.0) if k < s.shape[0] else 0.0
  top = torch.clamp(s[:k], min=0.0)
  deflated = torch.sqrt(torch.clamp(top - cutoff, min=0.0)) * torch.sqrt(
      top + cutoff)
  if options.linear_approx_tail and d > k:
    tail = _linear_tail(axis_state, k, d)
    undeflated = torch.square(top)
  else:
    tail = axis_state.tail * decay + cutoff ** 2
    # undeflated == deflated^2 + tail exactly; avoid the subtract/re-add.
    undeflated = torch.square(top) + axis_state.tail * decay

  mask = deflated > 0
  eigvecs = u[:, :k] * mask
  alpha = -1.0 / (2 * update.dim())
  if options.relative_epsilon and options.epsilon > 0:
    eps = torch.amax(undeflated) * options.epsilon
  else:
    eps = options.epsilon
  inv_eigvals = torch.where(mask, (undeflated + eps) ** alpha, 0.0)
  eigvals = deflated * mask
  inv_tail = torch.where(tail > 0, (tail + eps) ** alpha, 0.0)

  ema_ggt = axis_state.ema_ggt
  if options.add_ggt:
    ema_ggt = ema_ggt * decay + (g_dm @ g_dm.T) * (1 - decay)

  svd_result_u = axis_state.svd_result_u
  svd_result_s = axis_state.svd_result_s
  inv_prev_tail = axis_state.inv_prev_tail
  if options.ekfac_svd:
    # EKFAC keeps the full current SVD basis for preconditioning, with the
    # previous step's tail (the sketch may be frozen between updates).
    undeflated_ekfac = (torch.square(torch.clamp(s, min=0.0))
                        + axis_state.tail * decay)
    svd_result_u = u
    svd_result_s = torch.where(undeflated_ekfac > 0,
                               (undeflated_ekfac + eps) ** alpha, 0.0)
    inv_prev_tail = axis_state.inv_tail

  if not update_sketches:
    # Only the EKFAC preconditioner refreshes; the sketch stays frozen.
    eigvecs, eigvals = axis_state.eigvecs, axis_state.eigvals
    inv_eigvals = axis_state.inv_eigvals
    tail, inv_tail = axis_state.tail, axis_state.inv_tail
  return AxisState(eigvecs, eigvals, inv_eigvals, tail, inv_tail, ema_ggt,
                   svd_result_u, svd_result_s, inv_prev_tail)


def _precondition(options: Options, name: str, update,
                  sketches: TensorState) -> torch.Tensor:
  """Low-rank plus tail-complement preconditioning, axis by axis."""
  g = update
  shape = g.shape
  roll = tuple(range(1, g.dim())) + (0,)
  ekfac = options.ekfac_svd
  for dim, axis_state in enumerate(sketches.axes):
    eigvecs = axis_state.svd_result_u if ekfac else axis_state.eigvecs
    basis = torch.tensordot(g, eigvecs, dims=([0], [0]))
    lowrank = torch.tensordot(basis, eigvecs, dims=([g.dim() - 1], [1]))
    g = g.permute(roll)
    complement = g - lowrank
    inv_eigvals = (axis_state.svd_result_s if ekfac
                   else axis_state.inv_eigvals)
    scaled = torch.tensordot(basis * inv_eigvals, eigvecs,
                             dims=([g.dim() - 1], [1]))
    inv_tail = axis_state.inv_prev_tail if ekfac else axis_state.inv_tail
    g = scaled + inv_tail * complement
  if tuple(g.shape) != tuple(shape):
    raise ValueError(f"preconditioned {list(g.shape)}, expected "
                     f"{list(shape)}")
  return g


def apply(options: Options) -> GradientTransformation:
  """Sketchy gradient transformation."""
  _validate(options)

  def update_fn(updates, state: SketchyState, params=None):
    del params
    should_update = state.count % options.update_freq == 0
    sketches = dict(state.sketches)
    out = {}
    for name, update in updates.items():
      if should_update or options.ekfac_svd:
        sketches[name] = TensorState([
            _update_axis(options, dim, name, update, axis_state,
                         should_update)
            for dim, axis_state in enumerate(sketches[name].axes)])
      out[name] = _precondition(options, name, update, sketches[name])
    return out, SketchyState(count=state.count + 1, sketches=sketches)

  return GradientTransformation(lambda params: _init(options, params),
                                update_fn)
