"""Grafting: borrow a first-order optimizer's step size per layer.

PyTorch counterpart of `precondition_tpu/tearfree/grafting.py`.  A cheap
"norm" optimizer (SGD, RMSProp or Adafactor) runs beside the second-order
"direction" update, and the direction is rescaled to the norm optimizer's
magnitude per tensor.  Before ``start_preconditioning_step`` the norm
update is used as it is.  Tensors where preconditioning is skipped (rank
<= 1, or a dim above ``skip_preconditioning_any_dim_gt``) are left out of
the direction optimizer: its params and updates are the dicts without
them, where JAX puts an empty `_GraftMask` node in their place.

Adafactor is optax's ``adafactor`` (factored second moments with the
step-dependent decay ``1 - (t + 1)^(-decay)``, block-RMS clipping and the
parameter-scale multiplier) with its sign flipped back to ascent, carried
here as the port's own code.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional

import numpy as np
import torch

from precondition_tpu_torch.optim.shampoo import GradientTransformation


@enum.unique
class GraftingType(enum.Enum):
  NONE = "none"
  SGD = "sgd"
  RMSPROP = "rmsprop"
  ADAFACTOR = "adafactor"


@dataclasses.dataclass
class Options:
  """Grafting options.

  Attributes:
    grafting_type: which optimizer supplies the update norm.
    second_moment_decay: RMSProp/Adafactor second-moment decay; 1.0 makes
      RMSProp a running sum (AdaGrad); must be 0 for SGD/NONE.
    start_preconditioning_step: before this step the grafting update is used
      as-is.
    epsilon: rsqrt regulariser for RMSProp/Adafactor.
    skip_preconditioning_any_dim_gt: skip second-order for tensors with any
      dim above this.
    skip_preconditioning_rank1: skip second-order for rank<=1 tensors.
    min_dim_size_to_factor: (Adafactor) only factor axes at least this long.
    multiply_by_parameter_scale: (Adafactor) relative step sizing.
    clipping_threshold: (Adafactor) update clipping, >= 1.
  """

  grafting_type: GraftingType = GraftingType.RMSPROP
  second_moment_decay: float = 0.999
  start_preconditioning_step: int = 0
  epsilon: float = 1e-23
  skip_preconditioning_any_dim_gt: int = 4096
  skip_preconditioning_rank1: bool = True
  min_dim_size_to_factor: int = 128
  multiply_by_parameter_scale: float = True
  clipping_threshold: float = 1.0


def _validate(options: Options):
  if options.grafting_type in (GraftingType.RMSPROP, GraftingType.ADAFACTOR):
    if options.epsilon < 0:
      raise ValueError(f"epsilon ({options.epsilon}) should be non-negative")
  if options.grafting_type == GraftingType.RMSPROP:
    if not 0 < options.second_moment_decay <= 1.0:
      raise ValueError(
          f"second_moment_decay ({options.second_moment_decay}) not in "
          f"(0, 1] for graft ({options.grafting_type})")
  if options.grafting_type == GraftingType.ADAFACTOR:
    if not 0 < options.second_moment_decay < 1.0:
      raise ValueError(
          f"second_moment_decay ({options.second_moment_decay}) not in "
          f"(0, 1) for graft ({options.grafting_type})")
    if options.min_dim_size_to_factor <= 0:
      raise ValueError(
          f"min_dim_size_to_factor ({options.min_dim_size_to_factor}) "
          "should be positive")
    if options.clipping_threshold < 1:
      raise ValueError(
          f"clipping_threshold ({options.clipping_threshold}) should be >= 1")


def _skipped(options: Options, x: torch.Tensor) -> bool:
  if options.skip_preconditioning_rank1 and x.dim() <= 1:
    return True
  return any(s > options.skip_preconditioning_any_dim_gt for s in x.shape)


def _mask_skipped(options: Options, tree):
  """``tree`` without the tensors that skip preconditioning."""
  if tree is None:
    return None
  return {n: x for n, x in tree.items() if not _skipped(options, x)}


def _sgd() -> GradientTransformation:
  return GradientTransformation(lambda _: None,
                                lambda updates, state, params=None:
                                (updates, state))


@dataclasses.dataclass
class RMSPropAccumulator:
  acc: Dict[str, torch.Tensor]


def _rmsprop(options: Options) -> GradientTransformation:
  """RMSProp (AdaGrad at decay 1.0) norm optimizer."""
  decay = options.second_moment_decay

  def init_fn(params):
    return RMSPropAccumulator({n: torch.zeros_like(p)
                               for n, p in params.items()})

  def update_fn(updates, state, params=None):
    del params
    acc, out = {}, {}
    for n, g in updates.items():
      g2 = torch.square(g)
      prev = state.acc[n]
      acc[n] = g2 + prev if decay == 1.0 else g2 * (1 - decay) + decay * prev
      out[n] = g * torch.rsqrt(acc[n] + options.epsilon)
    return out, RMSPropAccumulator(acc)

  return GradientTransformation(init_fn, update_fn)


@dataclasses.dataclass
class FactoredState:
  """optax's `FactoredState`: per param, factored row and column moments
  (``v_row``, ``v_col``) or a full one (``v``); an entry a param does not
  use is None where optax keeps a ``[1]`` placeholder."""
  count: int
  v_row: Dict[str, Optional[torch.Tensor]]
  v_col: Dict[str, Optional[torch.Tensor]]
  v: Dict[str, Optional[torch.Tensor]]


def _factored_dims(shape, min_dim_size_to_factor):
  """The two largest axes ``(d1, d0)``, ``d0`` the largest, when the
  second largest is at least ``min_dim_size_to_factor``; else None."""
  if len(shape) < 2:
    return None
  sorted_dims = np.argsort(shape)
  if shape[sorted_dims[-2]] < min_dim_size_to_factor:
    return None
  return int(sorted_dims[-2]), int(sorted_dims[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
  return torch.sqrt(torch.mean(torch.square(x)))


def _adafactor(options: Options) -> GradientTransformation:
  """optax ``adafactor(min_dim_size_to_factor, decay_rate, eps,
  multiply_by_parameter_scale, clipping_threshold)`` then ``scale(-1)``:
  the two sign flips cancel, so neither is applied."""
  decay_rate = options.second_moment_decay
  eps = options.epsilon
  min_dim = options.min_dim_size_to_factor

  def init_fn(params):
    v_row, v_col, v = {}, {}, {}
    for n, p in params.items():
      dims = _factored_dims(p.shape, min_dim)
      v_row[n] = v_col[n] = v[n] = None
      if dims is None:
        v[n] = torch.zeros_like(p)
      else:
        d1, d0 = dims
        v_row[n] = torch.zeros_like(p.select(d0, 0))
        v_col[n] = torch.zeros_like(p.select(d1, 0))
    return FactoredState(0, v_row, v_col, v)

  def update_fn(updates, state, params=None):
    if params is None:
      raise ValueError("adafactor grafting needs the params")
    # optax's `_decay_rate_pow`, in f32 as optax computes it.
    t = torch.tensor(float(state.count + 1), dtype=torch.float32)
    decay_t = 1.0 - t ** (-decay_rate)
    out = {}
    v_row, v_col, v = dict(state.v_row), dict(state.v_col), dict(state.v)
    for n, g in updates.items():
      decay = decay_t.to(g.device)
      grad_sqr = torch.square(g) + eps
      dims = _factored_dims(g.shape, min_dim)
      if dims is not None:
        d1, d0 = dims
        v_row[n] = decay * state.v_row[n] + (1.0 - decay) * grad_sqr.mean(d0)
        v_col[n] = decay * state.v_col[n] + (1.0 - decay) * grad_sqr.mean(d1)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = v_row[n].mean(dim=reduced_d1, keepdim=True)
        row_factor = (v_row[n] / row_col_mean) ** -0.5
        col_factor = v_col[n] ** -0.5
        u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
      else:
        v[n] = decay * state.v[n] + (1.0 - decay) * grad_sqr
        u = g * v[n] ** -0.5
      # clip_by_block_rms(clipping_threshold)
      u = u / torch.clamp(_rms(u) / options.clipping_threshold, min=1.0)
      if options.multiply_by_parameter_scale:
        # scale_by_param_block_rms(min_scale=1e-3)
        rms = _rms(params[n])
        u = u * torch.where(rms <= 1e-3, 1e-3, rms)
      out[n] = u
    return out, FactoredState(state.count + 1, v_row, v_col, v)

  return GradientTransformation(init_fn, update_fn)


@dataclasses.dataclass
class GraftingState:
  count: int
  direction: Any
  norm: Any


def _graft_with(direction: GradientTransformation,
                norm: GradientTransformation,
                options: Options) -> GradientTransformation:
  """Combine direction and norm transforms into the grafted update."""

  def mask(tree):
    return _mask_skipped(options, tree)

  def init_fn(params):
    return GraftingState(count=0, direction=direction.init(mask(params)),
                         norm=norm.init(params))

  def update_fn(updates, state, params=None):
    dir_updates, dir_state = direction.update(
        mask(updates), state.direction, mask(params))
    norm_updates, norm_state = norm.update(updates, state.norm, params)
    new_state = GraftingState(count=state.count + 1, direction=dir_state,
                              norm=norm_state)
    if state.count < options.start_preconditioning_step:
      return norm_updates, new_state
    out = {}
    for n, norm_upd in norm_updates.items():
      if n not in dir_updates:
        out[n] = norm_upd
        continue
      dir_upd = dir_updates[n]
      dir_norm = torch.linalg.vector_norm(dir_upd)
      multiplier = torch.where(
          dir_norm > 0.0, torch.linalg.vector_norm(norm_upd) / dir_norm, 0.0)
      out[n] = dir_upd * multiplier
    return out, new_state

  return GradientTransformation(init_fn, update_fn)


def graft(options: Options,
          direction: GradientTransformation) -> GradientTransformation:
  """Wrap ``direction`` with the configured grafting optimizer."""
  _validate(options)
  if options.grafting_type == GraftingType.NONE:
    return direction
  if options.grafting_type == GraftingType.SGD:
    return _graft_with(direction, _sgd(), options)
  if options.grafting_type == GraftingType.RMSPROP:
    return _graft_with(direction, _rmsprop(options), options)
  if options.grafting_type == GraftingType.ADAFACTOR:
    return _graft_with(direction, _adafactor(options), options)
  raise NotImplementedError(options.grafting_type)
