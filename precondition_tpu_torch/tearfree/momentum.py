"""Momentum and weight decay for the tearfree stack.

PyTorch counterpart of `precondition_tpu/tearfree/momentum.py`, whose chain
of optax stages (``scale(1 - decay)`` when ``ema``, ``trace(decay,
nesterov)``, ``add_decayed_weights``) is written out here as one stage.
With ``u`` the incoming update and ``v`` the velocity:

* ``ema``: ``u <- (1 - decay) u`` first;
* trace: ``v <- u + decay v``; the update is ``v``, or ``u + decay v``
  (the new ``v``) with ``nesterov``;
* weight decay adds ``weight_decay * param``, after the momentum or
  before it (``weight_decay_after_momentum``).

The state is `TraceState` (one velocity per param), or None when
``momentum_decay`` is 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from precondition_tpu_torch.optim.shampoo import GradientTransformation


@dataclasses.dataclass
class Options:
  """Momentum options.

  Attributes:
    ema: if true, velocity is an exponential moving average
      ``v' = decay * v + (1-decay) * u``; else trace accumulation
      ``v' = decay * v + u``.
    nesterov: look-ahead correction; the emitted update becomes
      ``maybe_decay * u + decay * v'`` with ``maybe_decay = (1-decay)`` when
      ``ema`` else 1.
    momentum_decay: the decay above.
    weight_decay: adds ``weight_decay * param`` to the update.
    weight_decay_after_momentum: whether the decay term bypasses the
      velocity accumulator (AdamW-style) or feeds it.
  """

  ema: bool = False
  nesterov: bool = True
  momentum_decay: float = 0.9
  weight_decay: float = 0.0
  weight_decay_after_momentum: bool = True


@dataclasses.dataclass
class TraceState:
  trace: Dict[str, torch.Tensor]


def _validate(options: Options):
  if not 0 <= options.momentum_decay <= 1:
    raise ValueError(
        f"momentum_decay ({options.momentum_decay}) must be in [0, 1]")
  if options.weight_decay < 0:
    raise ValueError(f"weight_decay ({options.weight_decay}) must be >= 0")


def apply(options: Options) -> GradientTransformation:
  """Build the momentum/weight-decay transform."""
  _validate(options)
  decay = options.momentum_decay
  wd = options.weight_decay

  def init_fn(params):
    if not decay:
      return None
    return TraceState({n: torch.zeros_like(p) for n, p in params.items()})

  def add_weight_decay(updates, params):
    if params is None:
      raise ValueError("weight decay needs the params")
    return {n: u + wd * params[n] for n, u in updates.items()}

  def update_fn(updates, state, params=None):
    if wd > 0.0 and not options.weight_decay_after_momentum:
      updates = add_weight_decay(updates, params)
    if decay:
      if options.ema:
        updates = {n: u * (1 - decay) for n, u in updates.items()}
      trace = {n: u + decay * state.trace[n] for n, u in updates.items()}
      if options.nesterov:
        updates = {n: u + decay * trace[n] for n, u in updates.items()}
      else:
        updates = trace
      state = TraceState(trace)
    if wd > 0.0 and options.weight_decay_after_momentum:
      updates = add_weight_decay(updates, params)
    return updates, state

  return GradientTransformation(init_fn, update_fn)
