"""Tearfree optimizer: graft(second order) -> momentum -> learning rate.

PyTorch counterpart of `precondition_tpu/tearfree/optimizer.py`.  One
momentum buffer serves both the grafting and the preconditioned update,
and the learning rate is applied last.  The state is the chain's tuple
``(grafting state, momentum state, lr state)``; the lr state is the
schedule's own step count (from 0), or None for a constant rate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from precondition_tpu_torch.optim.shampoo import GradientTransformation
from precondition_tpu_torch.tearfree import grafting
from precondition_tpu_torch.tearfree import momentum
from precondition_tpu_torch.tearfree import praxis_shim
from precondition_tpu_torch.tearfree import second_order


@dataclasses.dataclass
class TearfreeOptions:
  """Bundle of the three stage configs."""

  grafting_options: grafting.Options = dataclasses.field(
      default_factory=grafting.Options)
  second_order_options: second_order.Options = dataclasses.field(
      default_factory=second_order.Options)
  momentum_options: momentum.Options = dataclasses.field(
      default_factory=momentum.Options)


def _lr_stage(learning_rate) -> GradientTransformation:
  """``-lr * u``; a schedule is called with the stage's own count."""
  if not callable(learning_rate):
    step = -1.0 * learning_rate
    return GradientTransformation(
        lambda _: None,
        lambda updates, state, params=None: (
            {n: u * step for n, u in updates.items()}, state))

  def update_fn(updates, count, params=None):
    step = -1.0 * learning_rate(count)
    return {n: u * step for n, u in updates.items()}, count + 1

  return GradientTransformation(lambda _: 0, update_fn)


def tearfree(learning_rate: Union[float, Callable[[int], float]],
             options: TearfreeOptions) -> GradientTransformation:
  """Build the full tearfree optimizer chain.

  Args:
    learning_rate: value or schedule; applied last (decoupled).
    options: stage options.

  Returns:
    A transformation producing ``-lr *`` the grafted, preconditioned,
    momentum-smoothed update; its ``update`` runs without autograd, so
    params that require grad may be passed as they are.
  """
  second_order_tx = second_order.apply(options.second_order_options)
  graft_tx = grafting.graft(options.grafting_options, second_order_tx)
  momentum_tx = momentum.apply(options.momentum_options)
  chain = praxis_shim.sharded_chain(graft_tx, momentum_tx,
                                    _lr_stage(learning_rate))
  return GradientTransformation(chain.init, torch.no_grad()(chain.update))
