"""SM3: memory-efficient adaptive optimization with cover-set accumulators.

PyTorch counterpart of `precondition_tpu/optim/sm3.py` (Anil, Gupta, Koren,
Singer, https://arxiv.org/abs/1901.11150).  A tensor of shape
``[d0, ..., dk]`` keeps one 1-D accumulator per axis, ``sum(d_i)`` floats
instead of ``prod(d_i)``.  The second moment of entry ``(i0..ik)`` is the
*min* over its covering accumulators; after the update each accumulator is
re-sketched as the *max* of the dense statistic over the other axes.  The
momentum is stored as an int8 `QuantizedValue`.

Parameters are a flat dict of name -> tensor, as in `optim/shampoo.py`; the
step count is a Python int.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import torch

from precondition_tpu_torch.optim.shampoo import GradientTransformation
from precondition_tpu_torch.utils.quantization import QuantizedValue


@dataclasses.dataclass
class ParameterStats:
  """Per-parameter SM3 state."""
  diagonal_statistics: List[torch.Tensor]  # one accumulator per axis
  diagonal_momentum: QuantizedValue        # int8 momentum


@dataclasses.dataclass
class SM3State:
  count: int
  stats: Dict[str, ParameterStats]


def _quantize_momentum(m: torch.Tensor) -> QuantizedValue:
  return QuantizedValue.from_float_value(m, torch.int8)


def _expand(acc: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
  """A 1-D accumulator shaped to broadcast along every other axis."""
  view = [1] * ndim
  view[axis] = acc.shape[0]
  return acc.reshape(view)


def sm3(
    learning_rate,
    beta1: float = 0.9,
    beta2: float = 0.999,
    diagonal_epsilon: float = 1e-10,
    weight_decay: float = 0.0,
    normalize_grads: bool = False,
) -> GradientTransformation:
  """The SM3 optimizer as an ``init``/``update`` pair.

  Args:
    learning_rate: step size, or a schedule ``step -> lr`` called with the
      count before this update.
    beta1: momentum decay.
    beta2: second-moment decay (1.0 accumulates, AdaGrad-style).
    diagonal_epsilon: added inside the rsqrt.
    weight_decay: coupled weight decay added to the momentum-smoothed
      update, only when ``params`` is given.
    normalize_grads: divide each gradient tensor by its norm first.
  """
  w1 = (1.0 - beta1) if beta1 != 1.0 else 1.0
  w2 = (1.0 - beta2) if beta2 != 1.0 else 1.0

  def init_fn(params) -> SM3State:
    return SM3State(count=0, stats={
        name: ParameterStats(
            [torch.zeros(d, dtype=torch.float32, device=p.device)
             for d in p.shape],
            _quantize_momentum(torch.zeros_like(p)))
        for name, p in params.items()})

  def _second_moment(grad, stats: ParameterStats):
    """``beta2 * min-over-cover + w2 * g^2``, dense."""
    accs = stats.diagonal_statistics
    if grad.dim() < 2:
      cover = accs[0]
    else:
      cover = functools.reduce(
          torch.minimum, [_expand(a, grad.dim(), i) for i, a in
                          enumerate(accs)])
    return beta2 * cover + w2 * grad ** 2

  def _resketch(dense):
    """The dense statistic collapsed to per-axis max accumulators."""
    if dense.dim() == 1:
      return [dense]
    return [dense.amax(dim=tuple(a for a in range(dense.dim()) if a != i))
            for i in range(dense.dim())]

  @torch.no_grad()
  def update_fn(updates, state: SM3State, params=None):
    lr = (learning_rate(state.count) if callable(learning_rate)
          else learning_rate)
    new_updates, new_stats = {}, {}
    for name, grad in updates.items():
      if normalize_grads:
        grad = grad / (torch.linalg.vector_norm(grad) + 1e-16)
      stats = state.stats[name]
      dense = _second_moment(grad, stats)
      precond = grad * torch.rsqrt(dense + diagonal_epsilon)
      momentum = beta1 * stats.diagonal_momentum.to_float() + w1 * precond
      new_stats[name] = ParameterStats(_resketch(dense),
                                       _quantize_momentum(momentum))
      if weight_decay > 0.0 and params is not None:
        momentum = momentum + weight_decay * params[name]
      new_updates[name] = -lr * momentum
    return new_updates, SM3State(count=state.count + 1, stats=new_stats)

  return GradientTransformation(init_fn, update_fn)
