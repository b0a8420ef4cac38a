"""Second-order statistics: blocked Shampoo or Sketchy, between reshapes.

PyTorch counterpart of `precondition_tpu/tearfree/second_order.py`: merge
(and, for Shampoo, pad to block multiples), precondition, unmerge.  The
preconditioner's state is initialised from the reshaped params and is the
stage's whole state; the reshapes have none.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from precondition_tpu_torch.optim.shampoo import GradientTransformation
from precondition_tpu_torch.tearfree import reshaper
from precondition_tpu_torch.tearfree import shampoo
from precondition_tpu_torch.tearfree import sketchy


@enum.unique
class SecondOrderType(enum.Enum):
  SHAMPOO = "shampoo"
  SKETCHY = "sketchy"


@dataclasses.dataclass
class Options:
  """Second-order tracking options.

  Attributes:
    merge_dims: dim-merging threshold fed to the reshaper.
    second_order_type: SHAMPOO or SKETCHY.
    shampoo_options: blocked-Shampoo options (when SHAMPOO).
    sketchy_options: Sketchy options (when SKETCHY).
  """

  merge_dims: int = 1024
  second_order_type: SecondOrderType = SecondOrderType.SHAMPOO
  shampoo_options: Optional[shampoo.Options] = dataclasses.field(
      default_factory=shampoo.Options)
  sketchy_options: Optional[sketchy.Options] = None


def _parts(options: Options):
  """(reshaper options, preconditioner transform)."""
  if options.second_order_type == SecondOrderType.SHAMPOO:
    if not options.shampoo_options:
      raise ValueError("SHAMPOO needs shampoo_options")
    return (reshaper.Options(options.merge_dims,
                             options.shampoo_options.block_size),
            shampoo.apply(options.shampoo_options))
  if options.second_order_type == SecondOrderType.SKETCHY:
    if not options.sketchy_options:
      raise ValueError("SKETCHY needs sketchy_options")
    # Sketchy has no divisibility constraint: merge only, no padding.
    return (reshaper.Options(options.merge_dims, 0),
            sketchy.apply(options.sketchy_options))
  raise ValueError(f"unknown second order type {options.second_order_type}")


def apply(options: Options) -> GradientTransformation:
  """Build merge -> precondition -> unmerge."""
  reshaper_options, precond = _parts(options)
  merge = reshaper.merge(reshaper_options)
  unmerge = reshaper.unmerge(reshaper_options)

  def init_fn(params):
    return precond.init(merge.update(params, None, params)[0])

  def update_fn(updates, state, params=None):
    merged, _ = merge.update(updates, None, params)
    out, state = precond.update(merged, state, None)
    return unmerge.update(out, None, params)[0], state

  return GradientTransformation(init_fn, update_fn)
