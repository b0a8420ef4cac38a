"""Gradient merge/pad and unpad/unmerge transforms.

PyTorch counterpart of `precondition_tpu/tearfree/reshaper.py`: small
dimensions are merged (`utils.shapes.merge_small_dims`), then every
dimension of at least ``block_size`` is zero-padded up to a multiple of
it, so that the blocked Shampoo layer downstream sees only divisible
shapes.  Both transforms are stateless (state None) and read the shapes
from ``params``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from precondition_tpu_torch.optim.shampoo import GradientTransformation
from precondition_tpu_torch.utils import shapes as shape_utils


@dataclasses.dataclass
class Options:
  """Reshaping options.

  Attributes:
    merge_dims: collapse adjacent dims whose product stays within this.
    block_size: if nonzero, pad every dim >= block_size up to a multiple of
      it (0 disables padding).
  """

  merge_dims: int = 1024
  block_size: int = 1024


@dataclasses.dataclass
class _Shapes:
  original_shape: List[int]
  merged_shape: List[int]
  padded_shape: List[int]


def _derive_shapes(options: Options, shape) -> _Shapes:
  merged = shape_utils.merge_small_dims(shape, options.merge_dims)
  if merged == [1]:
    # Fully degenerate tensors collapse to scalars.
    return _Shapes(list(shape), [], [])
  if options.block_size == 0:
    padded = list(merged)
  else:
    bs = options.block_size
    padded = [-(-s // bs) * bs if s >= bs else s for s in merged]
  return _Shapes(list(shape), list(merged), padded)


def _validate(options: Options):
  if options.merge_dims < 2:
    raise ValueError(f"merge_dims ({options.merge_dims}) must be at least 2")
  if options.block_size != 0 and options.block_size < 2:
    raise ValueError(
        f"block_size ({options.block_size}) must be at least 2 (or 0)")


def merge(options: Options) -> GradientTransformation:
  """Merge small dims and zero-pad large ones."""
  _validate(options)

  def _merge(update, shapes: _Shapes):
    if list(update.shape) != shapes.original_shape:
      raise ValueError(f"update of shape {list(update.shape)} for a param "
                       f"of shape {shapes.original_shape}")
    merged = update.reshape(shapes.merged_shape)
    if shapes.padded_shape == shapes.merged_shape:
      return merged
    out = merged.new_zeros(shapes.padded_shape)
    out[tuple(slice(0, m) for m in shapes.merged_shape)] = merged
    return out

  def update_fn(updates, state, params):
    return {n: _merge(u, _derive_shapes(options, params[n].shape))
            for n, u in updates.items()}, state

  return GradientTransformation(lambda _: None, update_fn)


def unmerge(options: Options) -> GradientTransformation:
  """Inverse of `merge`."""
  _validate(options)

  def _unmerge(update, shapes: _Shapes):
    if list(update.shape) != shapes.padded_shape:
      raise ValueError(f"update of shape {list(update.shape)}, expected "
                       f"{shapes.padded_shape}")
    merged = update[tuple(slice(0, m) for m in shapes.merged_shape)]
    return merged.reshape(shapes.original_shape)

  def update_fn(updates, state, params):
    return {n: _unmerge(u, _derive_shapes(options, params[n].shape))
            for n, u in updates.items()}, state

  return GradientTransformation(lambda _: None, update_fn)
