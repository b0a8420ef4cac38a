"""Static shape planning: dim merging, block partitioning, padding.

PyTorch counterpart of `precondition_tpu/utils/shapes.py`.  Every decision
is made from static shapes when the optimizer state is built; the tensor
functions here emit only reshapes, permutes, splits and concats, in the
same block order as the JAX package so states move across unchanged.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch


def merge_small_dims(shape: Sequence[int], max_dim: int) -> List[int]:
  """Collapse runs of small dimensions whose product stays within ``max_dim``.

  ``[1, 2, 512, 1, 2048, 1, 3, 4] -> [1024, 2048, 12]`` (``max_dim=1024``);
  ``[1, 1, 1] -> [1]``.
  """
  shape = list(shape)
  if shape and all(d == 1 for d in shape):
    return [1]
  out: List[int] = []
  acc = 1
  for d in shape:
    if acc * d <= max_dim:
      acc *= d
    else:
      if acc > 1:
        out.append(acc)
      acc = d
  if acc > 1:
    out.append(acc)
  return out


def pad_square_matrix(mat: torch.Tensor, max_size: int) -> torch.Tensor:
  """Pad ``M`` to ``[[M, 0], [0, I]]`` of size ``max_size``."""
  return pad_square_stack(mat[None], max_size)[0]


def pad_square_stack(stack: torch.Tensor, max_size: int) -> torch.Tensor:
  """Batched `pad_square_matrix`: ``[k, d, d] -> [k, max, max]``."""
  k, rows, cols = stack.shape
  if rows != cols:
    raise ValueError(f"Must be square, got {rows}x{cols}")
  if cols > max_size:
    raise ValueError(f"Matrix size {cols} exceeds max_size {max_size}")
  if rows == max_size:
    return stack
  out = stack.new_zeros((k, max_size, max_size))
  out[:, :rows, :cols] = stack
  idx = torch.arange(rows, max_size, device=stack.device)
  out[:, idx, idx] = 1.0
  return out


def pad_vector(vec: torch.Tensor, max_size: int) -> torch.Tensor:
  """Pad a vector with trailing zeros to ``max_size``."""
  size = vec.shape[0]
  if size > max_size:
    raise ValueError(f"Vector size {size} exceeds max_size {max_size}")
  if size == max_size:
    return vec
  return torch.cat([vec, vec.new_zeros(max_size - size)])


class BlockPartitioner:
  """Splits a tensor's large axes into blocks of at most ``block_size``.

  The trailing block on each axis may be smaller than ``block_size``.
  Block order is row-major over the per-axis chunk indices, as in the JAX
  package.
  """

  def __init__(self, shape: Sequence[int], block_size: int):
    self._shape = tuple(shape)
    self._splits: List[Tuple[int, np.ndarray]] = []
    split_sizes: List[np.ndarray] = []
    for axis, d in enumerate(self._shape):
      if 0 < block_size < d:
        nsplit = (d - 1) // block_size
        indices = (np.arange(nsplit, dtype=np.int32) + 1) * block_size
        sizes = np.full(nsplit + 1, block_size, dtype=np.int32)
        sizes[-1] = d - indices[-1]
        self._splits.append((axis, indices))
        split_sizes.append(sizes)
      else:
        split_sizes.append(np.asarray([d], dtype=np.int32))
    self._split_sizes = split_sizes

  @property
  def shape(self) -> Tuple[int, ...]:
    return self._shape

  def split_sizes(self) -> List[np.ndarray]:
    """Per-axis arrays of block extents."""
    return self._split_sizes

  def num_blocks(self) -> int:
    n = 1
    for sizes in self._split_sizes:
      n *= len(sizes)
    return n

  def block_shapes(self) -> List[Tuple[int, ...]]:
    """Shapes of all blocks, in `partition` order."""
    return [tuple(int(s) for s in t)
            for t in itertools.product(*self._split_sizes)]

  def partition(self, tensor: torch.Tensor) -> List[torch.Tensor]:
    """Split into blocks; order is row-major over per-axis chunk indices."""
    assert tuple(tensor.shape) == self._shape, (tensor.shape, self._shape)
    tensors = [tensor]
    for axis, indices in self._splits:
      sections = np.diff(np.concatenate(
          [[0], indices, [self._shape[axis]]])).tolist()
      tensors = [piece
                 for t in tensors
                 for piece in torch.split(t, sections, dim=axis)]
    return tensors

  def uniform_block_shape(self) -> Tuple[int, ...] | None:
    """The common block shape, or None when trailing blocks are ragged."""
    shapes = self.block_shapes()
    return shapes[0] if all(s == shapes[0] for s in shapes) else None

  def _counts_and_block(self):
    block = self.uniform_block_shape()
    assert block is not None, "ragged trailing blocks; use partition()"
    return [d // b for d, b in zip(self._shape, block)], block

  def partition_stacked(self, tensor: torch.Tensor) -> torch.Tensor:
    """All blocks as one ``[num_blocks, *block_shape]`` tensor.

    Uniform blocks only; reshape-permute-reshape with the block order of
    `partition`.
    """
    counts, block = self._counts_and_block()
    interleaved = []
    for n, b in zip(counts, block):
      interleaved += [n, b]
    ndim = len(self._shape)
    x = tensor.reshape(interleaved).permute(
        [2 * i for i in range(ndim)] + [2 * i + 1 for i in range(ndim)])
    return x.reshape((int(np.prod(counts)),) + block)

  def merge_stacked(self, stacked: torch.Tensor) -> torch.Tensor:
    """Inverse of `partition_stacked`."""
    counts, block = self._counts_and_block()
    ndim = len(self._shape)
    perm = []
    for i in range(ndim):
      perm += [i, ndim + i]
    x = stacked.reshape(tuple(counts) + block).permute(perm)
    return x.reshape(self._shape)

  def merge_partitions(self, partitions: Sequence[torch.Tensor]) -> torch.Tensor:
    """Inverse of `partition`."""
    partitions = list(partitions)
    for axis, indices in reversed(self._splits):
      n = len(indices) + 1
      partitions = [
          torch.cat(partitions[i:i + n], dim=axis)
          for i in range(0, len(partitions), n)
      ]
    assert len(partitions) == 1
    return partitions[0]
