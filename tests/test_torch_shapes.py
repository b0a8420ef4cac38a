"""Parity of the port's shape planning with `precondition_tpu.utils.shapes`.

Dim merging, padding, block partitioning, stacking and merging are pure
data movement, so the two packages must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from precondition_tpu.utils import shapes as jax_shapes
from precondition_tpu_torch.utils import shapes

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,max_dim", [
    ([1, 2, 512, 1, 2048, 1, 3, 4], 1024), ([1, 2, 768, 1, 2048], 1024),
    ([1, 1, 1], 1024), ([], 1024), ([4, 8, 16], 4096), ([1024, 3072], 4096),
    ([3, 5, 7, 11], 16),
])
def test_merge_small_dims(shape, max_dim):
  assert (shapes.merge_small_dims(shape, max_dim)
          == jax_shapes.merge_small_dims(shape, max_dim))


@pytest.mark.parametrize("rows,size", [(5, 8), (8, 8), (1, 4)])
def test_pad_square(rows, size):
  rng = np.random.RandomState(rows)
  mat = rng.randn(rows, rows).astype(np.float32)
  stack = rng.randn(3, rows, rows).astype(np.float32)
  np.testing.assert_array_equal(
      shapes.pad_square_matrix(torch.from_numpy(mat), size).numpy(),
      jax_shapes.pad_square_matrix(jnp.asarray(mat), size))
  np.testing.assert_array_equal(
      shapes.pad_square_stack(torch.from_numpy(stack), size).numpy(),
      jax_shapes.pad_square_stack(jnp.asarray(stack), size))
  vec = rng.randn(rows).astype(np.float32)
  np.testing.assert_array_equal(
      shapes.pad_vector(torch.from_numpy(vec), size).numpy(),
      jax_shapes.pad_vector(jnp.asarray(vec), size))


def test_pad_errors():
  with pytest.raises(ValueError, match="square"):
    shapes.pad_square_matrix(torch.zeros(2, 3), 4)
  with pytest.raises(ValueError, match="exceeds"):
    shapes.pad_square_stack(torch.zeros(1, 5, 5), 4)
  with pytest.raises(ValueError, match="exceeds"):
    shapes.pad_vector(torch.zeros(5), 4)


@pytest.mark.parametrize("shape,block", [
    ((32, 64), 16), ((48, 16), 16), ((512,), 16), ((20, 17), 8),
    ((6, 10, 4), 4), ((8,), 16), ((7, 9), 0),
])
def test_block_partitioner(shape, block):
  rng = np.random.RandomState(len(shape))
  x = rng.randn(*shape).astype(np.float32)
  ours = shapes.BlockPartitioner(shape, block)
  ref = jax_shapes.BlockPartitioner(shape, block)
  assert ours.block_shapes() == ref.block_shapes()
  assert ours.num_blocks() == ref.num_blocks()
  assert ours.uniform_block_shape() == ref.uniform_block_shape()
  for a, b in zip(ours.split_sizes(), ref.split_sizes(), strict=True):
    np.testing.assert_array_equal(a, b)
  parts = ours.partition(torch.from_numpy(x))
  ref_parts = ref.partition(jnp.asarray(x))
  for a, b in zip(parts, ref_parts, strict=True):
    np.testing.assert_array_equal(a.numpy(), b)
  np.testing.assert_array_equal(ours.merge_partitions(parts).numpy(), x)
  if ours.uniform_block_shape() is not None:
    stacked = ours.partition_stacked(torch.from_numpy(x))
    np.testing.assert_array_equal(
        stacked.numpy(), ref.partition_stacked(jnp.asarray(x)))
    np.testing.assert_array_equal(ours.merge_stacked(stacked).numpy(), x)
