"""Optimizer-state bytes of the port against the JAX package at full size.

The 58.7M-parameter tree of the JAX package's `bench.py` (`_param_tree`,
4 layers, d=1024, ff=4096, vocab 8192) with its `HYPERS` and RMSProp
grafting, as `benchmarks/quantized_probe.py` counts it: the port's state is
built on the ``meta`` device (shapes and dtypes, no memory) and the JAX
state by `jax.eval_shape`.  The byte counts must agree within 0.1%.  The
one difference is the step count: JAX keeps an int32 array (4 bytes), the
port a Python int (no tensor bytes).  The JAX probe counted 1514.2 MB in
f32 and 770.0 MB quantized (`STEP_BREAKDOWN_TPU.json`, shape-derived);
with frequent directions at rank 32 every root of the 6,176 blocks of 128
is a packed [128, 34] buffer, 1217.0 MB by `jax.eval_shape` here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precondition_tpu.optim import shampoo as jax_shampoo
from precondition_tpu_torch.optim import shampoo

_HYPERS = dict(learning_rate=0.1, block_size=128, beta1=0.9, beta2=0.999,
               matrix_epsilon=1e-6, start_preconditioning_step=0,
               statistics_compute_steps=1, generate_training_metrics=False)


def _shapes(d=1024, ff=4096, vocab=8192, layers=4):
  tree = {"embed": (vocab, d)}
  for i in range(layers):
    tree[f"blk{i}"] = {"qkv": (d, 3 * d), "out": (d, d), "ffn_in": (d, ff),
                       "ffn_out": (ff, d), "norm": (d,)}
  return tree


def _flat(tree, prefix=""):
  out = {}
  for key in sorted(tree):
    value = tree[key]
    if isinstance(value, dict):
      out.update(_flat(value, f"{prefix}{key}/"))
    else:
      out[prefix + key] = value
  return out


def _port_bytes(options):
  opt = shampoo.distributed_shampoo(
      **_HYPERS, graft_type=shampoo.GraftingType.RMSPROP, **options)
  state = opt.init({n: torch.empty(s, device="meta")
                    for n, s in _flat(_shapes()).items()})
  return sum(t.numel() * t.element_size()
             for t in _tensors(shampoo.state_to_tree(state)))


def _tensors(tree):
  if isinstance(tree, torch.Tensor):
    yield tree
  elif isinstance(tree, dict):
    for value in tree.values():
      yield from _tensors(value)
  elif isinstance(tree, list):
    for value in tree:
      yield from _tensors(value)


def _jax_bytes(options):
  opt = jax_shampoo.distributed_shampoo(
      **_HYPERS, graft_type=jax_shampoo.GraftingType.RMSPROP, **options)
  params = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                        _shapes(), is_leaf=lambda x: isinstance(x, tuple))
  shapes = jax.eval_shape(opt.init, params)
  return sum(int(np.prod(x.shape)) * x.dtype.itemsize
             for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("options,jax_probe_mb", [
    (dict(), 1514.2),
    (dict(best_effort_memory_usage_reduction=True), 770.0),
    (dict(compression_rank=32, frequent_directions=True), 1217.0),
], ids=["f32", "quantized", "fd-rank-32"])
def test_state_bytes_match_jax_at_full_size(options, jax_probe_mb):
  ours, ref = _port_bytes(options), _jax_bytes(options)
  assert ref - ours == 4  # the int32 step count
  assert abs(ours - ref) <= 1e-3 * ref
  assert round(ref / 1e6, 1) == jax_probe_mb
