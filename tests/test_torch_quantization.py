"""Parity of the port's `QuantizedValue` with the JAX package's.

The same seeded numpy values go through both packages.  Codes, buckets and
diagonals must be equal bit for bit: both sides take the same per-column
maximum, divide by the same f32 scale and round half to even.  Decoded
values are compared at rtol 1e-6: a decode is one product and one sum per
entry, which a compiler may fuse into one rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from precondition_tpu.utils.quantization import QuantizedValue as JaxQV
from precondition_tpu_torch.utils.quantization import QuantizedValue

_DTYPES = {"int8": (torch.int8, jnp.int8), "int16": (torch.int16, jnp.int16),
           "bf16": (torch.bfloat16, jnp.bfloat16),
           "f32": (torch.float32, jnp.float32)}


def _psd(rng, d):
  g = rng.randn(d, d)
  return (g @ g.T).astype(np.float32)


def _as_f32(x):
  if isinstance(x, torch.Tensor):
    return x.to(torch.float32).numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_same_numbers(ours: QuantizedValue, ref: JaxQV):
  np.testing.assert_array_equal(_as_f32(ours.quantized),
                                _as_f32(ref.quantized))
  if ours.bucket_size is None:
    assert isinstance(ref.bucket_size, list) and not ref.bucket_size
  else:
    np.testing.assert_array_equal(ours.bucket_size.numpy(),
                                  np.asarray(ref.bucket_size))
  if ours.diagonal is None:
    assert isinstance(ref.diagonal, list) and not ref.diagonal
  else:
    np.testing.assert_array_equal(ours.diagonal.numpy(),
                                  np.asarray(ref.diagonal))
  assert list(ours.shape) == list(ref.shape)


@pytest.mark.parametrize("extract_diagonal", [False, True],
                         ids=["plain", "diagonal"])
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_codes_buckets_and_diagonals_match_jax(dtype, extract_diagonal):
  rng = np.random.RandomState(0)
  x = _psd(rng, 12) + 0.5 * rng.randn(12, 12).astype(np.float32)
  # A zero column (scale 0 divides by 1) and entries on half-code bounds.
  x[:, 3] = 0.0
  x[3, :] = 0.0
  x[5, 7] = 2.5 * np.abs(x[:, 7]).max() / 127.0
  torch_dtype, jax_dtype = _DTYPES[dtype]
  ours = QuantizedValue.from_float_value(torch.from_numpy(x), torch_dtype,
                                         extract_diagonal)
  ref = JaxQV.from_float_value(jnp.asarray(x), jax_dtype, extract_diagonal)
  _assert_same_numbers(ours, ref)
  np.testing.assert_allclose(ours.to_float().numpy(),
                             np.asarray(ref.to_float()), rtol=1e-6)


@pytest.mark.parametrize("shape", [(7,), (4, 5, 6)])
def test_momentum_shapes_match_jax(shape):
  """int8 momenta of 1-D and 3-D params: the maximum runs over axis 0."""
  x = np.random.RandomState(1).randn(*shape).astype(np.float32)
  ours = QuantizedValue.from_float_value(torch.from_numpy(x), torch.int8)
  ref = JaxQV.from_float_value(jnp.asarray(x), jnp.int8)
  _assert_same_numbers(ours, ref)


@pytest.mark.parametrize("dtype,extract_diagonal", [
    ("int8", False), ("int16", False), ("int16", True)])
def test_batched_equals_per_matrix(dtype, extract_diagonal):
  rng = np.random.RandomState(2)
  stack = np.stack([_psd(rng, 8) for _ in range(5)])
  stack[2] = np.eye(8, dtype=np.float32)  # the quantized identity: scale 0
  torch_dtype, _ = _DTYPES[dtype]
  batched = QuantizedValue.from_float_value(
      torch.from_numpy(stack), torch_dtype, extract_diagonal, batch_dims=1)
  members = batched.unbind()
  for i, member in enumerate(members):
    alone = QuantizedValue.from_float_value(
        torch.from_numpy(stack[i]), torch_dtype, extract_diagonal)
    for a, b in zip(member.tensors(), alone.tensors(), strict=True):
      assert torch.equal(a, b)
    assert torch.equal(member.to_float(), alone.to_float())
  assert torch.equal(QuantizedValue.stack(members).to_float(),
                     batched.to_float())


def test_int8_roundtrip():
  """`tests/test_shapes.py::TestQuantization::test_int8_roundtrip`."""
  x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
  qv = QuantizedValue.from_float_value(torch.from_numpy(x), torch.int8)
  np.testing.assert_allclose(qv.to_float().numpy(), x,
                             atol=float(np.abs(x).max() / 127.0))


def test_int16_psd_with_diagonal():
  """`tests/test_shapes.py::TestQuantization::test_int16_psd_with_diagonal`."""
  psd = _psd(np.random.RandomState(1), 6)
  qv = QuantizedValue.from_float_value(torch.from_numpy(psd), torch.int16,
                                       extract_diagonal=True)
  np.testing.assert_allclose(qv.to_float().numpy(), psd, rtol=1e-3,
                             atol=1e-3)
  np.testing.assert_array_equal(qv.diagonal.numpy(), np.diag(psd))


def test_invalid_inputs_raise():
  with pytest.raises(ValueError, match="not supported"):
    QuantizedValue.from_float_value(torch.ones(3, 3), torch.int32)
  with pytest.raises(ValueError, match="square"):
    QuantizedValue.from_float_value(torch.ones(3), torch.int16,
                                    extract_diagonal=True)
  with pytest.raises(ValueError, match="0-D"):
    QuantizedValue.from_float_value(torch.tensor(1.0), torch.int8)
