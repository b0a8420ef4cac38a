"""Parity of the port's matmul-chain twin with the JAX Pallas kernel.

The JAX kernel is `benchmarks/pallas_tile_breakdown.py::_matmul_only_kernel`,
run here in Pallas interpret mode through a `pl.pallas_call` built as
`_matmul_only` builds it (tile k members a grid step).  The port's side is
`precondition_tpu_torch.ops.kernels.matmul_chain` on CPU tensors, which
takes the plain-PyTorch twin.  Both get the same seeded numpy Wishart
statistics.  Tolerance: rtol 1e-4 / atol 1e-5.  Both sides are f32 with
the products' sums in other orders, and the renormalisation keeps M's
entries at most 1, so the chain drifts apart by a few ulps a step; H's
entries stay O(1) at these sizes.  `tests/test_torch_cuda.py` holds the
CUDA kernel against the twin on a card.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from benchmarks import pallas_tile_breakdown
from precondition_tpu_torch.ops.kernels import matmul_chain
from precondition_tpu_torch.probes import tile_breakdown

torch.set_num_threads(1)


def _stats(n, m, seed):
  g = np.random.RandomState(seed).randn(n, m, m).astype(np.float32)
  return (np.einsum("nij,nkj->nik", g, g) / m).astype(np.float32)


def _jax_matmul_only(stats, iters, p, k):
  """`_matmul_only` in interpret mode (no TPU memory space)."""
  n, m, _ = stats.shape
  spec = pl.BlockSpec((k, m, m), lambda i: (i, 0, 0))
  return np.asarray(pl.pallas_call(
      functools.partial(pallas_tile_breakdown._matmul_only_kernel,
                        iters=iters, p=p, k=k, m=m),
      grid=(n // k,),
      in_specs=[spec],
      out_specs=spec,
      out_shape=jax.ShapeDtypeStruct((n, m, m), jnp.float32),
      interpret=True,
  )(jnp.asarray(stats)))


class TestMatmulChainTwin:

  @pytest.mark.parametrize("m", [16, 32])
  @pytest.mark.parametrize("iters", [1, 3, 8])
  @pytest.mark.parametrize("p", [2, 4])
  def test_matches_jax_kernel(self, p, iters, m):
    stats = _stats(8, m, seed=p * 100 + iters * 10 + m)
    ref = _jax_matmul_only(stats, iters, p, k=4)
    ours = matmul_chain.matmul_chain(torch.from_numpy(stats), p, iters)
    assert ours.dtype == torch.float32 and ours.shape == stats.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-5)

  def test_cpu_takes_the_twin_and_launches_nothing(self):
    stats = torch.from_numpy(_stats(3, 8, seed=0))
    before = matmul_chain.LAUNCHES
    via_dispatch = matmul_chain.matmul_chain(stats, 4, 3)
    plain = matmul_chain.matmul_chain_plain(stats, 4, 3)
    assert matmul_chain.LAUNCHES == before
    torch.testing.assert_close(via_dispatch, plain, rtol=0, atol=0)

  def test_cuda_entry_refuses_a_cpu_tensor(self):
    with pytest.raises(ValueError, match="CUDA tensor"):
      matmul_chain.matmul_chain_cuda(torch.eye(4)[None], 4, 1)

  @pytest.mark.parametrize("m,p", [(129, 4), (16, 6), (16, 7), (16, 0)])
  def test_outside_the_resident_rule_raises(self, m, p):
    with pytest.raises(ValueError, match="resident rule"):
      matmul_chain.matmul_chain(torch.zeros(1, m, m), p, 1)


class TestTileBreakdown:

  def test_measure_on_cpu(self):
    out = tile_breakdown.measure(n=4, m=16, p=4, device="cpu")
    assert out["platform"] == "cpu" and out["fixture"] == {"n": 4, "m": 16,
                                                           "p": 4}
    assert out["products_per_iter"] == 4
    keys = ["solve_ms", "solve_mean_iters", "solve_max_retries",
            "fullbody_ratio_default_iters24_mean_iters",
            "fullbody_max_error_ratio", "fullbody_iters8_ms",
            "fullbody_iters8_mean_iters", "fullbody_iters24_ms",
            "fullbody_iters24_mean_iters", "fullbody_per_iter_ms",
            "launch_io_setup_ms", "matmulonly_iters8_ms",
            "matmulonly_iters24_ms", "matmulonly_per_iter_ms",
            "mask_select_overhead_per_iter_ms", "modeled_no_retry_ms",
            "retry_straggler_tail_ms", "library_bmm_ms"]
    for key in keys:
      assert key in out, key
    # Times and rates of the card are null on the CPU.
    for key in ("sms", "matmulonly_tflops", "solve_us_per_product_per_sm",
                "fullbody_us_per_product_per_sm",
                "matmulonly_us_per_product_per_sm",
                "library_us_per_product_per_sm",
                "h100_f32_peak_us_per_product_per_sm"):
      assert out[key] is None, key
    # A budget that no member leaves early runs to its end.
    assert out["fullbody_iters8_mean_iters"] == 8.0
    assert out["fullbody_iters24_mean_iters"] == 24.0
    slope = ((out["fullbody_iters24_ms"] - out["fullbody_iters8_ms"])
             / (out["fullbody_iters24_mean_iters"]
                - out["fullbody_iters8_mean_iters"]))
    assert out["fullbody_per_iter_ms"] == pytest.approx(slope)
    assert out["launch_io_setup_ms"] == pytest.approx(
        out["fullbody_iters8_ms"] - 8 * slope)
    slope_mm = (out["matmulonly_iters24_ms"] - out["matmulonly_iters8_ms"]) / 16
    assert out["matmulonly_per_iter_ms"] == pytest.approx(slope_mm)
    assert out["mask_select_overhead_per_iter_ms"] == pytest.approx(
        slope - slope_mm)
    modeled = out["launch_io_setup_ms"] + out["solve_mean_iters"] * slope
    assert out["modeled_no_retry_ms"] == pytest.approx(modeled)
    assert out["retry_straggler_tail_ms"] == pytest.approx(
        out["solve_ms"] - modeled)
    assert 1 <= out["solve_mean_iters"] <= 100
    # The budgets between 8 and 24 give a slope for each neighbour pair.
    assert tile_breakdown.BUDGETS == (8, 12, 16, 20, 24)
    body = out["fullbody_per_iter_ms_by_interval"]
    chain = out["matmulonly_per_iter_ms_by_interval"]
    assert list(body) == list(chain) == ["8-12", "12-16", "16-20", "20-24"]
    assert chain["12-16"] == pytest.approx(
        (out["matmulonly_iters16_ms"] - out["matmulonly_iters12_ms"]) / 4)
    assert body["20-24"] == pytest.approx(
        (out["fullbody_iters24_ms"] - out["fullbody_iters20_ms"])
        / (out["fullbody_iters24_mean_iters"]
           - out["fullbody_iters20_mean_iters"]))

  def test_fixture_is_the_jax_scripts(self):
    stats, max_evs = tile_breakdown.fixture(3, 8, torch.device("cpu"))
    g = np.random.RandomState(0).randn(3, 8, 8)
    ref = np.einsum("nij,nkj->nik", g, g) / 8
    np.testing.assert_allclose(stats.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(max_evs.numpy(), np.linalg.eigvalsh(ref)[:, -1],
                               rtol=1e-4)

  @pytest.mark.parametrize("p,products", [(1, 2), (2, 3), (3, 4), (4, 4),
                                          (8, 5)])
  def test_products_per_step(self, p, products):
    assert tile_breakdown.products_per_step(p) == products
