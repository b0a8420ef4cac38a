"""Parity of the port's power iteration and matrix power with JAX.

The port's batched `power_iteration` is compared with the JAX package's
`power_iteration` under `vmap`, given JAX's own start vector (torch cannot
draw the bits of `PRNGKey(1729)`).  Eigenvalues rtol 1e-5: the same f32
iteration with matvec sums taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from precondition_tpu.ops import pth_root as jax_pth_root
from precondition_tpu_torch.ops import pth_root

torch.set_num_threads(1)


def _psd_batch(rng, n, m):
  a = rng.randn(n, m, m).astype(np.float32)
  return (np.einsum("nij,nkj->nik", a, a) / m).astype(np.float32)


def _jax_v0(m):
  return np.array(jax.random.uniform(
      jax.random.PRNGKey(1729), (m,), jnp.float32, -1.0, 1.0))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(error_tolerance=1e-2, relative_tolerance=True),
    dict(error_tolerance=1e-3, relative_tolerance=True, relative_floor=0.0),
    dict(num_iters=3),
], ids=["absolute", "loose-relative", "relative-no-floor", "three-steps"])
def test_power_iteration_matches_vmapped_jax(kw):
  rng = np.random.RandomState(0)
  n, m = 6, 24
  stats = _psd_batch(rng, n, m)
  sizes = np.asarray([24, 24, 16, 0, 7, 24], np.int32)
  for i, d in enumerate(sizes):
    stats[i, d:, :] = 0.0
    stats[i, :, d:] = 0.0
  v_ref, ev_ref = jax.vmap(
      lambda s, d: jax_pth_root.power_iteration(s, padding_start=d, **kw))(
          jnp.asarray(stats), jnp.asarray(sizes))
  v, ev = pth_root.power_iteration(
      torch.from_numpy(stats), padding_starts=torch.from_numpy(sizes),
      v0=torch.from_numpy(_jax_v0(m)), **kw)
  np.testing.assert_allclose(ev.numpy(), ev_ref, rtol=1e-5)
  # The loop exits once the Rayleigh quotient moves by <= tol; the two
  # sides may exit a step apart, and at exit the vector is only resolved
  # to sin(theta) ~ sqrt(tol / (l1 - l2)).  Vectors are held to that.
  eigs = np.linalg.eigvalsh(stats.astype(np.float64))
  tol = kw.get("error_tolerance", 1e-6)
  if kw.get("relative_tolerance"):
    tol = tol * np.maximum(eigs[:, -1], kw.get("relative_floor", 1.0))
  gap = np.maximum(eigs[:, -1] - eigs[:, -2], 1e-30)
  atol = 2.0 * np.sqrt(tol / gap) + 1e-6
  assert np.all(np.abs(v.numpy() - np.asarray(v_ref)) <= atol[:, None])


def test_power_iteration_default_start_vector():
  """Without ``v0`` the start vector is `default_v0`: fixed and in [-1, 1)."""
  v0 = pth_root.default_v0(32)
  assert torch.equal(v0, pth_root.default_v0(32))
  assert float(v0.min()) >= -1.0 and float(v0.max()) < 1.0
  stats = torch.from_numpy(_psd_batch(np.random.RandomState(1), 3, 32))
  _, ev = pth_root.power_iteration(stats)
  _, ev_given = pth_root.power_iteration(stats, v0=v0)
  assert torch.equal(ev, ev_given)
  np.testing.assert_allclose(
      ev.numpy(), np.linalg.eigvalsh(stats.double().numpy())[:, -1],
      rtol=1e-3)


@pytest.mark.parametrize("p", [0, 1, 2, 3, 4, 6, 8])
def test_mat_power_matches_jax(p):
  rng = np.random.RandomState(p)
  m = (rng.randn(8, 8) * 0.3).astype(np.float32)
  np.testing.assert_allclose(
      pth_root.mat_power(torch.from_numpy(m), p).numpy(),
      jax_pth_root.mat_power(jnp.asarray(m), p), rtol=1e-5, atol=1e-6)


def test_mat_power_batched():
  rng = np.random.RandomState(9)
  m = (rng.randn(3, 8, 8) * 0.3).astype(np.float32)
  got = pth_root.mat_power(torch.from_numpy(m), 4).numpy()
  for i in range(3):
    np.testing.assert_allclose(
        got[i], jax_pth_root.mat_power(jnp.asarray(m[i]), 4),
        rtol=1e-5, atol=1e-6)


def test_padding_mask():
  np.testing.assert_array_equal(
      pth_root._padding_mask(5, 3, torch.float32).numpy(),
      jax_pth_root._padding_mask(5, 3, jnp.float32))
  per_member = pth_root._padding_mask(
      4, torch.tensor([0, 2, 4], dtype=torch.int32), torch.float32)
  np.testing.assert_array_equal(
      per_member.numpy(),
      np.stack([jax_pth_root._padding_mask(4, d, jnp.float32)
                for d in (0, 2, 4)]))
