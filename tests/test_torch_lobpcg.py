"""Parity of the port's LOBPCG, `pth_root_difference` and the LOBPCG-
deflated solve with the JAX package.

`ops.lobpcg.lobpcg_standard` is held to JAX's own
`jax.experimental.sparse.linalg.lobpcg_standard` (the routine the JAX
package calls) under `vmap`, stopped after k iterations as the deflation
stops it and run to convergence; the deflated solve of
`ops.pth_root.batched_inverse_pth_root` to `jax.vmap` of the JAX package's
`matrix_inverse_pth_root` with its detailed diagnostics.  Inputs are
numpy-seeded PSD batches with padded members.

Tolerances and why:
* eigenvalues rtol 1e-4: two f32 runs of one algorithm whose small
  Rayleigh-Ritz eigenproblems go to two LAPACK builds; iterations equal
  when stopped by the count, within 1 when converged (the exit test holds
  residuals to eps-level bounds);
* eigenvectors are defined up to sign: each column is aligned with JAX's,
  then atol 1e-3 (the Ritz vectors of an unconverged run are resolved to
  the same rounding amplified by the Ritz gaps of these inputs);
* `pth_root_difference` rtol 1e-5, against JAX and against the float64
  difference of the same f32 inputs: elementwise f32;
* roots rtol 1e-3, atol 1e-5 of the largest entry, the kernel tolerance of
  `tests/test_pallas_kernels.py:59` for two f32 Newton solves; retries
  equal; iterations within 1;
* errors rtol 1e-3, atol 1e-3: under LOBPCG the error is the residual
  ``H^p (A + rI) - I`` of the re-deflated root against the undeflated
  problem, which carries the roots' 1e-3 agreement through p products
  and, where k iterations leave the pairs unconverged, is of order one;
* the reports rtol 1e-3, atol 1e-3 for the same reason (the residual
  reports are built from the same products; the LOBPCG report from the
  pairs), and the LOBPCG iterations within 1, as above.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.sparse import linalg as sparse_linalg

from precondition_tpu.ops import pth_root as jax_pth_root
from precondition_tpu_torch.ops import lobpcg
from precondition_tpu_torch.ops import pth_root

torch.set_num_threads(1)


def _psd(seed, n, m, pads):
  rng = np.random.RandomState(seed)
  a = rng.rand(n, m, m).astype(np.float32)
  mats = np.einsum("nji,njk->nik", a, a).astype(np.float32)
  for i, p in enumerate(pads):
    mats[i, p:, :] = 0.0
    mats[i, :, p:] = 0.0
  return mats


def _search(n, m, k):
  x = np.zeros((n, m, k), np.float32)
  x[:, :k, :k] = np.eye(k)
  return x


def _assert_vectors_close(ours, ref, atol):
  dots = np.einsum("nik,nik->nk", ours, ref)
  ours = ours * np.where(dots < 0, -1.0, 1.0)[:, None, :]
  np.testing.assert_allclose(ours, ref, atol=atol)


@pytest.mark.parametrize("k,iters", [(2, 2), (2, 100), (3, 3)],
                         ids=["k2-two-steps", "k2-converged", "k3"])
def test_lobpcg_matches_jax(k, iters):
  m = 16
  pads = np.array([16, 16, 12, 16, 14], np.int32)
  mats = _psd(0, len(pads), m, pads)
  x = _search(len(pads), m, k)
  ev_r, vec_r, it_r = jax.vmap(
      lambda a, s: sparse_linalg.lobpcg_standard(a, s, iters))(mats, x)
  ev, vec, it = lobpcg.lobpcg_standard(torch.from_numpy(mats),
                                       torch.from_numpy(x), iters)
  if iters == 100:
    # Converged, each on its own; the exit test compares residuals with
    # eps-level bounds, so it may pass a step apart on the two sides.
    assert (it.numpy() < iters).all()
    np.testing.assert_allclose(it.numpy(), it_r, atol=1)
  else:
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_r))
  np.testing.assert_allclose(ev.numpy(), ev_r, rtol=1e-4)
  _assert_vectors_close(vec.numpy(), np.asarray(vec_r), 1e-3)


def test_lobpcg_checks_its_inputs_like_jax():
  a = np.eye(10, dtype=np.float32)
  for k in (0, 2):
    with pytest.raises(ValueError):
      sparse_linalg.lobpcg_standard(a, _search(1, 10, k)[0], 2)
    with pytest.raises(ValueError):
      lobpcg.lobpcg_standard(torch.from_numpy(a)[None],
                             torch.from_numpy(_search(1, 10, k)), 2)


@pytest.mark.parametrize("p", [2, 4, 6])
def test_pth_root_difference_matches_jax(p):
  rng = np.random.RandomState(1)
  w = np.float32(1e-4)
  alpha = rng.rand(8, 1).astype(np.float32)
  beta = alpha + np.concatenate(
      [np.zeros((8, 1)), rng.rand(8, 3) * 10.0 ** rng.randint(-6, 2, (8, 3))],
      axis=1).astype(np.float32)
  ref = jax_pth_root.pth_root_difference(w, alpha, beta, p)
  ours = pth_root.pth_root_difference(torch.tensor(w), torch.from_numpy(alpha),
                                      torch.from_numpy(beta), p)
  np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-30)
  a64, b64 = alpha.astype(np.float64), beta.astype(np.float64)
  exact = (w + a64) ** (-1 / p) - (w + b64) ** (-1 / p)
  np.testing.assert_allclose(ours.numpy(), exact, rtol=1e-5, atol=1e-30)


def _assert_report_close(ours, ref, name):
  for f in dataclasses.fields(ours):
    got, want = getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name))
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1 if f.name == "lobpcg_iters" else 1e-3,
                               err_msg=f"{name}.{f.name}")


@pytest.mark.parametrize("k,max_iter,p", [(2, 0, 4), (2, 10, 2), (3, 0, 4)],
                         ids=["k2-default-iters", "k2-ten-iters-p2", "k3"])
def test_deflated_solve_matches_vmapped_jax(k, max_iter, p):
  m = 16
  pads = np.array([16, 16, 12, 0, 16], np.int32)
  mats = _psd(2, len(pads), m, pads)
  kw = dict(ridge_epsilon=1e-4, lobpcg_topk_precondition=k,
            lobpcg_max_iter=max_iter, generate_diagnostics=True)
  roots_r, met_r = jax.vmap(lambda a, s: jax_pth_root.matrix_inverse_pth_root(
      a, p, padding_start=s, **kw))(mats, pads)
  # A previous root is ignored under LOBPCG, as JAX ignores it.
  roots, met = pth_root.batched_inverse_pth_root(
      torch.from_numpy(mats), p, torch.from_numpy(pads),
      prevs=torch.eye(m).expand(len(pads), m, m), **kw)
  roots_r = np.asarray(roots_r)
  np.testing.assert_allclose(roots.numpy(), roots_r, rtol=1e-3,
                             atol=1e-5 * np.abs(roots_r).max())
  np.testing.assert_array_equal(roots[pads == 0].numpy(), 0.0)
  np.testing.assert_array_equal(met.retries.numpy(), met_r.retries)
  np.testing.assert_allclose(met.iterations.numpy(), met_r.iterations,
                             atol=1)
  np.testing.assert_allclose(met.max_eigenvalue.numpy(), met_r.max_eigenvalue,
                             rtol=1e-4)
  np.testing.assert_allclose(met.error.numpy(), met_r.error, rtol=1e-3,
                             atol=1e-3)
  for name in ("lobpcg", "inverse_pth_root_diagnostics",
               "conditioned_inverse_pth_root_diagnostics"):
    _assert_report_close(getattr(met, name), getattr(met_r, name), name)
  assert (met.lobpcg.num_topk_eigenvectors[pads > 0] == k).all()
