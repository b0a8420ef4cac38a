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


# --- the batched solvers: `batched_inverse_pth_root` ("xla") and eigh ---
#
# JAX's `batched_inverse_pth_root` (its `matrix_inverse_pth_root` under
# vmap) and the port's on the same seeded batches, the port given JAX's
# start vector.  Tolerances: roots rtol 1e-3 / atol 1e-5 * max|root| (two
# f32 solves, `tests/test_pallas_kernels.py:59`); retries equal;
# iterations within 1; lambda_max rtol 1e-5 (the same power iteration);
# error and the residual report atol 1e-4 (f32 rounding-level residuals of
# converged solves, so no relative tolerance applies; eigh's scaled by
# lambda_max, since its error is an absolute residual of A + rI).  A
# member with cond >= 1e6 is held to its f64 true residual instead of to
# the other side's root, as `tests/test_torch_newton_root.py` does.


@pytest.fixture
def jax_start_vector(monkeypatch):
  monkeypatch.setattr(
      pth_root, "default_v0",
      lambda n, dtype=torch.float32, device=None: torch.from_numpy(
          _jax_v0(n)).to(dtype=dtype, device=device))


def _solver_batch(seed, n=8, m=16, ill=False, sizes=None):
  rng = np.random.RandomState(seed)
  stats = _psd_batch(rng, n, m) + 0.1 * np.eye(m, dtype=np.float32)
  if ill:
    q, _ = np.linalg.qr(rng.randn(m, m))
    # A rank-4 Gram with eigenvalues 1e4: cond 1e10 at a 1e-6 ridge.
    stats[0] = (q * np.r_[1e4 * np.ones(4), np.zeros(m - 4)]).dot(q.T)
  sizes = np.asarray(sizes or [m] * n, np.int32)
  for i, d in enumerate(sizes):
    stats[i, d:, :] = 0.0
    stats[i, :, d:] = 0.0
  return stats.astype(np.float32), sizes


def _both_solvers(stats, p, pads, prevs=None, **kw):
  t = lambda x: None if x is None else torch.from_numpy(np.array(x))
  ours = pth_root.batched_inverse_pth_root(t(stats), p, t(pads), t(prevs),
                                           **kw)
  # The port's argument is the JAX module's knob.
  knob = kw.pop("cold_power_iteration_tolerance", None)
  saved = jax_pth_root.COLD_POWER_ITERATION_TOLERANCE
  jax_pth_root.COLD_POWER_ITERATION_TOLERANCE = knob
  try:
    ref = jax_pth_root.batched_inverse_pth_root(
        jnp.asarray(stats), p, jnp.asarray(pads),
        None if prevs is None else jnp.asarray(prevs), **kw)
  finally:
    jax_pth_root.COLD_POWER_ITERATION_TOLERANCE = saved
  return ((ours[0].numpy(), ours[1]),
          (np.asarray(ref[0]), jax.tree.map(np.asarray, ref[1])))


def _assert_solver_parity(ours, ref, healthy=slice(None), eigh=False):
  (r_o, m_o), (r_r, m_r) = ours, ref
  np.testing.assert_allclose(r_o[healthy], r_r[healthy], rtol=1e-3,
                             atol=1e-5 * np.abs(r_r).max())
  np.testing.assert_array_equal(m_o.retries.numpy(), m_r.retries)
  np.testing.assert_allclose(m_o.iterations.numpy(), m_r.iterations, atol=1)
  np.testing.assert_allclose(m_o.max_eigenvalue.numpy(), m_r.max_eigenvalue,
                             rtol=1e-5)
  scale = 1.0 if not eigh else max(float(m_r.max_eigenvalue.max()), 1.0)
  np.testing.assert_allclose(m_o.error.numpy()[healthy],
                             m_r.error[healthy], atol=1e-4 * scale)
  # The last error ratio of a converged solve divides two rounding-level
  # errors, so only its side of the divergence bound is compared.
  np.testing.assert_array_equal(m_o.error_ratio.numpy()[healthy] < 1.2,
                                m_r.error_ratio[healthy] < 1.2)
  diag = m_o.inverse_pth_root_diagnostics
  if diag is not None:
    ref_diag = m_r.inverse_pth_root_diagnostics
    np.testing.assert_array_equal(diag.p.numpy(), ref_diag.p)
    for f in ("max_diag_error", "avg_diag_error", "max_off_diag_error",
              "avg_off_diag_error"):
      np.testing.assert_allclose(getattr(diag, f).numpy()[healthy],
                                 getattr(ref_diag, f)[healthy],
                                 atol=1e-4 * scale, err_msg=f)


def _f64_residual(stats, roots, ridges, p):
  """Per member ``max|H^p (A + rI) - I|`` in f64, and its f32 bound
  ``100 * eps * p * cond(A + rI)``."""
  d = stats.astype(np.float64) + ridges[:, None, None] * np.eye(
      stats.shape[-1])
  hp = np.linalg.matrix_power(roots.astype(np.float64), p)
  ev = np.linalg.eigvalsh(d)
  return (np.abs(hp @ d - np.eye(stats.shape[-1])).max(axis=(1, 2)),
          100 * 1.2e-7 * p * ev[:, -1] / ev[:, 0])


@pytest.mark.usefixtures("jax_start_vector")
@pytest.mark.parametrize("case", [
    dict(p=2), dict(p=4), dict(p=6),
    dict(p=4, sizes=[16, 12, 8, 0, 16, 4, 16, 1]),
    dict(p=4, kw=dict(relative_matrix_epsilon=False)),
    dict(p=4, kw=dict(cold_power_iteration_tolerance=1e-2)),
    dict(p=4, kw=dict(generate_diagnostics=True),
         sizes=[16, 12, 8, 0, 16, 4, 16, 1]),
], ids=["cold-p2", "cold-p4", "cold-p6", "padded", "absolute-ridge",
        "loose-cold-power-iteration", "diagnostics-padded"])
def test_batched_solver_matches_jax(case):
  stats, pads = _solver_batch(case["p"], sizes=case.get("sizes"))
  ours, ref = _both_solvers(stats, case["p"], pads, **case.get("kw", {}))
  _assert_solver_parity(ours, ref)
  zero = pads == 0
  assert np.all(ours[0][zero] == 0) and np.all(ours[1].error.numpy()[zero]
                                               == 0)


@pytest.mark.usefixtures("jax_start_vector")
@pytest.mark.parametrize("p", [2, 4])
def test_batched_solver_warm_start_matches_jax(p):
  stats, pads = _solver_batch(10 + p, sizes=[16, 16, 12, 16, 8, 16, 16, 16])
  cold = np.asarray(jax_pth_root.batched_inverse_pth_root(
      jnp.asarray(stats), p, jnp.asarray(pads))[0])
  drifted = (0.999 * stats + 0.001 * _solver_batch(20, sizes=list(pads))[0]
             ).astype(np.float32)
  prevs = cold.copy()
  prevs[0] = 100.0 * np.random.RandomState(3).randn(16, 16)  # garbage
  ours, ref = _both_solvers(drifted, p, pads, prevs,
                            generate_diagnostics=True)
  _assert_solver_parity(ours, ref)
  # The garbage start failed its certificate and solved cold.
  assert ours[1].iterations[0] > 3 >= ours[1].iterations[1:].max()


@pytest.mark.usefixtures("jax_start_vector")
def test_batched_solver_ill_conditioned_member_retries_like_jax():
  """A cond-1e10 member beside healthy ones, with an absolute ridge: the
  ladder escalates it on both sides; the healthy members match."""
  stats, pads = _solver_batch(7, ill=True)
  ours, ref = _both_solvers(stats, 4, pads, relative_matrix_epsilon=False)
  assert ours[1].retries[0] > 1
  _assert_solver_parity(ours, ref, healthy=slice(1, None))
  ridges = 1e-6 * 10.0 ** (ours[1].retries.numpy()[:1] - 1)
  for roots in (ours[0], ref[0]):
    resid, bound = _f64_residual(stats[:1], roots[:1], ridges, 4)
    assert resid[0] < bound[0]


@pytest.mark.usefixtures("jax_start_vector")
@pytest.mark.parametrize("case", [
    dict(p=4), dict(p=2, sizes=[16, 12, 8, 0, 16, 4, 16, 1]),
    dict(p=4, kw=dict(generate_diagnostics=True),
         sizes=[16, 12, 8, 0, 16, 4, 16, 1]),
], ids=["cold", "padded", "diagnostics-padded"])
def test_eigh_matches_jax(case):
  stats, pads = _solver_batch(30 + case["p"], sizes=case.get("sizes"))
  ours, ref = _both_solvers(stats, case["p"], pads, eigh=True,
                            **case.get("kw", {}))
  _assert_solver_parity(ours, ref, eigh=True)
  for i, d in enumerate(pads):
    assert np.all(ours[0][i, d:, :] == 0) and np.all(ours[0][i, :, d:] == 0)
  np.testing.assert_allclose(ours[0], ours[0].transpose(0, 2, 1), rtol=1e-6)


def test_batched_solver_one_by_one_matrices():
  """m == 1 is solved in closed form with zero metrics, as in JAX."""
  stats = np.asarray([[[4.0]], [[0.25]], [[9.0]]], np.float32)
  pads = np.asarray([1, 1, 0], np.int32)
  (roots, met), (roots_j, met_j) = _both_solvers(
      stats, 2, pads, relative_matrix_epsilon=False)
  np.testing.assert_allclose(roots, roots_j, rtol=1e-6)
  assert roots[2, 0, 0] == 0 and np.all(met.retries.numpy() == 0)
