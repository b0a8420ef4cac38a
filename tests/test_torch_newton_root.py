"""Parity of the port's Newton-root twin with the JAX Pallas kernel.

Every case of `tests/test_pallas_kernels.py` that drives the kernel runs
here on the same seeded numpy inputs through both packages: the JAX kernel
in Pallas interpret mode, the port's plain-PyTorch twin
(`precondition_tpu_torch.ops.kernels.newton_root`).  Tolerances, unless a
test says otherwise: roots rtol 1e-3 / atol 1e-5 (the JAX package's own
kernel-vs-XLA tolerance, `tests/test_pallas_kernels.py:59`; both sides are
f32 with sums taken in different orders), retries equal, iterations within
1 (a member whose error sits near the 1e-6 exit may take one step more on
one side).  `tests/test_torch_cuda.py` compares the CUDA kernel with the
twin on a card.
"""

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

from precondition_tpu.ops import pth_root as jax_pth_root
from precondition_tpu.ops.pallas import newton_root as jax_newton_root
from precondition_tpu_torch.ops.kernels import newton_root

torch.set_num_threads(1)


def _psd_batch(rng, n, m, ridge=0.1):
  a = rng.randn(n, m, m).astype(np.float32)
  return (np.einsum("nij,nkj->nik", a, a) / m
          + ridge * np.eye(m, dtype=np.float32)[None]).astype(np.float32)


def _jax_max_evs(stats, pads, tol=1e-2):
  return np.asarray(jax.vmap(
      lambda s, d: jax_pth_root.power_iteration(
          s, padding_start=d, error_tolerance=tol,
          relative_tolerance=True)[1])(jnp.asarray(stats), jnp.asarray(pads)))


def _jax(stats, p, pads, prevs=None, max_evs=None, **kw):
  roots, met = jax_newton_root.batched_inverse_pth_root_pallas(
      jnp.asarray(stats), p, jnp.asarray(pads),
      prevs=None if prevs is None else jnp.asarray(prevs),
      max_evs=None if max_evs is None else jnp.asarray(max_evs),
      interpret=True, **kw)
  return np.asarray(roots), jax.tree.map(np.asarray, met)


def _port(stats, p, pads, prevs=None, max_evs=None, fn=None, **kw):
  fn = fn or newton_root.batched_inverse_pth_root
  t = lambda x: None if x is None else torch.from_numpy(np.array(x))
  roots, met = fn(t(stats), p, t(pads).to(torch.int32), prevs=t(prevs),
                  max_evs=t(max_evs), **kw)
  return roots.numpy(), met.map(lambda x: x.numpy())


def _assert_parity(ours, ref, rtol=1e-3, atol=1e-5):
  (r_o, m_o), (r_r, m_r) = ours, ref
  np.testing.assert_allclose(r_o, r_r, rtol=rtol, atol=atol)
  np.testing.assert_array_equal(m_o.retries, m_r.retries)
  np.testing.assert_allclose(m_o.iterations, m_r.iterations, atol=1)
  np.testing.assert_allclose(m_o.max_eigenvalue, m_r.max_eigenvalue,
                             rtol=1e-6)


def _slice(jax_metrics, sl):
  return jax.tree.map(lambda x: x[sl], jax_metrics)


def _true_residual(stats, roots, met, p, relative=True):
  """Per member ``max|H^p (A + r_eff I) - I|`` in f64, ``r_eff`` the ridge
  of the ladder round that produced the root, and the f32 bound
  ``100 * eps * p * cond(A + r_eff I)`` (the JAX package's
  `test_true_residual_ill_conditioned` bound)."""
  m = stats.shape[-1]
  scale = met.max_eigenvalue.astype(np.float64) if relative else 1.0
  eff = 1e-6 * scale * 10.0 ** np.maximum(met.retries - 1.0, 0.0)
  d = stats.astype(np.float64) + eff[:, None, None] * np.eye(m)
  h = roots.astype(np.float64)
  hp = np.broadcast_to(np.eye(m), h.shape)
  for _ in range(p):
    hp = hp @ h
  resid = np.abs(hp @ d - np.eye(m)).max(axis=(1, 2))
  ev = np.linalg.eigvalsh(d)
  return resid, 100 * 1.2e-7 * p * ev[:, -1] / ev[:, 0]


def _assert_ill_conditioned_parity(stats, p, ours, ref, relative=True):
  """Parity where cond(A + rI) >= 1e6.  Two f32 solves of such a problem
  agree only up to rounding amplified by the conditioning, so, as the JAX
  package's own tests do for these inputs, each side's root is held to
  its true f64 residual bound instead of to the other's root; ladder
  rounds must be equal and iterations within 1."""
  for roots, met in (ours, ref):
    resid, bound = _true_residual(stats, roots, met, p, relative)
    assert np.all(resid < np.maximum(bound, 1e-3)), (resid, bound)
  np.testing.assert_array_equal(ours[1].retries, ref[1].retries)
  np.testing.assert_allclose(ours[1].iterations, ref[1].iterations, atol=1)


def _both(stats, p, pads, prevs=None, max_evs=None):
  """Runs both packages on one input, with JAX's eigenvalues for both."""
  if max_evs is None:
    max_evs = _jax_max_evs(stats, pads)
  return (_port(stats, p, pads, prevs, max_evs),
          _jax(stats, p, pads, prevs, max_evs))


class TestNewtonRootTwin:

  @pytest.mark.parametrize("p", [2, 4, 8])
  def test_cold_matches_jax(self, p):
    rng = np.random.RandomState(p)
    n, m = 12, 16
    stats = _psd_batch(rng, n, m)
    pads = np.full((n,), m, np.int32)
    ours, ref = _both(stats, p, pads)
    _assert_parity(ours, ref)
    assert ours[1].error.max() < 1e-4

  @pytest.mark.parametrize("cond", [1e2, 1e6])
  def test_true_residual_ill_conditioned(self, cond):
    """|H^p (A + r I) - I|, recomputed in f64, tracks the self-report."""
    rng = np.random.RandomState(int(np.log10(cond)))
    n, m, p = 4, 32, 4
    mats = []
    for _ in range(n):
      q = scipy.stats.ortho_group.rvs(m, random_state=rng)
      e = np.logspace(0, np.log10(cond), m)
      mats.append((q * e) @ q.T)
    stats = np.stack(mats).astype(np.float32)
    pads = np.full((n,), m, np.int32)
    ours, ref = _both(stats, p, pads)
    resid, _ = _true_residual(stats, *ours, p)
    # f32 storage of H alone costs ~eps*p*cond; allow 100x headroom.
    assert resid.max() < max(100 * 1.2e-7 * p * cond, 1.0), resid
    if cond < 1e6:
      _assert_parity(ours, ref)
    else:
      _assert_ill_conditioned_parity(stats, p, ours, ref)

  @pytest.mark.parametrize("n", [1, 5])
  def test_batch_sizes(self, n):
    """Batches that are not a multiple of the JAX tile (the port has none)."""
    rng = np.random.RandomState(1)
    m = 16
    stats = _psd_batch(rng, n, m)
    pads = np.full((n,), m, np.int32)
    ours, ref = _both(stats, 4, pads)
    assert ours[0].shape == (n, m, m) and ours[1].error.shape == (n,)
    _assert_parity(ours, ref)

  def test_padding_masks(self):
    """Mixed valid sizes, including a pure-padding member."""
    rng = np.random.RandomState(2)
    n, m = 8, 16
    stats = _psd_batch(rng, n, m)
    sizes = [16, 12, 8, 0, 16, 4, 16, 16]
    for i, d in enumerate(sizes):
      stats[i, d:, :] = 0.0
      stats[i, :, d:] = 0.0
    pads = np.asarray(sizes, np.int32)
    ours, ref = _both(stats, 4, pads)
    _assert_parity(ours, ref)
    np.testing.assert_array_equal(ours[0][3], 0.0)
    assert ours[1].error[3] == 0.0

  def test_warm_start_parity_and_fewer_iters(self):
    rng = np.random.RandomState(3)
    n, m = 8, 16
    stats = _psd_batch(rng, n, m)
    pads = np.full((n,), m, np.int32)
    cold, _ = _jax(stats, 4, pads)
    drifted = (0.999 * stats + 0.001 * _psd_batch(
        np.random.RandomState(4), n, m)).astype(np.float32)
    ours, ref = _both(drifted, 4, pads, prevs=cold)
    _assert_parity(ours, ref, atol=1e-4)
    _, cold_met = _port(drifted, 4, pads, max_evs=_jax_max_evs(drifted, pads))
    assert ours[1].iterations.max() < cold_met.iterations.max()
    assert ours[1].error.max() < 1e-4

  def test_garbage_prev_falls_back_to_cold(self):
    rng = np.random.RandomState(5)
    n, m = 4, 16
    stats = _psd_batch(rng, n, m)
    pads = np.full((n,), m, np.int32)
    garbage = (rng.randn(n, m, m) * 100.0).astype(np.float32)
    ours, ref = _both(stats, 4, pads, prevs=garbage)
    _assert_parity(ours, ref)
    cold = _port(stats, 4, pads, max_evs=_jax_max_evs(stats, pads))
    np.testing.assert_allclose(ours[0], cold[0], rtol=1e-5, atol=1e-7)
    assert ours[1].error.max() < 1e-4

  def test_odd_exponent_warm_is_cold(self):
    """Odd p cannot form C = prev^{p/2}; prevs must be ignored."""
    rng = np.random.RandomState(6)
    n, m = 4, 16
    stats = _psd_batch(rng, n, m)
    pads = np.full((n,), m, np.int32)
    prev = np.broadcast_to(np.eye(m, dtype=np.float32), (n, m, m)).copy()
    max_evs = _jax_max_evs(stats, pads)
    with_prev = _port(stats, 3, pads, prevs=prev, max_evs=max_evs)
    without = _port(stats, 3, pads, max_evs=max_evs)
    np.testing.assert_array_equal(with_prev[0], without[0])
    _assert_parity(with_prev, _jax(stats, 3, pads, prevs=prev,
                                   max_evs=max_evs))

  def test_retry_ladder_ill_conditioned(self):
    """A near-singular member escalates its ridge; the others match."""
    rng = np.random.RandomState(7)
    n, m = 8, 16
    stats = _psd_batch(rng, n, m, ridge=0.05)
    q, _ = np.linalg.qr(rng.randn(m, m))
    stats[0] = (q * np.logspace(0, -12, m)).dot(q.T).astype(np.float32)
    pads = np.full((n,), m, np.int32)
    (roots, met), (roots_j, met_j) = _both(stats, 4, pads)
    assert np.all(np.isfinite(roots))
    np.testing.assert_array_equal(met.retries, met_j.retries)
    np.testing.assert_allclose(roots[1:], roots_j[1:], rtol=1e-3, atol=1e-5)

  @pytest.mark.parametrize("p", [2, 4])
  def test_retry_ladder_escalates(self, p):
    """A rank-4 Gram with eigenvalues 1e4 and an absolute ridge of 1e-6
    (cond 1e10) fails its first rounds with error ~1; the ladder raises
    the ridge x10 until the solve converges, the same rounds as JAX.  A
    second member has cond 1e6 and converges in round 0."""
    rng = np.random.RandomState(8)
    n, m = 4, 16
    stats = _psd_batch(rng, n, m)
    q, _ = np.linalg.qr(rng.randn(m, m))
    stats[0] = (q * np.r_[1e4 * np.ones(4), np.zeros(m - 4)]).dot(q.T)
    stats[1] = (1e3 * (q * np.logspace(0, -6, m))).dot(q.T)
    pads = np.full((n,), m, np.int32)
    kw = dict(relative_matrix_epsilon=False)
    ours = _port(stats, p, pads, **kw)
    ref = _jax(stats, p, pads, **kw)
    assert ours[1].retries[0] > 1
    assert ours[1].error.max() < 0.05
    _assert_ill_conditioned_parity(
        stats[:2], p, (ours[0][:2], ours[1].map(lambda x: x[:2])),
        (ref[0][:2], _slice(ref[1], slice(0, 2))), relative=False)
    _assert_parity((ours[0][2:], ours[1].map(lambda x: x[2:])),
                   (ref[0][2:], _slice(ref[1], slice(2, None))))


class TestExternalMaxEv:

  @pytest.mark.parametrize("warm", [False, True])
  def test_external_maxev_parity(self, warm):
    rng = np.random.RandomState(11)
    n, m = 10, 16
    stats = _psd_batch(rng, n, m)
    pads = np.full((n,), m, np.int32)
    prevs = _port(stats, 4, pads)[0] if warm else None
    # The port's own fallback eigenvalues equal an explicit call of its
    # power iteration with the same loose 1% exit: bit-identical results.
    t = torch.from_numpy
    max_evs = newton_root.pth_root.power_iteration(
        t(stats), padding_starts=t(pads), error_tolerance=1e-2,
        relative_tolerance=True)[1].numpy()
    ext = _port(stats, 4, pads, prevs, max_evs)
    wrapper = _port(stats, 4, pads, prevs)
    np.testing.assert_array_equal(ext[0], wrapper[0])
    np.testing.assert_array_equal(ext[1].max_eigenvalue,
                                  wrapper[1].max_eigenvalue)
    assert ext[1].error.max() < 1e-4
    # Against the JAX wrapper with its own eigenvalues: the two start
    # vectors differ (torch cannot draw JAX's bits), so the loose-exit
    # estimates differ within the 1% exit and so do the ridges; roots
    # still agree at rtol 1e-3.
    np.testing.assert_allclose(wrapper[0], _jax(stats, 4, pads, prevs)[0],
                               rtol=1e-3, atol=1e-5)

  def test_underestimated_maxev_still_converges(self):
    """A 100x underestimated lambda_max still meets tolerance."""
    rng = np.random.RandomState(13)
    n, m = 6, 16
    stats = _psd_batch(rng, n, m)
    pads = np.full((n,), m, np.int32)
    true_evs = _jax_max_evs(stats, pads, tol=1e-6)
    ours, ref = _both(stats, 4, pads, max_evs=true_evs * 0.01)
    assert ours[1].error.max() < 1e-4
    _assert_parity(ours, ref)
    exact = _port(stats, 4, pads, max_evs=true_evs)
    # A 100x smaller ridge moves the root only at the ridge's own scale.
    np.testing.assert_allclose(ours[0], exact[0], rtol=1e-2, atol=1e-4)

  def test_external_maxev_with_mixed_padding(self):
    rng = np.random.RandomState(12)
    n, m = 6, 16
    stats = _psd_batch(rng, n, m)
    sizes = [16, 8, 0, 16, 12, 16]
    for i, d in enumerate(sizes):
      stats[i, d:, :] = 0.0
      stats[i, :, d:] = 0.0
    pads = np.asarray(sizes, np.int32)
    ours, ref = _both(stats, 4, pads, max_evs=_jax_max_evs(stats, pads, 1e-6))
    _assert_parity(ours, ref)
    np.testing.assert_array_equal(ours[0][2], 0.0)


class TestDispatch:

  def test_cpu_takes_the_twin_and_launches_nothing(self):
    rng = np.random.RandomState(0)
    stats = _psd_batch(rng, 3, 8)
    pads = np.full((3,), 8, np.int32)
    before = newton_root.LAUNCHES
    via_dispatch = _port(stats, 4, pads)
    plain = _port(stats, 4, pads,
                  fn=newton_root.batched_inverse_pth_root_plain)
    assert newton_root.LAUNCHES == before
    np.testing.assert_array_equal(via_dispatch[0], plain[0])

  def test_cuda_entry_refuses_a_cpu_tensor(self):
    with pytest.raises(ValueError, match="CUDA tensor"):
      newton_root.batched_inverse_pth_root_cuda(torch.eye(4)[None], 4)

  @pytest.mark.parametrize("m", [0, newton_root.MAX_M + 1])
  def test_matrix_size_outside_the_kernel_range_raises(self, m):
    with pytest.raises(ValueError, match="outside"):
      newton_root.batched_inverse_pth_root(torch.zeros(1, m, m), 4)

