"""Parity of the port's batched low-rank and FD roots with the JAX package.

Every function of `precondition_tpu_torch/ops/lowrank.py` against its
counterpart in `precondition_tpu/ops/lowrank.py` under `jax.vmap`, on the
same numpy-seeded inputs, padded members (``padding_start`` 0 among them)
included.  The port's power iteration is given JAX's start vector.

Tolerances and why:
* packing, unpacking and the precondition dimension: exact (copies);
* the QR factor of `frequent_directions_update`: ``R`` is defined up to
  the signs of its rows, so ``R R^T`` is compared, rtol 1e-5 with atol 1e-5
  of its largest entry (f32 Householder sweeps summed in another order);
* `low_rank_root` and `fd_update_root`: eigenvectors and singular vectors
  are defined up to sign, so packed buffers are compared after aligning
  each column's sign with JAX's, rtol 1e-4 with atol 1e-4 of the column's
  largest entry (two f32 LAPACK eigensolvers, or SVDs, agree to rounding
  amplified by the eigengaps of these inputs); scalars (tail, constant,
  lambda_max, errors) rtol 1e-4 with an atol of 1e-6 for the errors, which
  are f32 residuals at rounding level;
* the FD report: counts exact, the orthogonality error atol 1e-6 (a
  rounding residual of unit vectors), the rest rtol 1e-4 and atol 1e-4 of
  the field's largest value (products and sums of the same f32
  quantities);
* `apply_low_rank_preconditioner`: rtol 1e-5, atol 1e-6 of the largest
  entry (three f32 contractions in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from precondition_tpu.ops import lowrank as jax_lowrank
from precondition_tpu_torch.ops import lowrank
from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.utils import diagnostics

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_start_vector(monkeypatch):
  v0 = lambda n: np.array(jax.random.uniform(
      jax.random.PRNGKey(1729), (n,), jnp.float32, -1.0, 1.0))
  monkeypatch.setattr(
      pth_root, "default_v0",
      lambda n, dtype=torch.float32, device=None: torch.from_numpy(
          v0(n)).to(dtype=dtype, device=device))


def _psd(rng, n, d, pads):
  """Well-conditioned PSD members with distinct eigenvalues, zero beyond
  each member's padding start."""
  a = rng.randn(n, d, 2 * d).astype(np.float32)
  mats = (np.einsum("nij,nkj->nik", a, a) / (2 * d)
          + 0.1 * np.eye(d)).astype(np.float32)
  for i, p in enumerate(pads):
    mats[i, p:, :] = 0.0
    mats[i, :, p:] = 0.0
  return mats


def _align(ours, ref, k):
  """``ours`` with each of its first k columns' sign taken from ``ref``."""
  ours = ours.copy()
  dots = np.einsum("nik,nik->nk", ours[:, :, :k], ref[:, :, :k])
  ours[:, :, :k] *= np.where(dots < 0, -1.0, 1.0)[:, None, :]
  return ours


def _assert_packed_close(ours, ref, k, err_msg=""):
  ours = _align(np.asarray(ours), np.asarray(ref), k)
  scale = np.abs(ref).max(axis=1, keepdims=True)
  assert np.all(np.abs(ours - ref) <= 1e-4 * np.abs(ref) + 1e-4 * scale), (
      err_msg, np.abs(ours - ref).max())


@pytest.mark.parametrize("rank,dim", [(0, 10), (3, 10), (-3, 10), (8, 10),
                                      (7, 10), (1, 3), (32, 128), (32, 34)])
def test_precond_dim_and_should_compress_match_jax(rank, dim):
  assert lowrank.precond_dim(rank, dim) == jax_lowrank.precond_dim(rank, dim)
  assert (lowrank.should_compress(rank, dim)
          == jax_lowrank.should_compress(rank, dim))


def test_pack_and_unpack_match_jax():
  rng = np.random.RandomState(0)
  n, d, r = 4, 9, 3
  vecs = rng.randn(n, d, r).astype(np.float32)
  defl, inv = rng.rand(2, n, r).astype(np.float32)
  const, tail = rng.rand(2, n).astype(np.float32)
  flags = np.array([True, False, True, False])
  ref = jax.vmap(lambda *a: jax_lowrank.fd_pack(*a, r))(
      vecs, defl, inv, const, tail, flags)
  t = torch.from_numpy
  ours = lowrank.fd_pack(t(vecs), t(defl), t(inv), t(const), t(tail),
                         t(flags), r)
  np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
  for got, want in zip(lowrank.fd_unpack(ours, r),
                       jax.vmap(lambda b: jax_lowrank.fd_unpack(b, r))(ref),
                       strict=True):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  low = lowrank.low_rank_pack(t(vecs), t(inv), t(const), -r)
  np.testing.assert_array_equal(
      low.numpy(), np.asarray(jax.vmap(
          lambda v, e, c: jax_lowrank.low_rank_pack(v, e, c, -r))(
              vecs, inv, const)))
  for got, want in zip(lowrank.low_rank_unpack(low, -r), (vecs, inv, const,
                                                          np.zeros(n, bool))):
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,axis", [((5, 7), 0), ((5, 7), 1),
                                        ((7, 5), 0), ((4, 3, 6), 1),
                                        ((8,), 0)])
def test_frequent_directions_update_matches_jax(shape, axis):
  rng = np.random.RandomState(1)
  g = rng.randn(3, *shape).astype(np.float32)
  ref = np.stack([np.asarray(jax_lowrank.frequent_directions_update(
      None, jnp.asarray(x), axis, 0.0, 0.0)) for x in g])
  ours = lowrank.frequent_directions_update(torch.from_numpy(g), axis).numpy()
  assert ours.shape == ref.shape == (3, shape[axis], shape[axis])
  gram = lambda r: np.einsum("nij,nkj->nik", r, r)
  np.testing.assert_allclose(gram(ours), gram(ref), rtol=1e-5,
                             atol=1e-5 * np.abs(gram(ref)).max())
  x = np.moveaxis(g, axis + 1, 1).reshape(3, shape[axis], -1).astype(
      np.float64)
  np.testing.assert_allclose(gram(ours), np.einsum("nij,nkj->nik", x, x),
                             rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rank", [3, -3, 1])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("relative", [True, False],
                         ids=["relative", "absolute"])
def test_low_rank_root_matches_jax(rank, p, relative):
  rng = np.random.RandomState(2)
  d = 12
  pads = np.array([12, 8, 0, 6, 12, 10], np.int32)
  mats = _psd(rng, len(pads), d, pads)
  kw = dict(ridge_epsilon=1e-4, relative_matrix_epsilon=relative)
  ref, m_ref = jax.vmap(lambda m, s: jax_lowrank.low_rank_root(
      m, p, rank, padding_start=s, **kw))(mats, pads)
  ours, m_ours = lowrank.low_rank_root(
      torch.from_numpy(mats), p, rank, padding_starts=torch.from_numpy(pads),
      **kw)
  assert ours.shape == (len(pads), d, abs(rank) + 2)
  _assert_packed_close(ours.numpy(), np.asarray(ref), abs(rank))
  np.testing.assert_array_equal(ours[pads == 0].numpy(), 0.0)
  np.testing.assert_allclose(m_ours.max_eigenvalue.numpy(),
                             m_ref.max_eigenvalue, rtol=1e-4)
  np.testing.assert_allclose(m_ours.error.numpy(), m_ref.error, rtol=1e-4,
                             atol=1e-6)
  # The packed operator U diag(inv) U^T + const (I - U U^T) in one piece.
  u, inv, const, _ = lowrank.low_rank_unpack(ours, rank)
  op = (torch.einsum("nik,nk,njk->nij", u, inv, u) + const[:, None, None]
        * (torch.eye(d) - torch.einsum("nik,njk->nij", u, u)))
  ju, jinv, jconst, _ = jax.vmap(lambda b: jax_lowrank.low_rank_unpack(
      b, rank))(ref)
  jop = (np.einsum("nik,nk,njk->nij", ju, jinv, ju) + np.asarray(jconst)[
      :, None, None] * (np.eye(d) - np.einsum("nik,njk->nij", ju, ju)))
  np.testing.assert_allclose(op.numpy(), jop, rtol=1e-4,
                             atol=1e-4 * np.abs(jop).max())


def test_low_rank_root_refuses_a_size_it_does_not_compress():
  with pytest.raises(ValueError):
    lowrank.low_rank_root(torch.eye(5)[None], 2, 3)


def _fd_inputs(rng, n, d, pads, rank_of_grad):
  """Cholesky factors of rank ``rank_of_grad`` Gram matrices, padded."""
  out = np.zeros((n, d, d), np.float32)
  for i, p in enumerate(pads):
    g = rng.randn(p, rank_of_grad).astype(np.float32)
    r = np.linalg.qr(g.T, mode="r").T if p else np.zeros((0, 0))
    out[i, :p, :r.shape[1]] = r
  return out


def _assert_reports_close(ours, ref):
  for f in dataclasses.fields(ours):
    got = getattr(ours, f.name).numpy()
    want = np.asarray(getattr(ref, f.name))
    if f.name.startswith(("num_", "size_")):
      np.testing.assert_array_equal(got, want, err_msg=f.name)
    elif f.name == "max_ortho_err":
      np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f.name)
    else:
      np.testing.assert_allclose(
          got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(initial=0.0),
          err_msg=f.name)


@pytest.mark.parametrize("case", [
    dict(rank=3, decay=0.99),
    dict(rank=3, decay=1.0, relative=False),
    dict(rank=2, decay=0.75),
], ids=["decayed", "absolute-ridge", "rank-2"])
def test_fd_update_root_matches_jax(case):
  """Three FD steps from a zero sketch, with the FD report.  A member of
  size 1 has fewer nonzero singular values than the rank, so its zero
  deflated eigenvalues drive the guards: their vectors are dropped and
  counted; a member of size 0 is all zeros."""
  rng = np.random.RandomState(3)
  d, rank = 12, case["rank"]
  pads = np.array([12, 9, 0, 1, 12, 5], np.int32)
  kw = dict(ridge_epsilon=1e-6, decay=case["decay"],
            relative_matrix_epsilon=case.get("relative", True))
  prev_ref = np.zeros((len(pads), d, rank + 2), np.float32)
  prev = torch.from_numpy(prev_ref)
  live = pads > 0  # JAX's report divides by a zero padding start there.
  for step in range(3):
    grads = _fd_inputs(rng, len(pads), d, pads, d)
    prev_ref, m_ref = jax.vmap(lambda g, w, s: jax_lowrank.fd_update_root(
        g, 4, rank, padding_start=s, prev=w, generate_fd_metrics=True,
        **kw))(grads, prev_ref, pads)
    prev, m_ours = lowrank.fd_update_root(
        torch.from_numpy(grads), 4, rank, prev,
        padding_starts=torch.from_numpy(pads), generate_fd_metrics=True, **kw)
    _assert_packed_close(prev.numpy(), np.asarray(prev_ref), rank,
                         f"step {step}")
    np.testing.assert_array_equal(prev[pads == 0].numpy(), 0.0)
    np.testing.assert_array_equal(m_ours.error.numpy(), 0.0)
    np.testing.assert_allclose(m_ours.max_eigenvalue.numpy(),
                               m_ref.max_eigenvalue, rtol=1e-4)
    _assert_reports_close(m_ours.fd.map(lambda x: x[live]),
                          jax.tree.map(lambda x: np.asarray(x)[live],
                                       m_ref.fd))
    assert isinstance(m_ours.fd, diagnostics.FDDiagnostics)
    assert (m_ours.fd.num_zero_initial_eigs[pads == 1] > 0).all()


@pytest.mark.parametrize("block", [(), (5,), (3, 4)], ids=["1d", "2d", "3d"])
def test_apply_low_rank_preconditioner_matches_jax(block):
  rng = np.random.RandomState(4)
  n, d, r = 4, 10, 3
  q = np.linalg.qr(rng.randn(n, d, r))[0].astype(np.float32)
  bufs = np.array(jax.vmap(lambda v, e, c, z: jax_lowrank.fd_pack(
      v, e, e, c, 0.0, z, r))(q, rng.rand(n, r).astype(np.float32),
                              rng.rand(n).astype(np.float32),
                              np.array([False, True, False, False])))
  g = rng.randn(n, d, *block).astype(np.float32)
  ref = np.asarray(jax.vmap(lambda x, b: jax_lowrank
                            .apply_low_rank_preconditioner(x, b, r))(g, bufs))
  ours = lowrank.apply_low_rank_preconditioner(
      torch.from_numpy(g), torch.from_numpy(bufs), r).numpy()
  assert ours.shape == ref.shape
  np.testing.assert_allclose(ours, ref, rtol=1e-5,
                             atol=1e-6 * np.abs(ref).max())
