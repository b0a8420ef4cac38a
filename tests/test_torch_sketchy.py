"""Parity of the port's tearfree Sketchy with the JAX package's.

The same seeded numpy gradients go through `precondition_tpu.tearfree.
sketchy` and the port's `tearfree.sketchy`, a few steps, under each option
(plain, ``linear_approx_tail``, ``add_ggt``, ``memory_alloc``,
``ekfac_svd`` with ``update_freq`` 2).  Singular vectors are defined up to
sign, so a sketch is compared as the operators it applies, ``U diag(x)
U^T`` for its eigenvalues and their inverse roots.  The gradients have
full rank and distinct singular values, so no tie leaves the basis to the
LAPACK build (`PERF.md` §6, "Ties").

Tolerances and why:
* updates rtol 1e-3, atol 1e-4 * max|u|: a QR and an SVD in f32 on each
  side, then three contractions;
* sketch operators rtol 1e-3, atol 1e-5 * max|x|, and the scalars (tail,
  its inverse root) rtol 1e-4: singular values of f32 factorizations;
* ``ema_ggt`` rtol 1e-5: one f32 Gram product and EMA per step;
* the full-rank oracle keeps the JAX suite's own tolerance
  (`tests/test_tearfree.py:350-381`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precondition_tpu.tearfree import sketchy as jax_sketchy
from precondition_tpu_torch.tearfree import shampoo
from precondition_tpu_torch.tearfree import sketchy
from precondition_tpu_torch.utils import convert

torch.set_num_threads(1)

_SHAPES = {"blk": {"w": (12, 20)}, "t": (6, 8, 10)}


def _tree(fn, shapes=_SHAPES):
  return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
          for k, v in shapes.items()}


_OPTIONS = {
    "plain": dict(rank=4),
    "linear-tail": dict(rank=4, linear_approx_tail=True),
    "add-ggt": dict(rank=4, add_ggt=True, second_moment_decay=0.9),
    "memory-alloc": dict(memory_alloc={"blk": {"w": [3, 5]},
                                       "t": [2, 4, 3]}),
    "ekfac-every-2": dict(rank=4, ekfac_svd=True, update_freq=2),
    "absolute-eps": dict(rank=4, relative_epsilon=False, epsilon=1e-3),
}
# EKFAC keeps all ``min(d, k + numel / d)`` singular vectors of an axis.
# Where the first step's gradient has fewer nonzero singular values (an
# axis with d^2 > numel, the wide axis of a rectangular matrix), the rest
# span a null space in whatever basis the SVD picks, at inverse roots of
# rounding-level values: the update does not see them, the state does.  So
# EKFAC's tree has a square matrix.
_EKFAC_SHAPES = {"blk": {"w": (12, 12)}, "t": (6, 8, 10)}


def _operator(u, x):
  return (u * x) @ u.T


def _assert_axis_close(got, ref, label):
  close = lambda a, b: np.testing.assert_allclose(
      a, b, rtol=1e-3, atol=1e-5 * np.abs(b).max(initial=0.0),
      err_msg=label)
  close(_operator(got.eigvecs, got.eigvals ** 2),
        _operator(ref.eigvecs, ref.eigvals ** 2))
  close(_operator(got.eigvecs, got.inv_eigvals),
        _operator(ref.eigvecs, ref.inv_eigvals))
  for f in ("tail", "inv_tail"):
    np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=1e-4,
                               err_msg=f"{label} {f}")
  if hasattr(ref.ema_ggt, "shape"):
    np.testing.assert_allclose(got.ema_ggt, ref.ema_ggt, rtol=1e-5,
                               atol=1e-6 * np.abs(ref.ema_ggt).max(),
                               err_msg=label)
  if hasattr(ref.svd_result_u, "shape"):
    close(_operator(got.svd_result_u, got.svd_result_s),
          _operator(ref.svd_result_u, ref.svd_result_s))
    np.testing.assert_allclose(got.inv_prev_tail, ref.inv_prev_tail,
                               rtol=1e-4, err_msg=label)


@pytest.mark.parametrize("name", list(_OPTIONS))
def test_sketchy_matches_jax(name):
  options = _OPTIONS[name]
  rng = np.random.RandomState(0)
  jax_tx = jax_sketchy.apply(jax_sketchy.Options(**options))
  port_tx = sketchy.apply(sketchy.Options(**options))
  shapes = _EKFAC_SHAPES if options.get("ekfac_svd") else _SHAPES
  params = _tree(lambda s: np.zeros(s, np.float32), shapes)
  js = jax_tx.init(jax.tree.map(jnp.asarray, params))
  ts = port_tx.init(convert.params_from_numpy(params, device="cpu"))
  update = jax.jit(jax_tx.update)
  for step in range(4):
    g = _tree(lambda s: rng.randn(*s).astype(np.float32), shapes)
    ju, js = update(jax.tree.map(jnp.asarray, g), js)
    tu, ts = port_tx.update(convert.params_from_numpy(g, device="cpu"), ts)
    assert ts.count == int(js.count)
    for path, want in convert._flatten(jax.tree.map(np.asarray, ju)):
      np.testing.assert_allclose(tu[path].numpy(), want, rtol=1e-3,
                                 atol=1e-4 * np.abs(want).max(),
                                 err_msg=f"{name} step {step} {path}")
    # The state of a tearfree chain without grafting and momentum.
    back = convert.tearfree_state_to_numpy(
        (ts, None, None),
        ((None, jax.tree.map(np.asarray, js), None), (), None))[0][1]
    for (path, got), (_, ref) in zip(
        convert._flatten(back.sketches),
        convert._flatten(jax.tree.map(np.asarray, js).sketches)):
      for i, (a, b) in enumerate(zip(got.axes, ref.axes, strict=True)):
        _assert_axis_close(a, b, f"{name} step {step} {path} axis {i}")


def test_full_rank_sketchy_matches_shampoo():
  """`tests/test_tearfree.py:350-381`: at full rank, Sketchy is Shampoo
  over sqrt(1 - decay) (10 at decay 0.99), from the second step on."""
  rng = np.random.RandomState(0)
  decay = 0.99
  params = {"w": torch.zeros(4, 5)}
  sk = sketchy.apply(sketchy.Options(second_moment_decay=decay,
                                     epsilon=0.0))
  sh = shampoo.apply(shampoo.Options(second_moment_decay=decay))
  sk_s, sh_s = sk.init(params), sh.init(params)
  for step in range(3):
    g = {"w": torch.from_numpy(rng.randn(4, 5).astype(np.float32))}
    sk_u, sk_s = sk.update(g, sk_s)
    sh_u, sh_s = sh.update(g, sh_s)
    if step == 0:
      # A rank-1 covariance: Sketchy inverts unmasked SVD noise that
      # Shampoo's relative cutoff zeroes.
      continue
    np.testing.assert_allclose(sh_u["w"].numpy() / 10.0, sk_u["w"].numpy(),
                               rtol=2.5e-2, atol=1e-3)


def test_fd_covariance_oracle():
  """`tests/test_tearfree.py:383-405`: at rank d the sketch's squared
  eigenvalues are the decayed covariance's."""
  rng = np.random.RandomState(3)
  d, decay = 6, 0.99
  base = rng.randn(d, 2)
  tx = sketchy.apply(sketchy.Options(rank=d, second_moment_decay=decay,
                                     epsilon=0.0))
  state = tx.init({"w": torch.zeros(d, 5)})
  cov = np.zeros((d, d))
  for _ in range(3):
    g = (base @ rng.randn(2, 5)).astype(np.float32)
    _, state = tx.update({"w": torch.from_numpy(g)}, state)
    cov = decay * cov + g.astype(np.float64) @ g.T
  got = np.sort(state.sketches["w"].axes[0].eigvals.numpy() ** 2)[::-1]
  want = np.sort(np.linalg.eigvalsh(cov))[::-1][:len(got)]
  np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_non_finite_gradient_gives_nan_sketch_without_raising():
  """JAX's `_safe_svd` returns NaN for a non-finite operand; the port does
  too, where torch's SVD would raise."""
  tx = sketchy.apply(sketchy.Options(rank=2))
  state = tx.init({"w": torch.zeros(4, 6)})
  g = torch.ones(4, 6)
  g[1, 2] = torch.nan
  _, state = tx.update({"w": g}, state)
  for axis in state.sketches["w"].axes:
    assert bool(torch.isnan(axis.eigvecs).all())
    assert bool(torch.isnan(axis.eigvals).all())


def test_validation():
  for bad in (dict(rank=0), dict(update_freq=0),
              dict(second_moment_decay=-0.1)):
    with pytest.raises(ValueError):
      sketchy.apply(sketchy.Options(**bad))
  with pytest.raises(ValueError, match="unit"):
    sketchy.apply(sketchy.Options()).init({"w": torch.zeros(3, 1)})
