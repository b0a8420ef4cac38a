"""Parity of the port's tearfree modules with the JAX package's.

The same seeded numpy inputs go through `precondition_tpu.tearfree` and
`precondition_tpu_torch.tearfree`: the reshaper, momentum, every grafting
type (Adafactor against `optax.adafactor` as the JAX package runs it),
`batched_spectral_projector`, the blocked layout, and blocked Shampoo
under each root backend.

The JAX package picks its Newton roots by backend: on a TPU the Pallas
kernel with lambda_max from its own `_batched_max_evs`, elsewhere the
per-matrix solver.  The port always takes the first (the CUDA kernel on a
card, its plain twin here).  So ``newton`` and ``filtered`` are held to
JAX's accelerator branch, run as the JAX package's Pallas tests run it:
`precondition_tpu.tearfree.shampoo` sees a `jax` whose `default_backend`
is "tpu", and the kernel runs in Pallas interpret mode, at sizes its gate
admits (m in {8, 16, 32}).  ``eigh`` and ``auto`` are held to JAX's CPU
branch, unpatched.  The port's power iteration takes JAX's start vector.

The test trees' blocks are rectangular, so every statistic is either well
conditioned or rank-deficient with a clean gap: no eigenvalue of a
statistic sits near the 1e-6 relative clip, where eigh and the projector
decide by rounding.

Tolerances and why:
* reshapes and blocked layouts exact: they move values only;
* momentum and grafting rtol 1e-6 (SGD, RMSProp, momentum) and 1e-5
  (Adafactor: means, powers and norms in f32, in another order);
* projectors atol 1e-5: 90 f32 products on each side;
* roots rtol 1e-3, atol 1e-5 * max|root|: the kernel tolerance of
  `tests/test_pallas_kernels.py:59`, here for eigh too (two f32
  eigendecompositions);
* statistics rtol 1e-5, atol 1e-6 * max|S|: one f32 Gram product and EMA
  per step;
* updates rtol 1e-3, atol 1e-4 * max|u|: they carry the roots' agreement
  through the preconditioning contraction;
* the JAX suite's own filtered cases keep its bound, max-abs within 0.05
  of the largest eigh root (`tests/test_tearfree.py:159-230`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from precondition_tpu.ops import pth_root as jax_pth_root
from precondition_tpu.ops.pallas import newton_root as jax_newton_root
from precondition_tpu.tearfree import grafting as jax_grafting
from precondition_tpu.tearfree import momentum as jax_momentum
from precondition_tpu.tearfree import reshaper as jax_reshaper
from precondition_tpu.tearfree import shampoo as jax_shampoo
from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.kernels import newton_root
from precondition_tpu_torch.tearfree import grafting
from precondition_tpu_torch.tearfree import momentum
from precondition_tpu_torch.tearfree import reshaper
from precondition_tpu_torch.tearfree import shampoo

torch.set_num_threads(1)


def _t(x):
  return torch.from_numpy(np.array(x))


def _np_tree(tree):
  return {n: np.asarray(v) for n, v in tree.items()}


def _jax_v0(n, dtype=torch.float32, device=None):
  v0 = jax.random.uniform(jax.random.PRNGKey(1729), (n,), jnp.float32, -1.0,
                          1.0)
  return torch.from_numpy(np.array(v0)).to(dtype=dtype, device=device)


class _TpuJax:
  """`jax` as a module sees it on a TPU: `default_backend` says "tpu"."""

  def __getattr__(self, name):
    return getattr(jax, name)

  @staticmethod
  def default_backend():
    return "tpu"


@pytest.fixture
def jax_accelerator_branch(monkeypatch):
  """JAX tearfree's TPU branch, its kernel in interpret mode; JAX's power
  iteration start vector for the port."""
  monkeypatch.setattr(jax_shampoo, "jax", _TpuJax())
  monkeypatch.setattr(
      jax_newton_root, "batched_inverse_pth_root_pallas",
      functools.partial(jax_newton_root.batched_inverse_pth_root_pallas,
                        interpret=True))
  monkeypatch.setattr(pth_root, "default_v0", _jax_v0)


@pytest.fixture
def jax_v0(monkeypatch):
  monkeypatch.setattr(pth_root, "default_v0", _jax_v0)


# ---------------------------------------------------------------- reshaper --

@pytest.mark.parametrize("shape,merge_dims,block_size", [
    ((2, 3, 5), 6, 4),      # merge to [6, 5], pad to [8, 8]
    ((1, 1), 4, 4),         # collapses to a scalar
    ((3, 10, 7), 1024, 0),  # merge only
    ((16, 3, 40), 32, 16),  # [16, 3, 40] -> pad 40 to 48
])
def test_reshaper_matches_jax_and_round_trips(shape, merge_dims,
                                              block_size):
  x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
  opts = dict(merge_dims=merge_dims, block_size=block_size)
  want, _ = jax_reshaper.merge(jax_reshaper.Options(**opts)).update(
      {"w": jnp.asarray(x)}, optax.MaskedNode(), {"w": jnp.asarray(x)})
  port_opts = reshaper.Options(**opts)
  params = {"w": _t(x)}
  got, _ = reshaper.merge(port_opts).update(params, None, params)
  np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
  back, _ = reshaper.unmerge(port_opts).update(got, None, params)
  np.testing.assert_array_equal(back["w"].numpy(), x)


def test_reshaper_validation():
  with pytest.raises(ValueError):
    reshaper.merge(reshaper.Options(merge_dims=1))
  with pytest.raises(ValueError):
    reshaper.merge(reshaper.Options(block_size=1))


# ---------------------------------------------------------------- momentum --

@pytest.mark.parametrize("opts", [
    dict(ema=False, nesterov=False),
    dict(ema=False, nesterov=True),
    dict(ema=True, nesterov=False),
    dict(ema=True, nesterov=True, weight_decay=0.1),
    dict(ema=False, nesterov=True, weight_decay=0.1,
         weight_decay_after_momentum=False),
    dict(momentum_decay=0.0, weight_decay=0.1),
], ids=["trace", "nesterov", "ema", "ema-nesterov-wd",
        "nesterov-wd-before", "no-momentum-wd"])
def test_momentum_matches_jax(opts):
  rng = np.random.RandomState(0)
  params = {"w": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}
  jax_tx = jax_momentum.apply(jax_momentum.Options(**opts))
  port_tx = momentum.apply(momentum.Options(**opts))
  jp = jax.tree.map(jnp.asarray, params)
  tp = {n: _t(v) for n, v in params.items()}
  js, ts = jax_tx.init(jp), port_tx.init(tp)
  for _ in range(3):
    g = {n: rng.randn(*v.shape).astype(np.float32) for n, v in params.items()}
    ju, js = jax_tx.update(jax.tree.map(jnp.asarray, g), js, jp)
    tu, ts = port_tx.update({n: _t(v) for n, v in g.items()}, ts, tp)
    for n in params:
      np.testing.assert_allclose(tu[n].numpy(), np.asarray(ju[n]),
                                 rtol=1e-6, atol=1e-7, err_msg=n)


def test_momentum_validation():
  with pytest.raises(ValueError):
    momentum.apply(momentum.Options(momentum_decay=-0.1))
  with pytest.raises(ValueError):
    momentum.apply(momentum.Options(weight_decay=-1.0))


# ---------------------------------------------------------------- grafting --

def _scale_direction(jax_side):
  """A direction transform: 7 * u (its state None / MaskedNode)."""
  if jax_side:
    tx = optax.scale(7.0)
    return jax_grafting.praxis_shim.ShardedGradientTransformation(
        tx.init, tx.update, lambda p: None)
  return grafting.GradientTransformation(
      lambda _: None,
      lambda u, s, p=None: ({n: 7.0 * v for n, v in u.items()}, s))


_GRAFTS = {
    "sgd": dict(grafting_type="SGD", second_moment_decay=0.0),
    "rmsprop": dict(grafting_type="RMSPROP", second_moment_decay=0.9),
    "adagrad": dict(grafting_type="RMSPROP", second_moment_decay=1.0,
                    epsilon=1e-8),
    "adafactor": dict(grafting_type="ADAFACTOR", second_moment_decay=0.8,
                      min_dim_size_to_factor=4, epsilon=1e-30),
    "adafactor-clip-2-no-scale": dict(
        grafting_type="ADAFACTOR", second_moment_decay=0.6,
        min_dim_size_to_factor=8, clipping_threshold=2.0,
        multiply_by_parameter_scale=False),
    "none": dict(grafting_type="NONE", second_moment_decay=0.0),
}


@pytest.mark.parametrize("name", list(_GRAFTS))
def test_grafting_matches_jax(name):
  """Every grafting type around a 7 * u direction, with skip masks (a
  vector and a dim above 8), the start step at 2 and 4 steps."""
  opts = dict(_GRAFTS[name])
  kind = opts.pop("grafting_type")
  common = dict(start_preconditioning_step=2,
                skip_preconditioning_any_dim_gt=8, **opts)
  jax_tx = jax_grafting.graft(
      jax_grafting.Options(jax_grafting.GraftingType[kind], **common),
      _scale_direction(True))
  port_tx = grafting.graft(
      grafting.Options(grafting.GraftingType[kind], **common),
      _scale_direction(False))
  rng = np.random.RandomState(1)
  shapes = {"b": (6,), "w": (5, 8), "big": (4, 12), "t": (2, 4, 6)}
  params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
  jp = jax.tree.map(jnp.asarray, params)
  tp = {n: _t(v) for n, v in params.items()}
  js, ts = jax_tx.init(jp), port_tx.init(tp)
  rtol = 1e-5 if "adafactor" in name else 1e-6
  for step in range(4):
    g = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    ju, js = jax_tx.update(jax.tree.map(jnp.asarray, g), js, jp)
    tu, ts = port_tx.update({n: _t(v) for n, v in g.items()}, ts, tp)
    for n in shapes:
      want = np.asarray(ju[n])
      np.testing.assert_allclose(tu[n].numpy(), want, rtol=rtol,
                                 atol=rtol * np.abs(want).max(),
                                 err_msg=f"{name} step {step} {n}")


@pytest.mark.parametrize("opts", [
    dict(min_dim_size_to_factor=4, second_moment_decay=0.8),
    dict(min_dim_size_to_factor=128, second_moment_decay=0.5),
], ids=["factored", "unfactored"])
def test_adafactor_matches_optax(opts):
  """The port's Adafactor against `optax.adafactor` as the JAX package's
  `grafting._adafactor` chains it, state included."""
  options = dict(grafting_type=grafting.GraftingType.ADAFACTOR, **opts)
  jax_tx = jax_grafting._adafactor(jax_grafting.Options(
      jax_grafting.GraftingType.ADAFACTOR, **opts))
  port_tx = grafting._adafactor(grafting.Options(**options))
  rng = np.random.RandomState(2)
  shapes = {"m": (6, 10), "v": (7,), "t": (5, 3, 9)}
  params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
  jp = jax.tree.map(jnp.asarray, params)
  tp = {n: _t(v) for n, v in params.items()}
  js, ts = jax_tx.init(jp), port_tx.init(tp)
  for _ in range(3):
    g = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    ju, js = jax_tx.update(jax.tree.map(jnp.asarray, g), js, jp)
    tu, ts = port_tx.update({n: _t(v) for n, v in g.items()}, ts, tp)
    fs = js[0][0]
    for n in shapes:
      np.testing.assert_allclose(tu[n].numpy(), np.asarray(ju[n]), rtol=1e-5,
                                 atol=1e-6, err_msg=n)
      for field in ("v_row", "v_col", "v"):
        got = getattr(ts, field)[n]
        if got is not None:
          np.testing.assert_allclose(got.numpy(),
                                     np.asarray(getattr(fs, field)[n]),
                                     rtol=1e-5, err_msg=f"{n} {field}")
    assert ts.count == int(fs.count)


def test_grafting_skip_masks_and_validation():
  opts = grafting.Options(grafting_type=grafting.GraftingType.SGD,
                          skip_preconditioning_any_dim_gt=4)
  kept = grafting._mask_skipped(opts, {"a": torch.zeros(3),
                                       "b": torch.zeros(2, 8),
                                       "c": torch.zeros(2, 2)})
  assert list(kept) == ["c"]
  with pytest.raises(ValueError):
    grafting._validate(grafting.Options(
        grafting_type=grafting.GraftingType.RMSPROP, second_moment_decay=0.0))
  with pytest.raises(ValueError):
    grafting._validate(grafting.Options(
        grafting_type=grafting.GraftingType.ADAFACTOR,
        second_moment_decay=1.0))


# ------------------------------------------------------ spectral projector --

@pytest.mark.parametrize("case", ["wishart", "rank-deficient", "tiny"])
def test_spectral_projector_matches_jax(case):
  rng = np.random.RandomState(3)
  n, d = 4, 16
  a = rng.randn(n, d, d // 2 if case == "rank-deficient" else 2 * d)
  stats = np.einsum("nij,nkj->nik", a, a).astype(np.float32)
  if case == "tiny":
    stats *= 1e-8
  lam = np.linalg.eigvalsh(stats.astype(np.float64))[:, -1]
  thresholds = (1e-6 * lam).astype(np.float32)
  want = np.asarray(jax_pth_root.batched_spectral_projector(
      jnp.asarray(stats), jnp.asarray(thresholds)))
  got = pth_root.batched_spectral_projector(_t(stats), _t(thresholds))
  np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
  # A projector: eigenvalues in [0, 1], P^2 = P on the resolved spectrum.
  ev = np.linalg.eigvalsh(got.numpy().astype(np.float64))
  assert ev.min() > -1e-4 and ev.max() < 1 + 1e-4
  rank = d // 2 if case == "rank-deficient" else d
  np.testing.assert_allclose(ev.sum(axis=1), rank, atol=1e-3)


# ----------------------------------------------------------- blocked layout --

@pytest.mark.parametrize("shape,bs", [
    ((3, 2), 5),          # no large axes
    ((5, 2), 5),          # one large axis at 0
    ((2, 10), 5),         # one large axis at 1
    ((15, 2, 10), 5),     # two large axes split by a middle
    ((3, 20, 25, 4), 5),  # two adjacent large axes
    ((10, 10), 5),
    ((5,), 5),
])
def test_blockify_matches_jax(shape, bs):
  x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
  jax_meta = jax_shampoo._blocks_meta(jax_shampoo.Options(block_size=bs),
                                      shape)
  meta = shampoo._blocks_meta(shampoo.Options(block_size=bs), shape)
  assert meta.num_blocks == jax_meta.num_blocks
  assert meta.blocks_axis == jax_meta.blocks_axis
  want = np.asarray(jax_shampoo._blockify(jnp.asarray(x), jax_meta))
  got = shampoo._blockify(_t(x), meta)
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(shampoo._deblockify(got, meta).numpy(), x)


def test_shape_validation():
  tx = shampoo.apply(shampoo.Options(block_size=4))
  with pytest.raises(ValueError, match="unit dim"):
    tx.init({"w": torch.zeros(3, 1)})
  with pytest.raises(ValueError, match="indivisible"):
    tx.init({"w": torch.zeros(6, 3)})
  with pytest.raises(ValueError, match="large dims"):
    tx.init({"w": torch.zeros(4, 4, 4)})
  for bad in (dict(block_size=1), dict(update_statistics_freq=0),
              dict(second_moment_decay=1.5), dict(solver_backend="nope")):
    with pytest.raises(ValueError):
      shampoo.apply(shampoo.Options(**bad))


# ------------------------------------------------------------ root backends --

def _rectangular_stats(rng, n, d, other):
  g = rng.randn(n, d, other).astype(np.float32)
  return np.einsum("nij,nkj->nik", g, g).astype(np.float32) / other


def _assert_roots_close(got, want):
  np.testing.assert_allclose(got, want, rtol=1e-3,
                             atol=1e-5 * np.abs(want).max())


@pytest.mark.usefixtures("jax_accelerator_branch")
@pytest.mark.parametrize("backend,d,other,p", [
    ("newton", 8, 32, 4), ("newton", 32, 64, 6),
    ("filtered", 8, 32, 4), ("filtered", 32, 64, 6),
    ("newton", 16, 64, 2), ("filtered", 16, 64, 2),
    ("filtered", 16, 8, 4), ("filtered", 32, 16, 4)])
def test_newton_backends_match_jax_accelerator_branch(backend, d, other, p):
  """Well-conditioned (other >= 2d) stacks, and for ``filtered``
  rank-deficient ones (other < d), small eigenvalues included (scaled by
  1e-3), at p = 4.  The plain ridge root of a rank-deficient statistic
  solves ``A + 1e-6 lambda_max I`` at a condition number near 1e6, where
  two f32 Newton solves differ by far more than 1e-3; the projector
  removes those directions, down to their rounding, which the root's
  ``1e3`` times larger null-space values at p = 2 lift above 1e-3."""
  rng = np.random.RandomState(d + other)
  cov = _rectangular_stats(rng, 3, d, other) * 1e-3
  fn = {"newton": "_newton_inv_root", "filtered": "_filtered_inv_root"}
  want = np.asarray(getattr(jax_shampoo, fn[backend])(p, jnp.asarray(cov)))
  launches = newton_root.LAUNCHES
  got = getattr(shampoo, fn[backend])(p, _t(cov)).numpy()
  _assert_roots_close(got, want)
  assert newton_root.LAUNCHES == launches  # the twin, on the CPU


@pytest.mark.usefixtures("jax_v0")
@pytest.mark.parametrize("d,other,p", [(8, 32, 4), (16, 8, 4), (32, 64, 6)])
def test_eigh_backend_matches_jax_cpu_branch(d, other, p):
  rng = np.random.RandomState(d)
  cov = _rectangular_stats(rng, 3, d, other)
  want = np.asarray(jax_shampoo._pth_inv_root(p, jnp.asarray(cov)))
  _assert_roots_close(shampoo._pth_inv_root(p, _t(cov)).numpy(), want)


def test_auto_resolves_by_device():
  assert shampoo.resolve_solver("auto", torch.device("cuda")) == "filtered"
  assert shampoo.resolve_solver("auto", torch.device("cuda", 0)) == "filtered"
  assert shampoo.resolve_solver("auto", torch.device("cpu")) == "eigh"
  for solver in ("eigh", "newton", "filtered"):
    assert shampoo.resolve_solver(solver, torch.device("cuda")) == solver


def test_newton_backends_call_the_kernel_wrapper(monkeypatch):
  """On any device ``newton`` and ``filtered`` go through
  `newton_root.batched_inverse_pth_root` with explicit lambda_max, up to
  `newton_root.MAX_M`, and the per-matrix solver above it."""
  calls = []
  real = newton_root.batched_inverse_pth_root

  def spy(stats, p, pads=None, **kw):
    calls.append(kw.get("max_evs"))
    return real(stats, p, pads, **kw)

  monkeypatch.setattr(newton_root, "batched_inverse_pth_root", spy)
  cov = _t(_rectangular_stats(np.random.RandomState(0), 2, 8, 32))
  shampoo._newton_inv_root(4, cov)
  shampoo._filtered_inv_root(4, cov)
  assert len(calls) == 2 and all(c is not None for c in calls)
  monkeypatch.setattr(newton_root, "MAX_M", 4)
  shampoo._newton_inv_root(4, cov)
  assert len(calls) == 2


def _jax_suite_rank_deficient(rng, n, d, kept, scale, spread):
  mats = []
  for _ in range(n):
    u = np.linalg.qr(rng.randn(d, d))[0].astype(np.float32)
    w = np.zeros(d, np.float32)
    w[:kept] = scale * np.exp(rng.rand(kept) * spread).astype(np.float32)
    mats.append(u @ np.diag(w) @ u.T)
  return np.stack(mats).astype(np.float32)


@pytest.mark.usefixtures("jax_v0")
def test_filtered_matches_eigh_on_rank_deficient_stats():
  """`tests/test_tearfree.py:159-180`: filtered stays within 0.05 of eigh,
  where the plain ridge root does not come close."""
  cov = _t(_jax_suite_rank_deficient(np.random.RandomState(7), 6, 32, 12,
                                     1.0, 4))
  for p in (2, 4):
    eigh_roots = shampoo._pth_inv_root(p, cov).numpy()
    filt = shampoo._filtered_inv_root(p, cov).numpy()
    newton = shampoo._newton_inv_root(p, cov).numpy()
    scale = np.abs(eigh_roots).max()
    assert np.abs(eigh_roots - filt).max() < 0.05 * scale
    assert np.abs(eigh_roots - newton).max() > 2.0 * scale


@pytest.mark.usefixtures("jax_v0")
def test_filtered_tiny_early_training_covariances():
  """`tests/test_tearfree.py:185-203`: lambda_max << 1 and rank-deficient.
  The filtered backend's lambda_max comes from a power iteration with no
  floor (`_batched_max_evs`): within 10% of the truth, where the kernel
  wrapper's own estimate (floor 1) stops after one step at less than half
  of it."""
  cov_np = _jax_suite_rank_deficient(np.random.RandomState(9), 4, 64, 5,
                                     1e-7, 2)
  cov = _t(cov_np)
  true = np.linalg.eigvalsh(cov_np.astype(np.float64))[:, -1]
  pads = torch.full((4,), 64, dtype=torch.int32)
  ours = shampoo._batched_max_evs(cov, pads).numpy()
  # The 1% exit bounds a step's change, not the error: the iteration
  # approaches lambda_max from below.
  assert (ours <= true * (1 + 1e-5)).all() and (ours >= 0.9 * true).all()
  floored = pth_root.power_iteration(cov, padding_starts=pads,
                                     error_tolerance=1e-2,
                                     relative_tolerance=True)[1].numpy()
  assert (floored < 0.5 * true).all()
  eigh_roots = shampoo._pth_inv_root(4, cov).numpy()
  filt = shampoo._filtered_inv_root(4, cov).numpy()
  assert np.isfinite(filt).all()
  assert np.abs(eigh_roots - filt).max() < 0.05 * np.abs(eigh_roots).max()


def test_filtered_zero_covariance_zero_root():
  z = torch.zeros(2, 8, 8)
  assert float(shampoo._filtered_inv_root(4, z).abs().max()) == 0.0


@pytest.mark.usefixtures("jax_v0")
def test_filtered_trajectory_tracks_eigh():
  """`tests/test_tearfree.py:210-225`, with the suite's tolerance."""
  rng = np.random.RandomState(8)
  params = {"w": _t(rng.randn(8, 8) * 0.3).float()}
  kw = dict(block_size=8, second_moment_decay=0.9)
  tx_e = shampoo.apply(shampoo.Options(**kw, solver_backend="eigh"))
  tx_f = shampoo.apply(shampoo.Options(**kw, solver_backend="filtered"))
  se, sf = tx_e.init(params), tx_f.init(params)
  for _ in range(6):
    g = {"w": _t(rng.randn(8, 8) * 0.1).float()}
    ue, se = tx_e.update(g, se, params)
    uf, sf = tx_f.update(g, sf, params)
    assert bool(torch.isfinite(uf["w"]).all())
    np.testing.assert_allclose(uf["w"].numpy(), ue["w"].numpy(), rtol=0.1,
                               atol=5e-3)


# --------------------------------------------------- blocked Shampoo updates --

# Blocks [8, 32] (rank-deficient statistics at p = 4) and [8, 16, 32]; the
# plain ridge root takes [8, 16, 32] and [8, 32, 32] (two large axes), whose
# statistics have full rank (see the Newton backends' test above).
_SHAMPOO_SHAPES = {"w": (8, 64), "t": (8, 16, 64)}
_FULL_RANK_SHAPES = {"t": (8, 16, 64), "u": (8, 32, 32)}


def _shampoo_run(backend, steps=3, shapes=_SHAMPOO_SHAPES, **options):
  """Both packages' blocked Shampoo over ``steps`` seeded gradients at
  block 32; yields per step (JAX updates, JAX state, port updates, port
  state)."""
  options = dict(block_size=32, second_moment_decay=0.9,
                 solver_backend=backend, **options)
  jax_tx = jax_shampoo.apply(jax_shampoo.Options(**options))
  port_tx = shampoo.apply(shampoo.Options(**options))
  rng = np.random.RandomState(4)
  params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
  js = jax_tx.init(jax.tree.map(jnp.asarray, params))
  ts = port_tx.init({n: _t(v) for n, v in params.items()})
  update = jax.jit(jax_tx.update)
  for _ in range(steps):
    g = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    ju, js = update(jax.tree.map(jnp.asarray, g), js)
    tu, ts = port_tx.update({n: _t(v) for n, v in g.items()}, ts)
    yield _np_tree(ju), js, tu, ts


def _assert_shampoo_step(ju, js, tu, ts):
  assert ts.count == int(js.count)
  for n, want in ju.items():
    np.testing.assert_allclose(tu[n].numpy(), want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max(), err_msg=n)
    for got_s, want_s in zip(ts.blocks[n].stats, js.blocks[n].stats,
                             strict=True):
      want_s = np.asarray(want_s)
      np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5,
                                 atol=1e-6 * np.abs(want_s).max(), err_msg=n)
    for got_r, want_r in zip(ts.blocks[n].roots, js.blocks[n].roots,
                             strict=True):
      _assert_roots_close(got_r.numpy(), np.asarray(want_r))


@pytest.mark.usefixtures("jax_accelerator_branch")
@pytest.mark.parametrize("backend", ["newton", "filtered"])
def test_shampoo_newton_backends_match_jax_accelerator_branch(backend):
  launches = newton_root.LAUNCHES
  shapes = _FULL_RANK_SHAPES if backend == "newton" else _SHAMPOO_SHAPES
  for step in _shampoo_run(backend, shapes=shapes,
                           update_preconditioners_freq=2):
    _assert_shampoo_step(*step)
  assert newton_root.LAUNCHES == launches


@pytest.mark.usefixtures("jax_v0")
@pytest.mark.parametrize("backend", ["eigh", "auto"])
def test_shampoo_eigh_and_auto_match_jax_cpu_branch(backend):
  for step in _shampoo_run(backend, update_statistics_freq=2):
    _assert_shampoo_step(*step)
