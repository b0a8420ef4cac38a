"""End-to-end parity of the port's Shampoo update with the JAX package.

Both packages start from the same parameters and the same state (the JAX
`init` state carried into the port with `utils.convert`) and take the same
seeded gradients.  The JAX side runs its Newton-root kernel path: its
`solver_backend="pallas"` with the kernel patched to Pallas interpret
mode, which is how the JAX package's own tests run it on the CPU.  The
port's power iteration is given JAX's start vector (torch cannot draw the
bits of `PRNGKey(1729)`), so both estimate the same lambda_max.

Tolerances and why:
* updates and both momenta rtol 1e-3, atol 1e-4 * max|x|: they carry the
  roots' 1e-3 agreement through the preconditioning contraction; the
  absolute floor is for entries where contributions cancel;
* the grafting accumulator rtol 1e-5: elementwise f32 arithmetic;
* statistics rtol 1e-5, atol 1e-6 * max|S|: one f32 Gram product and EMA
  per step, summed in another order; the floor is for near-zero
  off-diagonal entries;
* roots rtol 1e-3, atol 1e-5 * max|root|: the kernel tolerance of
  `tests/test_pallas_kernels.py:59` on two f32 Newton solves;
* metrics row by row: retries equal, iterations within 1 (a member whose
  error sits at the 1e-6 exit may take one more step on one side),
  max_eigenvalue rtol 1e-5 (the same power iteration), error atol 1e-6
  (both are f32 rounding-level residuals at convergence; 1e-5 * lambda_max
  for eigh, whose error is an absolute residual of A + rI), the residual
  report of the detailed metrics atol 1e-4 (rounding-level too);
* in the quantized mode, one quantization step more: an entry that lies
  near a rounding boundary may take the neighbouring code on one side, so
  momenta and updates get atol 2 max|x| / 127 (two int8 steps of the
  largest column: a code taken differently at one step is carried in the
  next step's momentum beside that step's own), decoded statistics atol 1e-4 * max|x| (three int16 steps), and
  decoded roots rtol 1e-2, atol 1e-3 * max|root|: an int16 code is worth
  3e-5 of its column's maximum, far above the 1e-6 relative ridge, and the
  small trees' Gram statistics have rank 1 to 3, so one code taken
  differently moves the root of such an ill-conditioned matrix by up to
  7e-4 of its largest entry (measured); lambda_max rtol 1e-4, the
  decoded statistics' own tolerance.
"""

import functools
import io
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from precondition_tpu.ops.pallas import newton_root as jax_newton_root
from precondition_tpu.optim import shampoo as jax_shampoo
from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.optim import shampoo
from precondition_tpu_torch.utils import convert

torch.set_num_threads(1)

_SHAPES = {"a": (32, 64), "b": {"w": (48, 16), "norm": (32,)},
           "c": (4, 8, 16), "emb": (96, 16)}
_HYPERS = dict(learning_rate=0.1, block_size=16, beta1=0.9, beta2=0.999,
               matrix_epsilon=1e-6, start_preconditioning_step=1,
               skip_preconditioning_dim_size_gt=64)


def _tree(fn, shapes=_SHAPES):
  return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
          for k, v in shapes.items()}


@pytest.fixture
def jax_kernel_path(monkeypatch):
  """JAX's kernel path in interpret mode; JAX's start vector for the port."""
  monkeypatch.setattr(
      jax_newton_root, "batched_inverse_pth_root_pallas",
      functools.partial(jax_newton_root.batched_inverse_pth_root_pallas,
                        interpret=True))
  v0 = lambda n: np.array(jax.random.uniform(
      jax.random.PRNGKey(1729), (n,), jnp.float32, -1.0, 1.0))
  monkeypatch.setattr(
      pth_root, "default_v0",
      lambda n, dtype=torch.float32, device=None: torch.from_numpy(
          v0(n)).to(dtype=dtype, device=device))


def _run_both(steps, seed=0, shapes=_SHAPES, **hypers):
  """Yields (jax updates, jax state, port updates, port state) per step.

  The JAX side takes its kernel path ("pallas") unless ``solver_backend``
  names another.
  """
  rng = np.random.RandomState(seed)
  params = _tree(lambda s: (rng.randn(*s) * 0.1).astype(np.float32), shapes)
  grads = [_tree(lambda s: (rng.randn(*s) * 0.1).astype(np.float32), shapes)
           for _ in range(steps)]
  hypers = {"solver_backend": "pallas", **_HYPERS, **hypers}
  jax_opt = jax_shampoo.distributed_shampoo(
      **{k: jax_shampoo.GraftingType(v) if k == "graft_type" else v
         for k, v in hypers.items()})
  port_opt = shampoo.distributed_shampoo(**hypers)
  jax_params = jax.tree.map(jnp.asarray, params)
  jax_state = jax_opt.init(jax_params)
  port_state = convert.state_from_numpy(jax.tree.map(np.asarray, jax_state))
  port_params = convert.params_from_numpy(params)
  update = jax.jit(jax_opt.update)
  for g in grads:
    jax_upd, jax_state = update(jax.tree.map(jnp.asarray, g), jax_state,
                                jax_params)
    port_upd, port_state = port_opt.update(convert.params_from_numpy(g),
                                           port_state, port_params)
    yield (jax.tree.map(np.asarray, jax_upd),
           jax.tree.map(np.asarray, jax_state), port_upd, port_state)


def _decoded(x):
  """A leaf of the JAX state, `QuantizedValue`s decoded."""
  return np.asarray(x.to_float()) if hasattr(x, "to_float") else x


def _assert_update_close(got, ref, path, quantized=False):
  scale = np.abs(_decoded(ref)).max(initial=0.0)
  np.testing.assert_allclose(_decoded(got), _decoded(ref), rtol=1e-3,
                             atol=2 * scale / 127 if quantized else 1e-4 * scale,
                             err_msg=path)


def _assert_step_parity(jax_upd, jax_state, port_upd, port_state,
                        quantized=False, eigh=False):
  for path, u in convert._flatten(jax_upd):
    _assert_update_close(port_upd[path].numpy(), u, path, quantized)
  ours = dict(convert._flatten(
      convert.state_to_numpy(port_state, jax_state).stats))
  assert int(port_state.count) == int(jax_state.count)
  for path, ref in convert._flatten(jax_state.stats):
    got = ours[path]
    for s_o, s_r in zip(got.statistics, ref.statistics, strict=True):
      s_o, s_r = _decoded(s_o), _decoded(s_r)
      np.testing.assert_allclose(
          s_o, s_r, rtol=1e-5,
          atol=(1e-4 if quantized else 1e-6) * np.abs(s_r).max(),
          err_msg=path)
    for r_o, r_r in zip(got.preconditioners, ref.preconditioners,
                        strict=True):
      r_o, r_r = _decoded(r_o), _decoded(r_r)
      np.testing.assert_allclose(
          r_o, r_r, rtol=1e-2 if quantized else 1e-3,
          atol=(1e-3 if quantized else 1e-5) * np.abs(r_r).max(),
          err_msg=path)
    np.testing.assert_allclose(got.diagonal_statistics,
                               ref.diagonal_statistics, rtol=1e-5,
                               err_msg=path)
    for name in ("diagonal_momentum", "momentum"):
      _assert_update_close(getattr(got, name), getattr(ref, name), path,
                           quantized)
    m_o, m_r = got.training_metrics, ref.training_metrics
    np.testing.assert_array_equal(m_o.retries, m_r.retries)
    np.testing.assert_allclose(m_o.iterations, m_r.iterations, atol=1)
    np.testing.assert_allclose(m_o.max_eigenvalue, m_r.max_eigenvalue,
                               rtol=1e-4 if quantized else 1e-5)
    atol = 1e-5 * max(np.abs(m_r.max_eigenvalue).max(), 1.0) if eigh else 1e-6
    np.testing.assert_allclose(m_o.error, m_r.error, atol=atol)
    d_r = getattr(m_r, "inverse_pth_root_diagnostics", None)
    if hasattr(d_r, "p"):
      d_o = m_o.inverse_pth_root_diagnostics
      np.testing.assert_array_equal(d_o.p, d_r.p)
      for f in ("max_diag_error", "avg_diag_error", "max_off_diag_error",
                "avg_off_diag_error"):
        np.testing.assert_allclose(getattr(d_o, f), getattr(d_r, f),
                                   atol=1e-4, err_msg=f"{path} {f}")


@pytest.mark.usefixtures("jax_kernel_path")
@pytest.mark.parametrize("hypers", [
    dict(graft_type=shampoo.GraftingType.RMSPROP),
    dict(graft_type=shampoo.GraftingType.SGD),
    dict(graft_type=shampoo.GraftingType.RMSPROP, reuse_preconditioner=True,
         delayed_preconditioning=True, preconditioning_compute_steps=2),
], ids=["rmsprop", "sgd", "rmsprop-warm-delayed-every2"])
def test_three_updates_match_jax(hypers):
  for step in _run_both(3, **hypers):
    _assert_step_parity(*step)


@pytest.mark.usefixtures("jax_kernel_path")
@pytest.mark.parametrize("hypers", [
    dict(graft_type=shampoo.GraftingType.ADAGRAD,
         moving_average_for_momentum=True, weight_decay=1e-2,
         decoupled_weight_decay=True, decoupled_learning_rate=False,
         learning_rate=lambda step: 0.1 / (1.0 + step)),
    dict(graft_type=shampoo.GraftingType.ADAGRAD_NORMALIZED, nesterov=False),
    dict(graft_type=shampoo.GraftingType.RMSPROP_NORMALIZED,
         clip_by_scaled_gradient_norm=0.5, weight_decay=1e-2,
         precondtioner_type=shampoo.PreconditionerType.INPUT,
         statistics_compute_steps=2),
    dict(graft_type=shampoo.GraftingType.SQRT_N,
         relative_matrix_epsilon=False, exponent_override=2,
         start_preconditioning_step=0),
    dict(graft_type=shampoo.GraftingType.NONE),
], ids=["adagrad-ema-decoupled-wd-schedule", "adagrad-normalized-no-nesterov",
        "rmsprop-normalized-clip-wd-one-sided-stats-every2",
        "sqrt-n-absolute-ridge-exponent-override", "none"])
def test_options_match_jax(hypers):
  for step in _run_both(2, seed=1, **hypers):
    _assert_step_parity(*step)


# Ragged trees: (20, 17) and (10, 6) unmerged are ragged at block 16 and
# 4 (legacy layout), (32, 64) is uniform (stacked); merged, (20, 17) is a
# [340] vector with a trailing block of 4.
_RAGGED = {"r": (20, 17), "b": (10, 6), "a": (32, 64), "n": (40,)}
_UNMERGED = dict(best_effort_shape_interpretation=False, block_size=8)


@pytest.mark.usefixtures("jax_kernel_path")
@pytest.mark.parametrize("case", [
    dict(shapes=_RAGGED, hypers=_UNMERGED),
    dict(shapes=_RAGGED, hypers=dict(reuse_preconditioner=True)),
    dict(hypers=dict(best_effort_memory_usage_reduction=True)),
    dict(shapes=_RAGGED, hypers=dict(best_effort_memory_usage_reduction=True,
                                     reuse_preconditioner=True, **_UNMERGED)),
    dict(shapes=_RAGGED, hypers=dict(eigh=True, solver_backend="xla",
                                     **_UNMERGED)),
    dict(shapes=_RAGGED, hypers=dict(solver_backend="xla", **_UNMERGED)),
    dict(shapes=_RAGGED, hypers=dict(generate_detailed_metrics=True,
                                     **_UNMERGED)),
    dict(shapes=_RAGGED, hypers=dict(generate_detailed_metrics=True,
                                     solver_backend="xla",
                                     best_effort_memory_usage_reduction=True)),
    dict(steps=4, hypers=dict(decay_preconditioning_compute_steps=True,
                              end_preconditioning_compute_steps=13,
                              learning_rate=lambda step: 0.1 / (1.0 + step))),
], ids=["ragged", "ragged-merged-warm", "quantized", "quantized-ragged-warm",
        "eigh", "xla", "detailed-metrics", "detailed-metrics-xla-quantized",
        "decay-schedule"])
def test_slice_options_match_jax(case):
  """Three updates (four for the schedule: it solves at steps 0-2 and skips
  step 3, where lr(3)/lr(0) = 1/4 stretches the interval to 10)."""
  hypers = {"graft_type": shampoo.GraftingType.RMSPROP, **case["hypers"]}
  for step in _run_both(case.get("steps", 3), seed=2,
                        shapes=case.get("shapes", _SHAPES), **hypers):
    _assert_step_parity(
        *step, quantized=hypers.get("best_effort_memory_usage_reduction",
                                    False), eigh=hypers.get("eigh", False))


def test_decay_schedule_skips_the_solve():
  """The schedule's skipped step keeps the roots and the metrics."""
  opt = shampoo.distributed_shampoo(
      learning_rate=lambda step: 0.1 / (1.0 + step), block_size=8,
      decay_preconditioning_compute_steps=True,
      end_preconditioning_compute_steps=13, start_preconditioning_step=0)
  params = {"w": torch.ones(8, 8)}
  state = opt.init(params)
  gen = torch.Generator().manual_seed(0)
  seen = []
  for _ in range(4):
    before = state.stats["w"].preconditioners[0]
    _, state = opt.update({"w": torch.randn(8, 8, generator=gen)}, state,
                          params)
    seen.append(state.stats["w"].preconditioners[0] is before)
  assert seen == [False, False, False, True]


@pytest.mark.parametrize("option", [
    dict(batch_axis_name="batch"), dict(shard_optimizer_states=True),
    dict(compression_rank=4), dict(frequent_directions=True),
    dict(generate_fd_metrics=True), dict(lobpcg_topk_precondition=2),
    dict(num_devices_for_pjit=2), dict(precision="highest"),
])
def test_unported_options_raise(option):
  with pytest.raises(NotImplementedError, match="ROADMAP.md"):
    shampoo.distributed_shampoo(learning_rate=0.1, **option)


@pytest.mark.parametrize("shape,block_size,best_effort", [
    ((20, 17), 8, False), ((10, 6), 4, False), ((40,), 16, True),
    ((4, 6, 10), 4, False), ((32, 64), 16, False)],
    ids=["2d", "jax-blocking", "vector", "3d", "uniform"])
def test_preconditioner_per_block_methods_match_jax(shape, block_size,
                                                    best_effort):
  """The legacy per-block methods on one param, against JAX's: statistics
  rtol 1e-5 / atol 1e-6 * max (f32 Gram products summed in another
  order), the preconditioned gradient rtol 1e-4 / atol 1e-6 * max (one
  more contraction per axis)."""
  rng = np.random.RandomState(3)
  grad = rng.randn(*shape).astype(np.float32)
  args = (block_size, 4096, best_effort)
  ours = shampoo.Preconditioner(torch.zeros(shape), *args)
  ref = jax_shampoo.Preconditioner(jnp.zeros(shape), *args)
  assert ours.shapes_for_preconditioners() == ref.shapes_for_preconditioners()
  assert ours.num_statistics() == ref.num_statistics()
  g = torch.from_numpy(grad)
  close = lambda a, b, rtol: np.testing.assert_allclose(
      a, b, rtol=rtol, atol=1e-6 * np.abs(b).max())
  for a, b in zip(ours.statistics_from_grad(g),
                  ref.statistics_from_grad(jnp.asarray(grad)), strict=True):
    close(a.numpy(), np.asarray(b), 1e-5)
  old = [rng.randn(d, d).astype(np.float32)
         for d, _ in ours.shapes_for_preconditioners()]
  for a, b in zip(
      ours.updated_statistics_from_grad(
          [torch.from_numpy(x) for x in old], g, 0.9, 0.1),
      ref.updated_statistics_from_grad(
          [jnp.asarray(x) for x in old], jnp.asarray(grad), 0.9, 0.1),
      strict=True):
    close(a.numpy(), np.asarray(b), 1e-5)
  close(ours.preconditioned_grad(g, [torch.from_numpy(x) for x in old])
        .numpy(),
        np.asarray(ref.preconditioned_grad(jnp.asarray(grad),
                                           [jnp.asarray(x) for x in old])),
        1e-4)


def _larger_fixture():
  """The JAX package's `TestGolden._larger_fixture` (seeded standard-normal
  params and updates, a 100x first column in the updates)."""
  rng = np.random.default_rng(1234)

  def make(bigger_first_entry):
    x = [rng.standard_normal(size=s) for s in ([2, 5], [6, 3])]
    if bigger_first_entry:
      for xx in x:
        xx[..., 0] *= 100
    return {str(i): torch.as_tensor(xx, dtype=torch.float32)
            for i, xx in enumerate(x)}

  return make(False), make(True)


@pytest.mark.parametrize("kwargs", [
    dict(best_effort_memory_usage_reduction=True),
    dict(best_effort_memory_usage_reduction=True,
         merge_small_dims_block_size=1),
    dict(best_effort_memory_usage_reduction=True, reuse_preconditioner=True),
    dict(reuse_preconditioner=True),
    dict(reuse_preconditioner=True, merge_small_dims_block_size=1),
    dict(),
])
def test_larger_fixture_golden(kwargs):
  """The -0.17019942 golden family (`tests/test_shampoo.py:398-412`): the
  step-0 update entry hits the golden within 1e-4 in each state layout,
  and the trajectory stays finite over five more steps."""
  params, grads = _larger_fixture()
  opt = shampoo.distributed_shampoo(0.1, 32, preconditioning_compute_steps=2,
                                    **kwargs)
  state = opt.init(params)
  updates, state = opt.update(grads, state, params)
  got = float(updates["1"][-1, -1])
  assert abs(got - (-0.17019942)) < 1e-4, got
  for _ in range(5):
    updates, state = opt.update(grads, state, params)
  assert all(bool(torch.isfinite(u).all()) for u in updates.values())
  tree = shampoo.state_to_tree(state)
  leaves = [t for ps in tree["stats"].values()
            for t in ps["statistics"] + ps["preconditioners"]]
  assert leaves and all(bool(torch.isfinite(
      t["quantized"].float() if isinstance(t, dict) else t).all())
                        for t in leaves)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(best_effort_memory_usage_reduction=True),
    dict(reuse_preconditioner=True, generate_detailed_metrics=True),
], ids=["default", "quantized", "warm-detailed"])
def test_state_dict_resumes_bit_for_bit(kwargs):
  """`DistributedShampoo.state_dict()` through `torch.save` and a
  `weights_only` load: the resumed optimizer continues bit for bit, as
  `tests/test_checkpoint.py:61-64` asks of the JAX state."""
  shapes = {"w": (12, 20), "k": (8, 8), "b": (20,)}
  gen = torch.Generator().manual_seed(7)
  init = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
  grads = [{n: 0.1 * torch.randn(s, generator=gen) for n, s in shapes.items()}
           for _ in range(6)]
  kw = dict(lr=0.05, block_size=8, start_preconditioning_step=2,
            preconditioning_compute_steps=2,
            graft_type=shampoo.GraftingType.RMSPROP, **kwargs)

  def make(values):
    params = [torch.nn.Parameter(values[n].clone()) for n in shapes]
    return params, shampoo.DistributedShampoo(params, **kw)

  def run(params, opt, gs):
    for g in gs:
      for p, n in zip(params, shapes):
        p.grad = g[n].clone()
      opt.step()

  params, opt = make(init)
  run(params, opt, grads[:3])
  buf = io.BytesIO()
  torch.save(opt.state_dict(), buf)
  buf.seek(0)
  resumed_params, resumed = make({n: p.detach() for n, p in
                                  zip(shapes, params)})
  resumed.load_state_dict(torch.load(buf, weights_only=True))
  run(params, opt, grads[3:])
  run(resumed_params, resumed, grads[3:])
  for a, b in zip(params, resumed_params):
    assert torch.equal(a, b)
  flat = lambda o: [t for t in _tensors(shampoo.state_to_tree(
      o.shampoo_state))]
  for a, b in zip(flat(opt), flat(resumed), strict=True):
    assert torch.equal(a, b)


def _tensors(tree):
  if isinstance(tree, torch.Tensor):
    yield tree
  elif isinstance(tree, dict):
    for key in sorted(tree):
      yield from _tensors(tree[key])
  elif isinstance(tree, (list, tuple)):
    for x in tree:
      yield from _tensors(x)


def test_state_round_trip():
  """port state -> JAX structure -> port state keeps every value."""
  params = _tree(lambda s: np.ones(s, np.float32))
  jax_opt = jax_shampoo.distributed_shampoo(
      **_HYPERS, graft_type=jax_shampoo.GraftingType.RMSPROP)
  jax_state = jax.tree.map(np.asarray,
                           jax_opt.init(jax.tree.map(jnp.asarray, params)))
  port_state = convert.state_from_numpy(jax_state)
  again = convert.state_from_numpy(
      convert.state_to_numpy(port_state, jax_state))
  for name, ps in port_state.stats.items():
    other = again.stats[name]
    for a, b in zip(ps.statistics + ps.preconditioners,
                    other.statistics + other.preconditioners, strict=True):
      assert torch.equal(a, b)
    assert torch.equal(ps.diagonal_statistics, other.diagonal_statistics)
    assert torch.equal(ps.training_metrics.error,
                       other.training_metrics.error)


@pytest.mark.parametrize("hypers", [
    dict(best_effort_memory_usage_reduction=True,
         generate_detailed_metrics=True),
    dict(generate_detailed_metrics=True, **_UNMERGED),
], ids=["quantized-detailed", "ragged-detailed"])
def test_legacy_state_round_trip(hypers):
  """Legacy lists, `QuantizedValue` leaves and the residual report go to
  the JAX structure and back unchanged, and JAX steps on the result."""
  params = _tree(lambda s: np.ones(s, np.float32), _RAGGED)
  jax_opt = jax_shampoo.distributed_shampoo(
      **{**_HYPERS, **hypers}, graft_type=jax_shampoo.GraftingType.RMSPROP)
  jax_params = jax.tree.map(jnp.asarray, params)
  jax_state = jax.tree.map(np.asarray, jax_opt.init(jax_params))
  port_state = convert.state_from_numpy(jax_state)
  back = convert.state_to_numpy(port_state, jax_state)
  again = convert.state_from_numpy(back)
  for a, b in zip(_tensors(shampoo.state_to_tree(port_state)),
                  _tensors(shampoo.state_to_tree(again)), strict=True):
    assert torch.equal(a, b)
  assert (jax.tree.structure(back) == jax.tree.structure(jax_state))
  jax_opt.update(jax.tree.map(jnp.asarray, params),
                 jax.tree.map(jnp.asarray, back), jax_params)


def test_torch_optimizer_matches_functional_and_trains():
  """`DistributedShampoo` steps equal the functional pair; a least-squares
  loss falls."""
  gen = torch.Generator().manual_seed(0)
  x = torch.randn(64, 32, generator=gen)
  y = x @ torch.randn(32, 16, generator=gen)
  w = torch.zeros(32, 16, requires_grad=True)
  b = torch.zeros(16, requires_grad=True)
  kw = dict(block_size=16, start_preconditioning_step=1,
            graft_type=shampoo.GraftingType.RMSPROP)
  opt = shampoo.DistributedShampoo([w, b], lr=0.05, **kw)
  ref = shampoo.distributed_shampoo(learning_rate=0.05, **kw)
  ref_params = {"0": w.detach().clone(), "1": b.detach().clone()}
  ref_state = ref.init(ref_params)
  losses = []
  for _ in range(20):
    opt.zero_grad()
    loss = ((x @ w + b - y) ** 2).mean()
    loss.backward()
    grads = {"0": w.grad.clone(), "1": b.grad.clone()}
    opt.step()
    upd, ref_state = ref.update(grads, ref_state, ref_params)
    ref_params = {n: p + upd[n] for n, p in ref_params.items()}
    losses.append(loss.item())
  torch.testing.assert_close(w.detach(), ref_params["0"])
  torch.testing.assert_close(b.detach(), ref_params["1"])
  assert losses[-1] < 0.5 * losses[0], losses


def test_port_never_imports_jax():
  code = ("import sys, precondition_tpu_torch, "
          "precondition_tpu_torch.utils.convert, "
          "precondition_tpu_torch.utils.quantization, "
          "precondition_tpu_torch.utils.diagnostics, "
          "precondition_tpu_torch.ops.pth_root, "
          "precondition_tpu_torch.ops.kernels.newton_root, "
          "precondition_tpu_torch.ops.kernels.matmul_chain, "
          "precondition_tpu_torch.probes.tile_breakdown, "
          "precondition_tpu_torch.probes.step_time\n"
          "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
          " or m == 'precondition_tpu' or m.startswith('precondition_tpu.')]\n"
          "assert not bad, bad\n")
  subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
