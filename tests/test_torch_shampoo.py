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
  (both are f32 rounding-level residuals at convergence).
"""

import functools
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


def _run_both(steps, seed=0, **hypers):
  """Yields (jax updates, jax state, port updates, port state) per step."""
  rng = np.random.RandomState(seed)
  params = _tree(lambda s: (rng.randn(*s) * 0.1).astype(np.float32))
  grads = [_tree(lambda s: (rng.randn(*s) * 0.1).astype(np.float32))
           for _ in range(steps)]
  hypers = {**_HYPERS, **hypers}
  jax_opt = jax_shampoo.distributed_shampoo(
      **{k: jax_shampoo.GraftingType(v) if k == "graft_type" else v
         for k, v in hypers.items()}, solver_backend="pallas")
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


def _assert_update_close(got, ref, path):
  np.testing.assert_allclose(got, ref, rtol=1e-3,
                             atol=1e-4 * np.abs(ref).max(initial=0.0),
                             err_msg=path)


def _assert_step_parity(jax_upd, jax_state, port_upd, port_state):
  for path, u in convert._flatten(jax_upd):
    _assert_update_close(port_upd[path].numpy(), u, path)
  ours = dict(convert._flatten(
      convert.state_to_numpy(port_state, jax_state).stats))
  assert int(port_state.count) == int(jax_state.count)
  for path, ref in convert._flatten(jax_state.stats):
    got = ours[path]
    for s_o, s_r in zip(got.statistics, ref.statistics, strict=True):
      np.testing.assert_allclose(s_o, s_r, rtol=1e-5,
                                 atol=1e-6 * np.abs(s_r).max(), err_msg=path)
    for r_o, r_r in zip(got.preconditioners, ref.preconditioners,
                        strict=True):
      np.testing.assert_allclose(r_o, r_r, rtol=1e-3,
                                 atol=1e-5 * np.abs(r_r).max(), err_msg=path)
    np.testing.assert_allclose(got.diagonal_statistics,
                               ref.diagonal_statistics, rtol=1e-5,
                               err_msg=path)
    for name in ("diagonal_momentum", "momentum"):
      _assert_update_close(getattr(got, name), getattr(ref, name), path)
    m_o, m_r = got.training_metrics, ref.training_metrics
    np.testing.assert_array_equal(m_o.retries, m_r.retries)
    np.testing.assert_allclose(m_o.iterations, m_r.iterations, atol=1)
    np.testing.assert_allclose(m_o.max_eigenvalue, m_r.max_eigenvalue,
                               rtol=1e-5)
    np.testing.assert_allclose(m_o.error, m_r.error, atol=1e-6)


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


@pytest.mark.parametrize("option", [
    dict(batch_axis_name="batch"), dict(shard_optimizer_states=True),
    dict(compression_rank=4), dict(best_effort_memory_usage_reduction=True),
    dict(generate_detailed_metrics=True), dict(eigh=True),
    dict(lobpcg_topk_precondition=2),
    dict(decay_preconditioning_compute_steps=True),
    dict(solver_backend="xla"), dict(num_devices_for_pjit=2),
])
def test_unported_options_raise(option):
  with pytest.raises(NotImplementedError, match="ROADMAP.md"):
    shampoo.distributed_shampoo(learning_rate=0.1, **option)


def test_ragged_blocks_raise():
  opt = shampoo.distributed_shampoo(learning_rate=0.1, block_size=16)
  with pytest.raises(NotImplementedError, match="ragged"):
    opt.init({"w": torch.zeros(20, 17)})


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
          "precondition_tpu_torch.ops.kernels.newton_root\n"
          "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
          " or m == 'precondition_tpu' or m.startswith('precondition_tpu.')]\n"
          "assert not bad, bad\n")
  subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
