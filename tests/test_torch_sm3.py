"""Parity of the port's SM3 with the JAX package's `optim/sm3.py`.

The same seeded numpy parameters and gradients go through both packages,
several steps, under every option (beta2 = 1, weight decay, normalized
gradients, a learning-rate schedule) on 1-D, 2-D and 3-D params.

Tolerances and why:
* accumulators rtol 1e-5: elementwise f32 arithmetic (squares, min, max);
* one update from the same state rtol 1e-5, atol 1e-7 * max|u|: elementwise
  f32 arithmetic, the rsqrt included;
* over a trajectory, the momentum is stored in int8, and an entry that
  lies near a rounding boundary may take the neighbouring code on one
  side, so decoded momenta and updates get atol of two int8 steps of the
  momentum's scale (``2 max|m| / 127``, times the rate for updates), as
  `test_torch_quantization.py` allows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precondition_tpu.optim import sm3 as jax_sm3
from precondition_tpu_torch.optim import sm3
from precondition_tpu_torch.utils import convert

import chip_smoke

torch.set_num_threads(1)

_SHAPES = {"b": (5,), "w": (6, 4), "t": (3, 4, 5)}


def _tree(rng, scale=1.0):
  return {n: (rng.randn(*s) * scale).astype(np.float32)
          for n, s in _SHAPES.items()}


def _schedule(step):
  return 0.3 / (1.0 + step)


_OPTIONS = {
    "default": dict(learning_rate=0.3),
    "beta2-1": dict(learning_rate=0.3, beta2=1.0),
    "weight-decay": dict(learning_rate=0.3, weight_decay=1e-2),
    "normalize-grads": dict(learning_rate=0.3, normalize_grads=True),
    "schedule": dict(learning_rate=_schedule, beta1=0.5),
}


def _decoded(qv):
  return np.asarray(qv.to_float())


@pytest.mark.parametrize("name", list(_OPTIONS))
def test_sm3_steps_match_jax(name):
  options = _OPTIONS[name]
  lr = options["learning_rate"]
  rng = np.random.RandomState(0)
  params = _tree(rng)
  grads = [_tree(rng) for _ in range(5)]
  jax_tx, port_tx = jax_sm3.sm3(**options), sm3.sm3(**options)
  jax_params = jax.tree.map(jnp.asarray, params)
  port_params = convert.params_from_numpy(params, device="cpu")
  jax_state, port_state = jax_tx.init(jax_params), port_tx.init(port_params)
  update = jax.jit(jax_tx.update)
  for step, g in enumerate(grads):
    rate = lr(step) if callable(lr) else lr
    prev_scale = {n: np.abs(_decoded(jax_state.stats[n].diagonal_momentum)
                            ).max() for n in params}
    jax_upd, jax_state = update(jax.tree.map(jnp.asarray, g), jax_state,
                                jax_params)
    port_upd, port_state = port_tx.update(
        convert.params_from_numpy(g, device="cpu"), port_state, port_params)
    assert port_state.count == int(jax_state.count) == step + 1
    for n in params:
      want = np.asarray(jax_upd[n])
      np.testing.assert_allclose(
          port_upd[n].numpy(), want, rtol=1e-5,
          atol=2 * rate * prev_scale[n] / 127 + 1e-7 * np.abs(want).max(),
          err_msg=f"{name} step {step} {n}")
      ref, got = jax_state.stats[n], port_state.stats[n]
      for a_got, a_ref in zip(got.diagonal_statistics,
                              ref.diagonal_statistics, strict=True):
        np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref),
                                   rtol=1e-5, err_msg=f"{name} {n}")
      m_ref = _decoded(ref.diagonal_momentum)
      np.testing.assert_allclose(
          got.diagonal_momentum.to_float().numpy(), m_ref, rtol=1e-5,
          atol=2 * np.abs(m_ref).max() / 127, err_msg=f"{name} {n}")


@pytest.mark.parametrize("name", list(_OPTIONS))
def test_sm3_update_from_a_jax_state_matches(name):
  """Three JAX steps, then one step of each package from the same state
  (the port's converted from JAX's): the f32 arithmetic alone."""
  options = _OPTIONS[name]
  rng = np.random.RandomState(1)
  params = jax.tree.map(jnp.asarray, _tree(rng))
  jax_tx, port_tx = jax_sm3.sm3(**options), sm3.sm3(**options)
  state = jax_tx.init(params)
  for _ in range(3):
    _, state = jax_tx.update(jax.tree.map(jnp.asarray, _tree(rng)), state,
                             params)
  numpy_state = jax.tree.map(np.asarray, state)
  port_state = convert.sm3_state_from_numpy(numpy_state, device="cpu")
  g = _tree(rng)
  jax_upd, jax_next = jax_tx.update(jax.tree.map(jnp.asarray, g), state,
                                    params)
  port_upd, port_next = port_tx.update(
      convert.params_from_numpy(g, device="cpu"), port_state,
      convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu"))
  for n, want in jax_upd.items():
    want = np.asarray(want)
    np.testing.assert_allclose(port_upd[n].numpy(), want, rtol=1e-5,
                               atol=1e-7 * np.abs(want).max(), err_msg=n)
  back = convert.sm3_state_to_numpy(port_next,
                                    jax.tree.map(np.asarray, jax_next))
  for n in g:
    np.testing.assert_array_equal(back.stats[n].diagonal_momentum.quantized,
                                  np.asarray(jax_next.stats[n]
                                             .diagonal_momentum.quantized))


def test_sm3_state_round_trips_through_convert():
  rng = np.random.RandomState(2)
  params = jax.tree.map(jnp.asarray, _tree(rng))
  tx = jax_sm3.sm3(0.1)
  state = tx.init(params)
  _, state = tx.update(jax.tree.map(jnp.asarray, _tree(rng)), state, params)
  numpy_state = jax.tree.map(np.asarray, state)
  back = convert.sm3_state_to_numpy(
      convert.sm3_state_from_numpy(numpy_state, device="cpu"), numpy_state)
  assert jax.tree.structure(back) == jax.tree.structure(numpy_state)
  for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(numpy_state)):
    np.testing.assert_array_equal(a, b)
    assert np.asarray(a).dtype == np.asarray(b).dtype


def test_sm3_update_runs_without_autograd():
  """Params that require grad (a model's own) pass as they are: the update
  builds no graph through the weight decay."""
  p = torch.nn.Parameter(torch.ones(3, 2))
  tx = sm3.sm3(0.1, weight_decay=0.1)
  u, _ = tx.update({"p": torch.ones(3, 2)}, tx.init({"p": p}), {"p": p})
  assert not u["p"].requires_grad


def test_sm3_accumulator_shapes_and_int8_momentum():
  state = sm3.sm3(0.1).init({"t": torch.zeros(2, 3, 4)})
  stats = state.stats["t"]
  assert [tuple(a.shape) for a in stats.diagonal_statistics] == [(2,), (3,),
                                                                 (4,)]
  assert stats.diagonal_momentum.quantized.dtype == torch.int8


def test_sm3_state_bytes_match_jax_at_full_size():
  """The bench tree's SM3 state, the port's on the ``meta`` device against
  `jax.eval_shape` of the JAX init: equal but for JAX's int32 count, and
  the count `chip_smoke.py` holds the card's state to."""
  shapes = chip_smoke.bench_tree_shapes()
  port = sm3.sm3(0.1).init({n: torch.empty(s, device="meta")
                            for n, s in shapes.items()})
  ours = sum(t.numel() * t.element_size()
             for ps in port.stats.values()
             for t in ps.diagonal_statistics + ps.diagonal_momentum.tensors())
  jax_state = jax.eval_shape(jax_sm3.sm3(0.1).init, {
      n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()})
  ref = sum(int(np.prod(x.shape)) * x.dtype.itemsize
            for x in jax.tree.leaves(jax_state))
  assert ref - ours == 4
  assert ref == chip_smoke.JAX_SM3_STATE_BYTES
