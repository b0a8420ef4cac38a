"""Parity of the port's whole tearfree chain with the JAX package's.

`tearfree(lr, options)` (grafting of merge -> blocked Shampoo or Sketchy
-> unmerge, momentum, a learning-rate schedule) runs a few steps on a
small tree in both packages from the same seeded numpy inputs.  Shampoo's
``newton`` and ``filtered`` backends are held to JAX's accelerator branch
and ``eigh``/``auto`` to its CPU branch, as in `test_torch_tearfree.py`
(whose docstring says why).  One case starts from a JAX state converted
mid-run with `utils.convert`, and the states round-trip through it.  At
full size, the state's bytes are held to `jax.eval_shape` of the JAX init
on the bench tree, the counts `chip_smoke.py` holds the card to.

Tolerances: updates and momenta rtol 1e-3, atol 1e-4 * max|x| (the roots'
1e-3 agreement carried through the chain); the grafting accumulator rtol
1e-5 (elementwise f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from precondition_tpu.tearfree import grafting as jax_grafting
from precondition_tpu.tearfree import momentum as jax_momentum
from precondition_tpu.tearfree import optimizer as jax_optimizer
from precondition_tpu.tearfree import second_order as jax_second_order
from precondition_tpu.tearfree import shampoo as jax_shampoo
from precondition_tpu.tearfree import sketchy as jax_sketchy
from precondition_tpu_torch.tearfree import grafting
from precondition_tpu_torch.tearfree import momentum
from precondition_tpu_torch.tearfree import optimizer
from precondition_tpu_torch.tearfree import second_order
from precondition_tpu_torch.tearfree import shampoo
from precondition_tpu_torch.tearfree import sketchy
from precondition_tpu_torch.utils import convert

import chip_smoke
# The JAX branches' fixtures: JAX's start vector for the port's power
# iteration; JAX tearfree's accelerator branch.
from test_torch_tearfree import jax_accelerator_branch, jax_v0  # noqa: F401

torch.set_num_threads(1)


pytestmark = pytest.mark.usefixtures("jax_v0")


def _options(pkg, backend="eigh", graft="RMSPROP", sketch=False,
             nesterov=True):
  """The same `TearfreeOptions` built from the JAX package (``pkg`` the
  module tuple) or the port: merge_dims 8 keeps the test shapes, block 32,
  skips above 100, preconditioning from step 1."""
  grafting_m, momentum_m, second_order_m, shampoo_m, sketchy_m, opt_m = pkg
  graft_kw = dict(RMSPROP=dict(second_moment_decay=0.99),
                  ADAFACTOR=dict(second_moment_decay=0.8,
                                 min_dim_size_to_factor=8),
                  NONE=dict(second_moment_decay=0.0))[graft]
  if sketch:
    so = second_order_m.Options(
        merge_dims=8,
        second_order_type=second_order_m.SecondOrderType.SKETCHY,
        shampoo_options=None, sketchy_options=sketchy_m.Options(rank=4))
  else:
    so = second_order_m.Options(
        merge_dims=8, shampoo_options=shampoo_m.Options(
            block_size=32, second_moment_decay=0.95,
            solver_backend=backend))
  return opt_m.TearfreeOptions(
      grafting_options=grafting_m.Options(
          grafting_m.GraftingType[graft], start_preconditioning_step=1,
          skip_preconditioning_any_dim_gt=100, **graft_kw),
      second_order_options=so,
      momentum_options=momentum_m.Options(momentum_decay=0.9,
                                          nesterov=nesterov))


_JAX = (jax_grafting, jax_momentum, jax_second_order, jax_shampoo,
        jax_sketchy, jax_optimizer)
_PORT = (grafting, momentum, second_order, shampoo, sketchy, optimizer)
# "emb" skips preconditioning (a dim above 100), "b" is a vector; the
# preconditioned params' statistics have full rank or a clean gap (the
# Newton backend gets full rank only, see test_torch_tearfree.py).
_SHAPES = {"w": (8, 64), "t": (8, 16, 64), "b": (64,), "emb": (200, 8)}
_FULL_RANK_SHAPES = {"t": (8, 16, 64), "u": (8, 32, 32), "b": (64,)}


def _schedule(count):
  return 0.1 / (1.0 + count)


def _grads(rng, shapes, steps):
  return [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
          for _ in range(steps)]


def _assert_close(got, want, rtol=1e-3, label=""):
  want = np.asarray(want)
  np.testing.assert_allclose(got, want, rtol=rtol,
                             atol=1e-4 * np.abs(want).max(), err_msg=label)


def _run(kwargs, shapes, steps=3, start=0):
  """Both chains from the same params; the port's state is converted from
  JAX's after ``start`` JAX-only steps.  Returns the final states."""
  rng = np.random.RandomState(5)
  params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
  jax_tx = jax_optimizer.tearfree(_schedule, _options(_JAX, **kwargs))
  port_tx = optimizer.tearfree(_schedule, _options(_PORT, **kwargs))
  jp = jax.tree.map(jnp.asarray, params)
  tp = convert.params_from_numpy(params, device="cpu")
  js = jax_tx.init(jp)
  update = jax.jit(jax_tx.update)
  grads = _grads(rng, shapes, start + steps)
  for g in grads[:start]:
    _, js = update(jax.tree.map(jnp.asarray, g), js, jp)
  ts = (convert.tearfree_state_from_numpy(jax.tree.map(np.asarray, js),
                                              device="cpu")
        if start else port_tx.init(tp))
  for step, g in enumerate(grads[start:]):
    ju, js = update(jax.tree.map(jnp.asarray, g), js, jp)
    tu, ts = port_tx.update(convert.params_from_numpy(g, device="cpu"), ts, tp)
    for n in shapes:
      _assert_close(tu[n].numpy(), ju[n], label=f"step {step} {n}")
  return js, ts


def _assert_states_close(js, ts):
  ours = convert.tearfree_state_to_numpy(ts, jax.tree.map(np.asarray, js))
  graft, ref_graft = ours[0], jax.tree.map(np.asarray, js)[0]
  if hasattr(ref_graft, "norm") and hasattr(ref_graft.norm, "acc"):
    for n, acc in ref_graft.norm.acc.items():
      np.testing.assert_allclose(graft.norm.acc[n], acc, rtol=1e-5)
  trace = [s for s in ours[1] if hasattr(s, "trace")][0].trace
  ref = [s for s in js[1] if hasattr(s, "trace")][0].trace
  for n, t in ref.items():
    _assert_close(trace[n], t, label=f"momentum {n}")


@pytest.mark.parametrize("kwargs", [
    dict(backend="eigh"), dict(backend="auto"),
    dict(backend="eigh", graft="ADAFACTOR", nesterov=False),
    dict(graft="NONE", sketch=True), dict(sketch=True)],
    ids=["eigh", "auto", "eigh-adafactor", "sketchy-no-graft", "sketchy"])
def test_tearfree_chain_matches_jax(kwargs):
  _assert_states_close(*_run(kwargs, _SHAPES))


@pytest.mark.usefixtures("jax_accelerator_branch")
@pytest.mark.parametrize("backend", ["newton", "filtered"])
def test_tearfree_chain_matches_jax_accelerator_branch(backend):
  shapes = _FULL_RANK_SHAPES if backend == "newton" else _SHAPES
  _assert_states_close(*_run(dict(backend=backend), shapes))


@pytest.mark.parametrize("kwargs", [dict(backend="eigh"),
                                    dict(backend="eigh", graft="ADAFACTOR"),
                                    dict(sketch=True)],
                         ids=["shampoo", "adafactor", "sketchy"])
def test_tearfree_continues_from_a_converted_jax_state(kwargs):
  """Two JAX steps, then both chains go on from JAX's state (the schedule
  and grafting counts included)."""
  _assert_states_close(*_run(kwargs, _SHAPES, steps=2, start=2))


@pytest.mark.parametrize("kwargs", [
    dict(backend="eigh"), dict(backend="eigh", graft="ADAFACTOR"),
    dict(graft="NONE", sketch=True)], ids=["rmsprop", "adafactor", "none"])
def test_tearfree_state_round_trips_through_convert(kwargs):
  rng = np.random.RandomState(6)
  params = {n: jnp.asarray(rng.randn(*s).astype(np.float32))
            for n, s in _SHAPES.items()}
  tx = jax_optimizer.tearfree(0.1, _options(_JAX, **kwargs))
  state = tx.init(params)
  for g in _grads(rng, _SHAPES, 2):
    _, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
  numpy_state = jax.tree.map(np.asarray, state)
  back = convert.tearfree_state_to_numpy(
      convert.tearfree_state_from_numpy(numpy_state, device="cpu"),
      numpy_state)
  assert jax.tree.structure(back) == jax.tree.structure(numpy_state)
  for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(numpy_state)):
    np.testing.assert_array_equal(a, b)
    assert np.asarray(a).dtype == np.asarray(b).dtype


def test_tearfree_update_runs_without_autograd():
  """Params that require grad pass as they are (Adafactor's parameter
  scale and the weight decay read them): the update builds no graph."""
  opts = _options(_PORT, graft="ADAFACTOR")
  opts.momentum_options.weight_decay = 0.1
  tx = optimizer.tearfree(0.1, opts)
  params = {"w": torch.nn.Parameter(torch.randn(8, 64))}
  u, _ = tx.update({"w": torch.randn(8, 64)}, tx.init(params), params)
  assert not u["w"].requires_grad


def _bench_options(pkg, sketch):
  """`chip_smoke.py` (h) and (i): the JAX package's
  `benchmarks/tearfree_backend_trajectory.py` options at block 128, roots
  every step from step 0; Sketchy at the Options' default rank."""
  grafting_m, momentum_m, second_order_m, shampoo_m, sketchy_m, opt_m = pkg
  if sketch:
    so = second_order_m.Options(
        second_order_type=second_order_m.SecondOrderType.SKETCHY,
        shampoo_options=None, sketchy_options=sketchy_m.Options(rank=128))
  else:
    so = second_order_m.Options(
        second_order_type=second_order_m.SecondOrderType.SHAMPOO,
        shampoo_options=shampoo_m.Options(
            block_size=128, update_preconditioners_freq=1,
            second_moment_decay=0.999, solver_backend="filtered"))
  return opt_m.TearfreeOptions(
      grafting_options=grafting_m.Options(
          grafting_type=grafting_m.GraftingType.RMSPROP,
          second_moment_decay=0.999, start_preconditioning_step=0),
      second_order_options=so,
      momentum_options=momentum_m.Options(momentum_decay=0.9))


def _tensor_bytes(x):
  if isinstance(x, torch.Tensor):
    return x.numel() * x.element_size()
  if isinstance(x, dict):
    return sum(_tensor_bytes(v) for v in x.values())
  if isinstance(x, (list, tuple)):
    return sum(_tensor_bytes(v) for v in x)
  if hasattr(x, "__dataclass_fields__"):
    return sum(_tensor_bytes(getattr(x, f)) for f in x.__dataclass_fields__)
  return 0


@pytest.mark.parametrize("sketch,want,counts", [
    (False, chip_smoke.JAX_TEARFREE_SHAMPOO_STATE_BYTES, 2),
    (True, chip_smoke.JAX_TEARFREE_SKETCHY_STATE_BYTES, 2)],
    ids=["shampoo", "sketchy"])
def test_tearfree_state_bytes_match_jax_at_full_size(sketch, want, counts):
  """The bench tree's tearfree state, the port's on the ``meta`` device:
  JAX's bytes less its int32 counts (grafting's and the preconditioner's;
  a constant rate keeps none)."""
  shapes = chip_smoke.bench_tree_shapes()
  port = optimizer.tearfree(0.1, _bench_options(_PORT, sketch)).init(
      {n: torch.empty(s, device="meta") for n, s in shapes.items()})
  jax_state = jax.eval_shape(
      jax_optimizer.tearfree(0.1, _bench_options(_JAX, sketch)).init,
      {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()})
  ref = sum(int(np.prod(x.shape)) * x.dtype.itemsize
            for x in jax.tree.leaves(jax_state))
  assert ref == want
  assert ref - _tensor_bytes(port) == 4 * counts
