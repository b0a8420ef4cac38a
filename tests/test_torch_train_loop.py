"""The port's train loop against the JAX package's, training the LM with
Shampoo.

Both start from JAX's parameters of a small LM (2 layers, width 64, f32
activations) and its Shampoo state, carried into the port by
`utils.convert` (whose tree walk takes the model's ``blocks`` list), and
take the same seeded token batches.  The JAX side jits its
`make_train_step` once and runs its kernel path with the Pallas kernel in
interpret mode; the port's power iteration gets JAX's start vector, as in
`tests/test_torch_shampoo.py`.  Block size 32, roots every step from step
0, RMSProp grafting.

The data-parallel step runs on 2 gloo ranks (bodies in
`tests/torch_ranks.py`, which loads no JAX) under three optimizer modes
(the batch axis, partition specs over the mesh, the sharded state) and is
held to JAX's one-process step on the full batch (the sharded state to
JAX's sharded mode on one device).  Its ``target_mask``
gives the two ranks' halves of the batch different counts, so a mean of
per-rank means would miss: the loss's denominator is global, as under
JAX's jit.

The learning rate is 3e-4: at 3e-3 this model's loss climbs from 5.6 to
17.3 in three steps (in JAX as in the port: RMSProp grafting without bias
correction takes steps of 32 lr per entry at first), and the two runs'
rounding grows with it.

Tolerances, against the cross-package ones of `tests/test_torch_shampoo.py`
(whose docstring says why each is what it is): there both sides take the
same gradients; here each computes its own, which agree to about 1e-6 of
their largest entry (`tests/test_torch_transformer.py`), so the Gram
statistics get atol 1e-5 of their largest entry (measured 4.0e-6) where
that file has 1e-6, and the grafting accumulator (squared gradients) rtol
1e-4 and atol 1e-5 of its largest entry where it has rtol 1e-5; the
grafting (RMSProp) momentum atol 1e-3 of its largest entry where it has
1e-4 (measured 2.0e-4, on a norm scale): RMSProp's direction
``g / sqrt(acc)`` is of order 1 for an entry whose gradient is a millionth
of the largest, so the gradients' absolute disagreement becomes a
relative one there; every other tolerance is that file's: each step's
parameter change and the preconditioned momentum rtol 1e-3, atol 1e-4 of
the largest entry (measured 3.6e-5), roots rtol 1e-3, atol 1e-5 of the
largest (measured 6.9e-5 of it at most, on entries the rtol covers),
retries equal, iterations within 1, errors atol 1e-6; lambda_max rtol
1e-4, where that file has 1e-5, as the statistics' (measured 1.01e-5).
Losses rtol 1e-5 (measured 9e-8).  The ranks' params equal each other
bit for bit (they add the same all-reduced update), and so do
`DistributedShampoo` over the module's parameters and the functional
step (the same solves in the same order).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from precondition_tpu.models import transformer as jax_transformer
from precondition_tpu.ops.pallas import newton_root as jax_newton_root
from precondition_tpu.optim import shampoo as jax_shampoo
from precondition_tpu.parallel import mesh as jax_mesh_lib
from precondition_tpu.train import loop as jax_loop
from precondition_tpu_torch.models import transformer
from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.optim import shampoo
from precondition_tpu_torch.parallel import local
from precondition_tpu_torch.parallel import mesh
from precondition_tpu_torch.train import loop
from precondition_tpu_torch.utils import convert

import torch_ranks

torch.set_num_threads(1)

_SIZES = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_seq_len=32)
_HYPERS = dict(learning_rate=3e-4, block_size=32,
               start_preconditioning_step=0,
               graft_type=shampoo.GraftingType.RMSPROP,
               solver_backend="pallas")
_STEPS = 3
_MODES = ("batch_axis", "specs", "sharded")


def _v0(n=32):
  return np.array(jax.random.uniform(jax.random.PRNGKey(1729), (n,),
                                     jnp.float32, -1.0, 1.0))


@pytest.fixture(scope="module")
def jax_kernel_path():
  """JAX's kernel path in interpret mode; JAX's start vector for the port."""
  with pytest.MonkeyPatch.context() as patch:
    patch.setattr(
        jax_newton_root, "batched_inverse_pth_root_pallas",
        functools.partial(jax_newton_root.batched_inverse_pth_root_pallas,
                          interpret=True))
    patch.setattr(
        pth_root, "default_v0",
        lambda n, dtype=torch.float32, device=None: torch.from_numpy(
            _v0(n)).to(dtype=dtype, device=device))
    yield


def _inputs(seed=0):
  """JAX's params as numpy and ``_STEPS`` global batches of 4 rows."""
  cfg = jax_transformer.TransformerConfig(**_SIZES, dtype=jnp.float32)
  params = jax.tree.map(np.asarray, jax_transformer.init_params(
      jax.random.PRNGKey(seed), cfg))
  rng = np.random.RandomState(seed)
  batches = []
  for _ in range(_STEPS):
    mask = np.ones((4, 17), np.float32)
    mask[2:, 1:12] = 0  # rows 2-3 (rank 1's half) keep 5 targets, not 16
    batches.append({"tokens": rng.randint(0, 128, (4, 17)).astype(np.int32),
                    "target_mask": mask})
  return cfg, params, batches


def _jax_steps(sharded=False):
  """JAX's one-process steps on the full batches: the initial params and
  state, then per step the loss, the params and the state, as numpy.
  State goes in and out as numpy, so that `jit` compiles once."""
  cfg, params, batches = _inputs()
  tx = jax_shampoo.distributed_shampoo(
      **{k: jax_shampoo.GraftingType(int(v)) if k == "graft_type" else v
         for k, v in _HYPERS.items()}, shard_optimizer_states=sharded)
  init = tx.init(None).init_fn if sharded else tx.init
  step = jax.jit(jax_loop.make_train_step(
      lambda p, b: jax_transformer.loss_fn(p, b, cfg), tx))
  state = jax.tree.map(np.asarray, init(jax.tree.map(jnp.asarray, params)))
  start = (params, state)
  out = []
  for batch in batches:
    loss, params, state = jax.tree.map(np.asarray, step(params, state, batch))
    out.append((float(loss), params, state))
  return start, out


@pytest.fixture(scope="module")
def jax_run(jax_kernel_path):
  return _jax_steps()


@pytest.fixture(scope="module")
def two_ranks(jax_kernel_path):
  _, params, batches = _inputs()
  job = dict(config=dict(_SIZES, dtype=torch.float32, remat=True),
             params=dict(convert._flatten(params)), batches=batches,
             hypers=_HYPERS, modes=_MODES)
  return local.run_local_ranks(torch_ranks.train_job, 2,
                               args=(job, {32: _v0()}), join_timeout=300.0)


def _delta(new, old):
  return {k: v - old[k] for k, v in new.items()}


def _close(got, want, rtol, atol, path):
  np.testing.assert_allclose(got, want, rtol=rtol,
                             atol=atol * np.abs(want).max(), err_msg=path)


def _assert_train_step_parity(port_delta, port_state, jax_delta, jax_state):
  """One step's parameter changes and Shampoo state, port against JAX, at
  the tolerances of the module docstring."""
  ours = dict(convert._flatten(
      convert.state_to_numpy(port_state, jax_state).stats))
  assert int(port_state.count) == int(jax_state.count)
  for path, ref in convert._flatten(jax_state.stats):
    got = ours[path]
    _close(port_delta[path].numpy(), jax_delta[path], 1e-3, 1e-4, path)
    for a, b in zip(got.statistics, ref.statistics, strict=True):
      _close(a, b, 1e-3, 1e-5, path)
    for a, b in zip(got.preconditioners, ref.preconditioners, strict=True):
      _close(a, b, 1e-3, 1e-5, path)
    _close(got.diagonal_statistics, ref.diagonal_statistics, 1e-4, 1e-5,
           path)
    _close(got.diagonal_momentum, ref.diagonal_momentum, 1e-3, 1e-3, path)
    _close(got.momentum, ref.momentum, 1e-3, 1e-4, path)
    m_o, m_r = got.training_metrics, ref.training_metrics
    np.testing.assert_array_equal(m_o.retries, m_r.retries)
    np.testing.assert_allclose(m_o.iterations, m_r.iterations, atol=1)
    np.testing.assert_allclose(m_o.max_eigenvalue, m_r.max_eigenvalue,
                               rtol=1e-4)
    np.testing.assert_allclose(m_o.error, m_r.error, atol=1e-6)


def test_three_train_steps_match_jax(jax_run):
  (params, jax_state), jax_steps = jax_run
  cfg = transformer.TransformerConfig(**_SIZES, dtype=torch.float32)
  _, _, batches = _inputs()
  tx = shampoo.distributed_shampoo(**_HYPERS)
  step = loop.make_train_step(
      lambda p, b: transformer.loss_fn(p, b, cfg), tx)
  port = convert.params_from_numpy(params, device="cpu")
  state = convert.state_from_numpy(jax_state, device="cpu")
  for batch, (jax_loss, jax_params, jax_state) in zip(batches, jax_steps):
    before = {k: v.clone() for k, v in port.items()}
    loss, port, state = step(port, state, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), jax_loss, rtol=1e-5)
    jax_before = dict(convert._flatten(params))
    jax_upd = _delta(dict(convert._flatten(jax_params)), jax_before)
    _assert_train_step_parity(_delta(port, before), state, jax_upd, jax_state)
    params = jax_params


@pytest.mark.parametrize("mode", _MODES)
def test_data_parallel_step_matches_jax_full_batch(jax_run, two_ranks, mode):
  """The sharded state is held to JAX's sharded mode on one device: its
  transform applies the roots of the step's entry, so its updates are
  not those of the other modes, in JAX as in the port."""
  (params, _), jax_steps = (_jax_steps(sharded=True) if mode == "sharded"
                            else jax_run)
  (losses, got), (losses1, got1) = two_ranks[0][mode], two_ranks[1][mode]
  assert losses == losses1
  for name in got:
    np.testing.assert_array_equal(got1[name], got[name], err_msg=name)
  np.testing.assert_allclose(losses, [s[0] for s in jax_steps], rtol=1e-5)
  want = dict(convert._flatten(jax_steps[-1][1]))
  start = dict(convert._flatten(params))
  for name, value in got.items():
    change, ref = value - start[name], want[name] - start[name]
    np.testing.assert_allclose(change, ref, rtol=1e-3,
                               atol=1e-4 * np.abs(ref).max(), err_msg=name)


def test_global_denominator_differs_from_mean_of_rank_means():
  """The uneven mask makes the two losses differ, so the case above pins
  the global denominator."""
  cfg, params, batches = _inputs()
  jax_params = jax.tree.map(jnp.asarray, params)
  halves = [float(jax_transformer.loss_fn(
      jax_params, jax.tree.map(lambda x: x[s], batches[0]), cfg))
            for s in (slice(0, 2), slice(2, 4))]
  whole = float(jax_transformer.loss_fn(jax_params, batches[0], cfg))
  assert abs(np.mean(halves) - whole) > 1e-3 * whole


def test_shard_params_places_whole_and_refuses_tensor_parallelism():
  """Each param's spec is JAX's under `TP_RULES` (first match wins,
  unmatched ones replicated); over a (2, 1) mesh every param stays whole
  on each rank, and over a (1, 2) mesh the split over ``model`` raises."""
  cfg = jax_transformer.TransformerConfig(**_SIZES, dtype=jnp.float32)
  jax_mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                               ("data", "model"))
  placed = jax_mesh_lib.shard_params(
      jax_transformer.init_params(jax.random.PRNGKey(0), cfg), jax_mesh,
      jax_transformer.TP_RULES)
  want = {path: tuple(leaf.sharding.spec)
          for path, leaf in convert._flatten(placed)}
  got = {name: mesh.param_spec(name, transformer.TP_RULES)
         for name in transformer.param_shapes(
             transformer.TransformerConfig(**_SIZES))}
  assert got == want
  assert sum(bool(s) for s in got.values()) == 4 * _SIZES["n_layers"] + 3
  for whole, refused in local.run_local_ranks(torch_ranks.shard_params_job,
                                              2, join_timeout=120.0):
    assert whole
    assert "NotImplementedError" in refused and "item 13b" in refused


def test_module_under_distributed_shampoo_matches_the_functional_step():
  """`DistributedShampoo` over ``Transformer.parameters()`` (named by
  index, in JAX's order) takes the functional step's updates bit for
  bit: the same solve batches in the same order."""
  cfg = transformer.TransformerConfig(**_SIZES, dtype=torch.float32)
  _, _, batches = _inputs()
  model = transformer.Transformer(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
  params = {k: v.detach().clone() for k, v in model.params().items()}
  hypers = {k: v for k, v in _HYPERS.items() if k != "learning_rate"}
  opt = shampoo.DistributedShampoo(model.parameters(),
                                   lr=_HYPERS["learning_rate"], **hypers)
  tx = shampoo.distributed_shampoo(**_HYPERS)
  step = loop.make_train_step(lambda p, b: transformer.loss_fn(p, b, cfg), tx)
  state = tx.init(params)
  for batch in batches:
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt.zero_grad()
    transformer.loss_fn(model.params(), batch, cfg).backward()
    opt.step()
    _, params, state = step(params, state, batch)
    for name, p in model.params().items():
      torch.testing.assert_close(p.detach(), params[name], rtol=0, atol=0,
                                 msg=name)
