"""The port's memory-sharded Shampoo against the JAX package's, on CPU ranks.

JAX runs `shard_optimizer_states=True` with `num_devices_for_pjit=2` and
both specs over a 2-device mesh, under `jax.sharding.set_mesh`, as its own
test does (`tests/test_shampoo.py:540-570`), here jitted; the port runs
the same options on 2 gloo ranks with specs over a mesh of them
(`parallel.local.run_local_ranks`, bodies in `tests/torch_ranks.py`), once
for the module.  Five steps from ``init(None).init_fn``, roots from step
2; then three steps from JAX's state after step 2 converted to each rank's
slice (`utils.convert.sharded_state_from_numpy`).  The ranks' slices are
joined back into JAX's layout (`utils.convert.sharded_state_to_numpy`)
and compared row for row in JAX's slot order.

The tree's 23 statistics (20 at p = 4, 3 at p = 2) pad to 24 rows, 12 a
rank; the sort by exponent puts the p = 2 rows first, so each rank's rows
hold part of a group.  Tolerances: updates at the JAX package's
distributed tolerance (rtol 2e-4, atol 1e-6); statistics rtol 1e-5, atol
1e-6 of the largest, roots rtol 1e-3, atol 1e-5 of the largest, metrics
as `tests/test_torch_shampoo.py` holds them, for the reasons given there.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import chip_smoke
from precondition_tpu.ops.pallas import newton_root as jax_newton_root
from precondition_tpu.optim import shampoo as jax_shampoo
from precondition_tpu_torch.optim import shampoo
from precondition_tpu_torch.optim import sharded_shampoo
from precondition_tpu_torch.parallel import local
from precondition_tpu_torch.parallel import mesh
from precondition_tpu_torch.utils import convert

import torch_ranks

torch.set_num_threads(1)

# In JAX's flattening order (sorted names), which the layout follows.
_TREE = {"r": (12, 12), "v": (24,), "w": (16, 24)}
_HYPERS = dict(learning_rate=0.1, block_size=8, start_preconditioning_step=2,
               graft_type=shampoo.GraftingType.RMSPROP,
               best_effort_shape_interpretation=False, num_devices_for_pjit=2,
               solver_backend="pallas")
_STEPS, _RESUME_AT = 5, 2
_ROWS, _M = 24, 8


def _inputs(seed=0):
  rng = np.random.RandomState(seed)
  draw = lambda: {k: (rng.randn(*s) * 0.1).astype(np.float32)
                  for k, s in _TREE.items()}
  return draw(), [draw() for _ in range(_STEPS)]


def _jax_opt(**hypers):
  return jax_shampoo.distributed_shampoo(
      **{k: jax_shampoo.GraftingType(int(v)) if k == "graft_type" else v
         for k, v in {**_HYPERS, **hypers}.items()})


@pytest.fixture(scope="module")
def jax_run():
  """JAX's numpy updates and states per step, and its init's contract."""
  params, grads = _inputs()
  devices = Mesh(np.asarray(jax.devices()[:2]), ("d",))
  sh = NamedSharding(devices, P("d"))
  tx = _jax_opt(shard_optimizer_states=True, statistics_partition_spec=sh,
                preconditioner_partition_spec=sh)
  interpret = functools.partial(
      jax_newton_root.batched_inverse_pth_root_pallas, interpret=True)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jax_newton_root, "batched_inverse_pth_root_pallas", interpret)
    with jax.sharding.set_mesh(devices):
      jax_params = jax.tree.map(jnp.asarray, params)
      init = tx.init(None)
      # States pass as numpy, so that `jit` compiles once for every step.
      state = jax.tree.map(np.asarray, init.init_fn(jax_params))
      update = jax.jit(tx.update)
      steps = []
      for g in grads:
        u, state = jax.tree.map(np.asarray, update(
            jax.tree.map(jnp.asarray, g), state, jax_params))
        steps.append((u, state))
  return dict(steps=steps, shapes=init.shape_and_dtype_fn(jax_params),
              v0={_M: np.array(jax.random.uniform(
                  jax.random.PRNGKey(1729), (_M,), jnp.float32, -1.0, 1.0))})


@pytest.fixture(scope="module")
def port_run(jax_run):
  params, grads = _inputs()
  resume = [to_rank(jax_run["steps"][_RESUME_AT - 1][1], r)
            for r in range(2)]
  job = dict(hypers=_HYPERS, params=params, grads=grads,
             spec=("mesh", (2,), ("d",), "d"), resume=resume,
             resume_grads=grads[_RESUME_AT:])
  return local.run_local_ranks(torch_ranks.sharded_job, 2,
                               args=(job, jax_run["v0"]), join_timeout=300.0)


def to_rank(jax_state, rank):
  """A rank's slice of a JAX state, as numpy in the port's classes."""
  return torch_ranks.to_numpy(convert.sharded_state_from_numpy(
      jax_state, rank, 2, device="cpu"))


def _joined(ranks, step, key="steps"):
  """The ranks' states after ``step`` in JAX's layout, and rank 0's
  updates."""
  states = [torch_ranks.to_torch(r[key][step][1]) for r in ranks]
  return ranks[0][key][step][0], states


def _assert_matches(upd, states, want_upd, want_state):
  for name, u in upd.items():
    np.testing.assert_allclose(u, want_upd[name], rtol=2e-4, atol=1e-6,
                               err_msg=name)
  got = convert.sharded_state_to_numpy(states, want_state)
  assert int(got.count) == int(want_state.count)
  g, w = got.stats.global_stats, want_state.stats.global_stats
  np.testing.assert_array_equal(g.exponents, w.exponents)
  np.testing.assert_allclose(g.statistics, w.statistics, rtol=1e-5,
                             atol=1e-6 * np.abs(w.statistics).max())
  np.testing.assert_allclose(g.preconditioners, w.preconditioners, rtol=1e-3,
                             atol=1e-5 * np.abs(w.preconditioners).max())
  for path, want in convert._flatten(want_state.stats.local_stats):
    ours = dict(convert._flatten(got.stats.local_stats))[path]
    assert ours.index_start == want.index_start
    assert list(ours.sizes) == list(want.sizes)
    np.testing.assert_allclose(ours.diagonal_statistics,
                               want.diagonal_statistics, rtol=1e-5)
    for field in ("momentum", "diagonal_momentum"):
      scale = np.abs(getattr(want, field)).max()
      np.testing.assert_allclose(getattr(ours, field), getattr(want, field),
                                 rtol=1e-3, atol=1e-4 * scale, err_msg=path)
    m_o, m_w = ours.training_metrics, want.training_metrics
    np.testing.assert_array_equal(m_o.retries, m_w.retries)
    np.testing.assert_allclose(m_o.iterations, m_w.iterations, atol=1)
    np.testing.assert_allclose(m_o.max_eigenvalue, m_w.max_eigenvalue,
                               rtol=1e-5)
    np.testing.assert_allclose(m_o.error, m_w.error, atol=1e-6)


@pytest.mark.parametrize("step", range(_STEPS))
def test_sharded_steps_match_jax(jax_run, port_run, step):
  """Updates, the joined global statistics and roots, and every param's
  metrics after each of five steps; both ranks' updates are equal."""
  upd, states = _joined(port_run, step)
  _close_updates(port_run[1]["steps"][step][0], upd)
  _assert_matches(upd, states, *jax_run["steps"][step])


@pytest.mark.parametrize("step", range(_STEPS - _RESUME_AT))
def test_sharded_resume_from_a_jax_state(jax_run, port_run, step):
  """JAX's state after step 2, split into the ranks' slices, continues in
  the port as it does in JAX."""
  upd, states = _joined(port_run, step, key="resumed")
  _assert_matches(upd, states, *jax_run["steps"][_RESUME_AT + step])


@pytest.mark.parametrize("step", range(_STEPS - _RESUME_AT))
def test_sharded_resume_with_params_in_another_order(jax_run, port_run,
                                                     step):
  """The same resume with the params and grads dicts reversed: the layout
  follows JAX's flattening order, not the dict's, so the converted rows
  are read where JAX wrote them."""
  upd, states = _joined(port_run, step, key="resumed_reversed")
  assert list(upd) == list(_TREE)[::-1]
  _assert_matches(upd, states, *jax_run["steps"][_RESUME_AT + step])


@pytest.mark.parametrize("change", ["other-shapes", "moved-rows"])
def test_update_refuses_a_state_of_other_params(change):
  """An update whose params lay out other rows than the state's raises."""
  opt = _port_opt()
  params = {k: torch.zeros(s) for k, s in _TREE.items()}
  state = opt.init(None).init_fn(params)
  if change == "other-shapes":
    params["w"] = torch.zeros(8, 24)
  else:
    local = state.stats.local_stats
    local["w"] = dataclasses.replace(local["w"],
                                     index_start=local["r"].index_start)
  grads = {k: torch.ones_like(p) for k, p in params.items()}
  with pytest.raises(ValueError, match="layout"):
    opt.update(grads, state, params)


def _close_updates(a, b):
  for name in b:
    np.testing.assert_array_equal(a[name], b[name])


def _port_opt(spec=None):
  spec = spec or mesh.Sharding(None, ("d",))
  return shampoo.distributed_shampoo(
      **_HYPERS, shard_optimizer_states=True, statistics_partition_spec=spec,
      preconditioner_partition_spec=spec)


def _dtype_name(dtype) -> str:
  if isinstance(dtype, torch.dtype):
    return str(dtype).split(".")[-1]
  return np.dtype(dtype).name


def _shape_leaves(tree):
  """``(path, shape, dtype name)`` of every ``[shape, dtype]`` leaf."""
  if isinstance(tree, list) and len(tree) == 2 and isinstance(tree[0], list):
    return [("", list(tree[0]), _dtype_name(tree[1]))]
  if hasattr(tree, "_fields") and not hasattr(tree, "__dataclass_fields__"):
    tree = dict(zip(tree._fields, tree))
  elif hasattr(tree, "__dataclass_fields__"):
    tree = {k: getattr(tree, k) for k in tree.__dataclass_fields__}
  if isinstance(tree, dict):
    return [(f"{k}/{p}", s, d) for k, v in sorted(tree.items())
            for p, s, d in _shape_leaves(v)]
  return []


def test_init_fn_state_contract(jax_run, port_run):
  """`shape_and_dtype_fn` gives JAX's global shapes and dtypes leaf for
  leaf, and the joined state has them; `pspec_fn` has the state's
  structure, a `Sharding` where the state holds a tensor."""
  params = {k: torch.zeros(s) for k, s in _TREE.items()}
  init = _port_opt().init(None)
  ours = init.shape_and_dtype_fn(params)
  want = jax_run["shapes"]
  assert _shape_leaves(ours) == _shape_leaves(want)
  states = [torch_ranks.to_torch(r["steps"][-1][1]) for r in port_run]
  joined = torch.cat([s.stats.global_stats.statistics for s in states])
  assert list(joined.shape) == ours.stats.global_stats.statistics[0]
  specs = init.pspec_fn(params)
  state = init.init_fn(params)
  spec_leaves, state_leaves = [], []
  torch_ranks.tree_map(state_leaves.append, state.stats)
  _collect(specs.stats, spec_leaves)
  assert len(spec_leaves) == len(state_leaves)
  assert all(isinstance(s, mesh.Sharding) for s in spec_leaves)


def _collect(tree, out):
  """The `Sharding` leaves of a pspec tree, in the state's order."""
  if isinstance(tree, mesh.Sharding):
    out.append(tree)
  elif hasattr(tree, "__dataclass_fields__"):
    for k in tree.__dataclass_fields__:
      _collect(getattr(tree, k), out)
  elif isinstance(tree, dict):
    for v in tree.values():
      _collect(v, out)
  elif isinstance(tree, tuple):
    for v in tree:
      _collect(v, out)


def test_each_rank_holds_half_the_global_arrays(jax_run, port_run):
  """A rank holds 12 of the 24 rows of statistics and roots, every
  exponent, and the replicated per-parameter stats JAX holds."""
  g = jax_run["shapes"].stats.global_stats
  nbytes = lambda sd: int(np.prod(sd[0])) * np.dtype(sd[1]).itemsize
  rows = nbytes(g.statistics) + nbytes(g.preconditioners)
  local_want = sum(
      int(np.prod(s)) * np.dtype(d).itemsize
      for _, s, d in _shape_leaves(jax_run["shapes"].stats.local_stats))
  for rank in port_run:
    held = rank["bytes"]
    assert held["global"] == rows // 2 + nbytes(g.exponents)
    assert held["local"] == local_want


def test_sharded_state_bytes_at_full_size():
  """The bench tree's sharded state by JAX's `shape_and_dtype_fn` (with
  `chip_smoke.py` (j2)'s options): the counts (j2) holds each card rank
  to, and the port's own `shape_and_dtype_fn` gives the same shapes."""
  shapes = chip_smoke.bench_tree_shapes()
  opts = dict(chip_smoke.HYPERS, shard_optimizer_states=True,
              num_devices_for_pjit=2)
  jax_opts = {k: jax_shampoo.GraftingType(int(v)) if k == "graft_type"
              else v for k, v in opts.items()}
  nested = {}
  for name, s in shapes.items():
    node = nested
    *outer, leaf = name.split("/")
    for key in outer:
      node = node.setdefault(key, {})
    node[leaf] = jax.ShapeDtypeStruct(s, jnp.float32)
  want = jax_shampoo.distributed_shampoo(**jax_opts).init(
      None).shape_and_dtype_fn(nested)
  ours = shampoo.distributed_shampoo(**opts).init(None).shape_and_dtype_fn(
      {n: torch.empty(s, device="meta") for n, s in shapes.items()})
  leaves = _shape_leaves(want)
  assert len(leaves) == len(_shape_leaves(ours))
  total = sum(int(np.prod(s)) * np.dtype(d).itemsize for _, s, d in leaves)
  g = want.stats.global_stats
  rows = 2 * int(np.prod(g.statistics[0])) * 4
  assert g.statistics[0] == [6176, 128, 128]
  assert rows == chip_smoke.JAX_SHARDED_ROOT_BYTES
  assert total == chip_smoke.JAX_SHARDED_STATE_BYTES


@pytest.mark.parametrize("option", [
    dict(compression_rank=4), dict(generate_detailed_metrics=True),
    dict(delayed_preconditioning=True),
    dict(compression_rank=2, frequent_directions=True,
         generate_fd_metrics=True),
], ids=["compression", "detailed-metrics", "delayed", "fd-metrics"])
def test_sharded_refusals_match_jax(option):
  """JAX's refusals of options the sharded mode does not take."""
  with pytest.raises(ValueError):
    _jax_opt(shard_optimizer_states=True, **option)
  with pytest.raises(ValueError):
    shampoo.distributed_shampoo(**_HYPERS, shard_optimizer_states=True,
                                **option)


def test_sharded_state_dict_holds_the_ranks_rows():
  """`DistributedShampoo` with `shard_optimizer_states` builds its state
  by ``init(None).init_fn`` and its `state_dict` round-trips it."""
  params = [torch.nn.Parameter(torch.randn(s)) for s in _TREE.values()]
  opt = shampoo.DistributedShampoo(
      params, lr=0.1, block_size=8, num_devices_for_pjit=2,
      best_effort_shape_interpretation=False, shard_optimizer_states=True)
  for p in params:
    p.grad = torch.randn_like(p)
  opt.step()
  state = opt.shampoo_state
  assert isinstance(state.stats, sharded_shampoo.ShardedShampooStats)
  assert tuple(state.stats.global_stats.statistics.shape) == (_ROWS, _M, _M)
  tree = opt.state_dict()
  again = shampoo.state_from_tree(tree["shampoo_state"])
  leaves_a, leaves_b = [], []
  torch_ranks.tree_map(leaves_a.append, state)
  torch_ranks.tree_map(leaves_b.append, again)
  assert len(leaves_a) == len(leaves_b)
  for a, b in zip(leaves_a, leaves_b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)
