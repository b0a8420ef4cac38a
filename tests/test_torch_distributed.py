"""The port's distributed root solve against the JAX package's, on CPU ranks.

The JAX side runs in this process on the conftest's 8 CPU devices: `pmap`
over ``k`` of them with ``batch_axis_name="batch"``, or `jit` with
`NamedSharding` specs over a mesh of them (its ``shard_map`` solve).  The
port's ranks run in spawned processes joined by gloo on 127.0.0.1
(`parallel.local.run_local_ranks`, bodies in `tests/torch_ranks.py`, which
import no JAX); each module spawns its ranks once, for every case, and
hands them numpy inputs made from a seed.  A collective is bounded by the
group's 60 s timeout and the parent's join timeout, so a hang fails the
module instead of the suite.

Trees: every solve group has a member count that 2 or 3 does not divide,
so the filler members and the cut back to the group's own count run:
full roots 20 statistics at p = 4 and 3 at p = 2; compressed (rank 2, at
block 8 blocks of 8 compress and blocks of 4 keep full roots, which take
the kernel path) 7 low-rank or FD members and 5 full ones.  The
compressed tree holds no vector, whose rank-1 statistic ties eigenvalues
(see `tests/test_torch_shampoo.py`).  Trees are small because JAX's
compile time grows with the number of parameters.

Tolerances: the JAX package's own distributed tolerance (rtol 2e-4, atol
1e-6, `tests/test_shampoo.py:574-599`) for the port's distributed run
against its one-process run (updates, roots and metrics) and for its
updates against JAX's distributed run; beside them every statistic, root
and metric against JAX's at the cross-package tolerances of
`tests/test_torch_shampoo.py` (`_assert_step_parity`, whose docstring
says why each is what it is: two f32 Newton solves agree to about 1e-3).
The JAX kernel path runs the Pallas kernel in interpret mode, with JAX's
power-iteration start vector handed to the port's ranks.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from precondition_tpu.ops.pallas import newton_root as jax_newton_root
from precondition_tpu.optim import shampoo as jax_shampoo
from precondition_tpu_torch.optim import shampoo
from precondition_tpu_torch.parallel import local

import torch_ranks
from test_torch_shampoo import _assert_step_parity

torch.set_num_threads(1)

# "w" is uniform (the stacked layout), the others ragged (per-block).
_COMPRESSED_TREE = {"r": (12, 12), "s": (8, 12)}
_FULL_TREE = {"w": (16, 24), "r": (12, 12), "v": (24,)}
_HYPERS = dict(learning_rate=0.1, block_size=8, start_preconditioning_step=1,
               graft_type=shampoo.GraftingType.RMSPROP,
               best_effort_shape_interpretation=False)
_MODES = {
    "kernel": (_FULL_TREE, dict(solver_backend="pallas")),
    "xla": (_FULL_TREE, dict(solver_backend="xla")),
    "lowrank": (_COMPRESSED_TREE, dict(compression_rank=2,
                                       solver_backend="pallas")),
    "fd": (_COMPRESSED_TREE, dict(compression_rank=2, frequent_directions=True,
                                  solver_backend="pallas")),
}
_STEPS = 3
# The full tree's solve groups, (p=2, p=4), and the meshes of the spec
# cases: (mesh shape, axis names, spec, JAX's ranks).
_FULL_GROUPS = (3, 20)
_MESHES = {
    "d2": ((2,), ("d",), ("d",)),
    "data2-model1": ((2, 1), ("data", "model"), (("data", "model"),)),
    "data2-model2": ((2, 2), ("data", "model"), (("data", "model"),)),
}
_JOIN_TIMEOUT = 300.0


def _inputs(tree, seed=0):
  rng = np.random.RandomState(seed)
  draw = lambda: {k: (rng.randn(*s) * 0.1).astype(np.float32)
                  for k, s in tree.items()}
  return draw(), [draw() for _ in range(_STEPS)]


def _hypers(mode):
  tree, extra = _MODES[mode]
  return tree, {**_HYPERS, **extra}


def _v0():
  """JAX's power-iteration start vector for the trees' size 8."""
  return {8: np.array(jax.random.uniform(jax.random.PRNGKey(1729), (8,),
                                         jnp.float32, -1.0, 1.0))}


def _jax_opt(hypers, **extra):
  return jax_shampoo.distributed_shampoo(
      **{k: jax_shampoo.GraftingType(int(v)) if k == "graft_type" else v
         for k, v in hypers.items()}, **extra)


@pytest.fixture
def jax_kernel_path(monkeypatch):
  monkeypatch.setattr(
      jax_newton_root, "batched_inverse_pth_root_pallas",
      functools.partial(jax_newton_root.batched_inverse_pth_root_pallas,
                        interpret=True))


def _job(mode, k=None, spec=None):
  tree, hypers = _hypers(mode)
  params, grads = _inputs(tree)
  return dict(k=k, spec=spec, hypers=hypers, params=params, grads=grads)


# The four-rank spawn's jobs: batch axis over k = 2 and 3 ranks for every
# mode, each mode on one process with no option, the kernel mode over 1, 2
# and 4 ranks, and a (2, 2) mesh.  The spec cases take the "xla" mode,
# whose JAX side compiles in a third of the kernel mode's time.
_JOBS4 = ([("batch", mode, k) for mode in _MODES for k in (0, 2, 3)]
          + [("batch", "kernel", k) for k in (1, 4)]
          + [("mesh", "xla", "data2-model2")])


@pytest.fixture(scope="module")
def four_ranks():
  jobs = [_job(mode, k=k) if kind == "batch" else
          _job(mode, spec=("mesh",) + _MESHES[k][:2] + _MESHES[k][2])
          for kind, mode, k in _JOBS4]
  out = local.run_local_ranks(torch_ranks.distributed_jobs, 4,
                              args=(jobs, _v0()), join_timeout=_JOIN_TIMEOUT)
  return {key: [rank[i] for rank in out] for i, key in enumerate(_JOBS4)}


@pytest.fixture(scope="module")
def two_ranks():
  keys = ("d2", "data2-model1")
  jobs = [_job("xla", spec=("mesh",) + _MESHES[k][:2] + _MESHES[k][2])
          for k in keys]
  out = local.run_local_ranks(torch_ranks.distributed_jobs, 2,
                              args=(jobs, _v0()), join_timeout=_JOIN_TIMEOUT)
  return {key: [rank[i] for rank in out] for i, key in enumerate(keys)}


def _jax_pmap_steps(k, hypers, params, grads):
  """JAX's updates and state (replica 0) per step, pmapped over k."""
  tx = _jax_opt(hypers, batch_axis_name="batch")
  devices = jax.devices()[:k]
  rep = lambda tree: jax.tree.map(
      lambda x: np.broadcast_to(x, (k,) + x.shape), tree)
  state = jax.pmap(tx.init, axis_name="batch", devices=devices)(rep(params))
  update = jax.pmap(tx.update, axis_name="batch", devices=devices)
  out = []
  for g in grads:
    u, state = update(rep(g), state, rep(params))
    out.append(jax.tree.map(lambda x: np.asarray(x[0]), (u, state)))
  return out


def _jax_mesh_steps(key, hypers, params, grads):
  """JAX's updates and state per step under specs over a mesh.  Every
  step takes its state as numpy, so that the first step's inputs are laid
  out as the later ones' and `jit` compiles once."""
  shape, names, spec = _MESHES[key]
  mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
              names)
  sh = NamedSharding(mesh, P(*spec))
  tx = _jax_opt(hypers, statistics_partition_spec=sh,
                preconditioner_partition_spec=sh)
  params = jax.tree.map(jnp.asarray, params)
  state = jax.tree.map(np.asarray, tx.init(params))
  update = jax.jit(tx.update)
  out = []
  for g in grads:
    u, state = jax.tree.map(np.asarray, update(jax.tree.map(jnp.asarray, g),
                                               state, params))
    out.append((u, state))
  return out


def _close(got, want, **tol):
  """Port results (numpy trees of the port's classes) at ``tol``."""
  got_leaves, want_leaves = [], []
  torch_ranks.tree_map(got_leaves.append, got)
  torch_ranks.tree_map(want_leaves.append, want)
  assert len(got_leaves) == len(want_leaves)
  for a, b in zip(got_leaves, want_leaves):
    np.testing.assert_allclose(a, b, **tol)


def _assert_ranks_agree(results):
  """Every rank of a job returned the same updates and state."""
  first = results[0][0]
  for other in results[1:]:
    _close(other[0], first, rtol=0, atol=0)


def _assert_matches(port_steps, jax_steps, mode):
  """Updates at the JAX package's distributed tolerance, then every
  update, statistic, root and metric at the cross-package ones."""
  for (p_upd, p_state), (j_upd, j_state) in zip(port_steps, jax_steps,
                                                strict=True):
    for name, u in p_upd.items():
      np.testing.assert_allclose(u, j_upd[name], rtol=2e-4, atol=1e-6,
                                 err_msg=name)
    _assert_step_parity(j_upd, j_state, torch_ranks.to_torch(p_upd),
                        torch_ranks.to_torch(p_state),
                        fd_rank=2 if mode == "fd" else 0)


@pytest.mark.usefixtures("jax_kernel_path")
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("mode", list(_MODES))
def test_batch_axis_matches_jax_pmap(four_ranks, mode, k):
  """k ranks under batch_axis_name against JAX's pmap over k devices, and
  against the port's one-process run of the same inputs."""
  ranks = [r for r in four_ranks[("batch", mode, k)] if r is not None]
  assert len(ranks) == k
  _assert_ranks_agree(ranks)
  steps = ranks[0][0]
  single = four_ranks[("batch", mode, 0)][0][0]
  for (upd, state), (s_upd, s_state) in zip(steps, single, strict=True):
    _close(upd, s_upd, rtol=2e-4, atol=1e-6)
    _close(state, s_state, rtol=2e-4, atol=1e-6)
  tree, hypers = _hypers(mode)
  params, grads = _inputs(tree)
  _assert_matches(steps, _jax_pmap_steps(k, hypers, params, grads), mode)


@pytest.mark.parametrize("key", list(_MESHES))
def test_partition_specs_match_jax_shard_map(four_ranks, two_ranks, key):
  """Specs over a mesh of CPU ranks against JAX's specs over a mesh of its
  devices, whose solve takes the shard_map branch: a 1-D mesh of 2 and a
  (2, 2) ("data", "model") mesh split over both axes.  A (2, 1) mesh split
  over ("data", "model") is the 1-D split: the same numbers, bit for bit
  (JAX's own test holds its two to each other, `tests/test_shampoo.py:
  683-710`)."""
  ranks = (four_ranks[("mesh", "xla", key)] if key == "data2-model2"
           else two_ranks[key])
  _assert_ranks_agree(ranks)
  if key == "data2-model1":
    _close(ranks[0][0], two_ranks["d2"][0][0], rtol=0, atol=0)
    return
  tree, hypers = _hypers("xla")
  params, grads = _inputs(tree)
  _assert_matches(ranks[0][0], _jax_mesh_steps(key, hypers, params, grads),
                  "xla")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_work_per_rank_scales_inverse_k(four_ranks, k):
  """Each rank's solver calls see its share of each padded group, N/k:
  the p = 2 group's 3 members and the p = 4 group's 26, padded to k."""
  want = [-(-n // k) for n in _FULL_GROUPS] * _STEPS
  for rank in four_ranks[("batch", "kernel", k)][:k]:
    assert rank[1] == want
  assert four_ranks[("batch", "kernel", 0)][0][1] == list(_FULL_GROUPS) * _STEPS


def test_one_rank_is_the_single_process_path(four_ranks):
  """One rank under batch_axis_name gives the updates and state of no
  option, bit for bit."""
  one = four_ranks[("batch", "kernel", 1)][0][0]
  single = four_ranks[("batch", "kernel", 0)][0][0]
  _close(one, single, rtol=0, atol=0)
