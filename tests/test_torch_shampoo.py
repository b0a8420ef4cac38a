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
* compressed modes: eigenvectors and singular vectors are defined up to
  sign, and within a tied eigenvalue up to a rotation, so a packed
  ``[d, k + 2]`` root is compared as the operator it applies beside its
  scalar columns (`_packed_operator`), at the roots' tolerance; an
  FD statistic is a QR factor, defined up to its columns' signs, so
  ``L L^T`` is compared at the statistics' tolerance; a low-rank member's
  error is an absolute eigendecomposition residual like eigh's; the FD,
  LOBPCG and conditioned-residual reports atol 1e-4 of the field's largest
  value (1e-6 at least, for orthogonality residuals at rounding level),
  rtol 1e-3 (products of roots that agree to 1e-3), LOBPCG iterations
  within 1; under LOBPCG the error is that of the re-deflated root against
  the undeflated problem, rtol 1e-3 and atol 1e-3 as in
  `tests/test_torch_lobpcg.py`, and the residual reports atol 1e-2: they
  hold the residuals of roots whose A + rI has a condition number up to
  1e6 (the relative ridge), where the two sides' f32 rounding, of
  deflations that agree to 1e-4, reaches 2e-3 (measured);
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

import dataclasses
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
from precondition_tpu_torch.ops import lowrank
from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.kernels import newton_root
from precondition_tpu_torch.optim import shampoo
from precondition_tpu_torch.parallel import mesh
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
  port_state = convert.state_from_numpy(jax.tree.map(np.asarray, jax_state),
                                        device="cpu")
  port_params = convert.params_from_numpy(params, device="cpu")
  update = jax.jit(jax_opt.update)
  for g in grads:
    jax_upd, jax_state = update(jax.tree.map(jnp.asarray, g), jax_state,
                                jax_params)
    port_upd, port_state = port_opt.update(
        convert.params_from_numpy(g, device="cpu"), port_state, port_params)
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


def _packed_operator(packed):
  """``U diag(inv) U^T + const (I - U U^T)`` of a packed ``[d, k + 2]``
  root beside its scalar columns: what a packed root applies, whatever
  basis its tied eigenvalues took."""
  k = packed.shape[1] - 2
  u, inv, const = packed[:, :k], packed[:k, -2], packed[0, -1]
  return np.concatenate([(u * inv) @ u.T + const * (np.eye(len(u)) - u @ u.T),
                         packed[:, k:]], axis=1)


def _assert_step_parity(jax_upd, jax_state, port_upd, port_state,
                        quantized=False, eigh=False, fd_rank=0, lobpcg=False):
  """``fd_rank``: the compression rank of the FD mode, whose compressed
  statistics are QR factors."""
  for path, u in convert._flatten(jax_upd):
    _assert_update_close(port_upd[path].numpy(), u, path, quantized)
  ours = dict(convert._flatten(
      convert.state_to_numpy(port_state, jax_state).stats))
  assert int(port_state.count) == int(jax_state.count)
  for path, ref in convert._flatten(jax_state.stats):
    got = ours[path]
    for s_o, s_r in zip(got.statistics, ref.statistics, strict=True):
      s_o, s_r = _decoded(s_o), _decoded(s_r)
      if lowrank.should_compress(fd_rank, s_r.shape[0]):
        s_o, s_r = s_o @ s_o.T, s_r @ s_r.T
      np.testing.assert_allclose(
          s_o, s_r, rtol=1e-5,
          atol=(1e-4 if quantized else 1e-6) * np.abs(s_r).max(),
          err_msg=path)
    for r_o, r_r in zip(got.preconditioners, ref.preconditioners,
                        strict=True):
      r_o, r_r = _decoded(r_o), _decoded(r_r)
      if r_r.ndim == 2 and r_r.shape[0] != r_r.shape[1]:
        r_o, r_r = _packed_operator(r_o), _packed_operator(r_r)
      np.testing.assert_allclose(
          r_o, r_r, rtol=1e-2 if quantized else 1e-3,
          atol=(1e-3 if quantized else 1e-5) * np.abs(r_r).max(),
          err_msg=path)
    if hasattr(ref.avg_grad, "shape"):
      np.testing.assert_allclose(got.avg_grad, ref.avg_grad, rtol=1e-6,
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
    # Under LOBPCG: the tolerance of tests/test_torch_lobpcg.py.
    np.testing.assert_allclose(m_o.error, m_r.error,
                               atol=1e-3 if lobpcg else atol,
                               rtol=1e-3 if lobpcg else 1e-7)
    d_r = getattr(m_r, "inverse_pth_root_diagnostics", None)
    if hasattr(d_r, "p"):
      d_o = m_o.inverse_pth_root_diagnostics
      np.testing.assert_array_equal(d_o.p, d_r.p)
      for f in ("max_diag_error", "avg_diag_error", "max_off_diag_error",
                "avg_off_diag_error"):
        np.testing.assert_allclose(getattr(d_o, f), getattr(d_r, f),
                                   atol=1e-2 if lobpcg else 1e-4,
                                   rtol=1e-3 if lobpcg else 1e-7,
                                   err_msg=f"{path} {f}")
    for name in ("lobpcg", "conditioned_inverse_pth_root_diagnostics", "fd"):
      r_r = getattr(m_r, name)
      if not dataclasses.is_dataclass(r_r):
        continue
      r_o = getattr(m_o, name)
      for f in dataclasses.fields(r_r):
        want = np.asarray(getattr(r_r, f.name))
        np.testing.assert_allclose(
            getattr(r_o, f.name), want, rtol=1e-3,
            atol=(1 if f.name == "lobpcg_iters"
                  else max(1e-4 * np.abs(want).max(initial=0.0),
                           1e-2 if lobpcg else 1e-6)),
            err_msg=f"{path} {name}.{f.name}")


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


# The JAX package's mixed-size FD finding: a statistic smaller than the
# largest of its tree loses its sketch's eigenvalues, which `fd_update_root`
# writes to the last k rows of the [max_size, k + 2] batch buffer
# (precondition_tpu/ops/lowrank.py:66) and the gate slices off to [:d]
# (precondition_tpu/optim/shampoo.py:1127-1128).  The port keeps it.
_MIXED = {"a": (8, 8), "b": (16, 16)}
_MIXED_FD = dict(compression_rank=2, frequent_directions=True, block_size=16,
                 merge_small_dims_block_size=1)
_FD = dict(compression_rank=3, frequent_directions=True)
# Trees without ties.  A negative rank keeps A's smallest eigenvalues,
# which the first steps' low-rank Gram statistics repeat, and a positive
# one the largest: a tree whose blocks repeat at most |k| = 4 of the
# smallest keeps whole eigenspaces, so the kept vectors span one subspace
# on both sides.  FD needs every compressed block's gradient factor to
# have rank > k: at rank <= k the (k+1)-th singular value is a rounding
# residual that one LAPACK build returns as 0 and another as 1e-9, and the
# tail's inverse root jumps from 0 to 1e4.  Blocks [8, 8], [8, 4], [4, 8]
# and [4, 4] at block 8 (sizes 4 take full roots) serve both.  LOBPCG
# needs 5k < 16, with distinct top eigenvalues: blocks [16, 16], [16, 8],
# [8, 16] and [8, 8] at block 16.
_LOWRANK = {"w": (16, 24), "r": (12, 20)}
_LOBPCG = {"w": (32, 48), "r": (24, 40)}


@pytest.mark.usefixtures("jax_kernel_path")
@pytest.mark.parametrize("case", [
    dict(shapes=_LOWRANK, hypers=dict(compression_rank=4, **_UNMERGED)),
    dict(shapes=_LOWRANK, hypers=dict(compression_rank=-4, **_UNMERGED)),
    dict(shapes=_LOWRANK, hypers=dict(**_FD, **_UNMERGED)),
    dict(steps=6, shapes=_LOWRANK, hypers=dict(
        **_FD, reset_preconditioner=True, beta2=0.75, **_UNMERGED)),
    dict(steps=4, shapes=_LOWRANK, hypers=dict(
        **_FD, average_grad=True, statistics_compute_steps=2, **_UNMERGED)),
    dict(shapes=_LOWRANK, hypers=dict(**_FD, generate_fd_metrics=True,
                                      generate_detailed_metrics=True,
                                      **_UNMERGED)),
    dict(shapes=_LOBPCG, hypers=dict(
        lobpcg_topk_precondition=2, generate_detailed_metrics=True,
        block_size=16, best_effort_shape_interpretation=False)),
    dict(shapes=_LOBPCG, hypers=dict(
        lobpcg_topk_precondition=2, lobpcg_max_iter=10, block_size=16,
        best_effort_shape_interpretation=False)),
    dict(shapes=_LOWRANK, hypers=dict(compression_rank=4,
                                      best_effort_memory_usage_reduction=True,
                                      **_UNMERGED)),
    dict(shapes=_MIXED, hypers=_MIXED_FD),
], ids=["low-rank", "low-rank-negative", "fd", "fd-reset-every-4",
        "fd-average-grad-stats-every2", "fd-metrics-detailed", "lobpcg",
        "lobpcg-ten-iterations",
        "quantized-low-rank", "fd-mixed-sizes"])
def test_compressed_modes_match_jax(case):
  """Three updates (six for the reset, whose beta2 = 0.75 zeroes the FD
  roots at step 4; four for the average over two steps), on the trees
  without ties above."""
  hypers = {"graft_type": shampoo.GraftingType.RMSPROP, **case["hypers"]}
  fd_rank = (hypers["compression_rank"]
             if hypers.get("frequent_directions") else 0)
  for step in _run_both(case.get("steps", 3), seed=4,
                        shapes=case.get("shapes", _SHAPES), **hypers):
    _assert_step_parity(
        *step, quantized=hypers.get("best_effort_memory_usage_reduction",
                                    False),
        eigh=bool(hypers.get("compression_rank")) and not fd_rank,
        fd_rank=fd_rank, lobpcg=bool(hypers.get("lobpcg_topk_precondition")))


def _fd_deflated_rows(shapes):
  """The deflated-eigenvalue rows of the (8, 8) param's packed roots after
  two FD steps of the port alone."""
  opt = shampoo.distributed_shampoo(learning_rate=0.1,
                                    start_preconditioning_step=1, **_MIXED_FD)
  gen = torch.Generator().manual_seed(0)
  params = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
  state = opt.init(params)
  for _ in range(2):
    _, state = opt.update({n: torch.randn(s, generator=gen)
                           for n, s in shapes.items()}, state, params)
  return torch.stack([b[-2:, -1] for b in state.stats["a"].preconditioners])


def test_fd_mixed_sizes_keep_the_jax_finding():
  """Alone, the (8, 8) param keeps its sketch's eigenvalues in the last
  rows of its packed roots; beside a (16, 16) param they are lost, as in
  the JAX package (see _MIXED)."""
  assert bool((_fd_deflated_rows({"a": (8, 8)}) > 0).all())
  assert bool((_fd_deflated_rows(_MIXED) == 0).all())


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


def test_wrapper_decay_schedule_divides_by_the_initial_lr():
  """`DistributedShampoo` under a `LambdaLR` schedule stretches the solve
  interval as the functional form does: the roots stay at step 3."""
  gen = torch.Generator().manual_seed(0)
  w = torch.nn.Parameter(torch.ones(8, 8))
  opt = shampoo.DistributedShampoo(
      [w], lr=0.1, block_size=8, decay_preconditioning_compute_steps=True,
      end_preconditioning_compute_steps=13, start_preconditioning_step=0)
  sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0 / (1.0 + s))
  seen = []
  for _ in range(4):
    before = opt.shampoo_state.stats["0"].preconditioners[0]
    w.grad = torch.randn(8, 8, generator=gen)
    opt.step()
    sched.step()
    seen.append(opt.shampoo_state.stats["0"].preconditioners[0] is before)
  assert seen == [False, False, False, True]


def test_statistic_above_the_kernels_limit_takes_the_batched_solver(
    monkeypatch):
  """A batch larger than `newton_root.MAX_M` (here patched to 8) is solved
  by `pth_root.batched_inverse_pth_root`, as "xla" solves it, where the
  kernel would refuse it."""
  monkeypatch.setattr(newton_root, "MAX_M", 8)
  gen = torch.Generator().manual_seed(0)
  params = {"w": torch.randn(11, 4, generator=gen)}
  grads = [{"w": torch.randn(11, 4, generator=gen)} for _ in range(2)]
  out = {}
  for backend in ("auto", "xla"):
    opt = shampoo.distributed_shampoo(learning_rate=0.1, block_size=16,
                                      start_preconditioning_step=0,
                                      best_effort_shape_interpretation=False,
                                      solver_backend=backend)
    state = opt.init(params)
    for g in grads:
      upd, state = opt.update(g, state, params)
    out[backend] = (upd["w"], state.stats["w"].preconditioners)
  torch.testing.assert_close(out["auto"][0], out["xla"][0], rtol=0, atol=0)
  assert float(state.stats["w"].training_metrics.error.max()) < 0.1


@pytest.mark.parametrize("name", [
    "params_from_numpy", "state_from_numpy", "sharded_state_from_numpy",
    "sm3_state_from_numpy", "tearfree_state_from_numpy"])
def test_converters_build_on_the_card_by_default(monkeypatch, name):
  """Without a device a converter builds on the card, and where there is
  none it raises; it never drops to the CPU unasked."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  args = {"params_from_numpy": ({"w": np.zeros(2, np.float32)},),
          "sharded_state_from_numpy": (None, 0, 1)}.get(name, (None,))
  with pytest.raises(RuntimeError, match="no CUDA device"):
    getattr(convert, name)(*args)
  assert convert.params_from_numpy(
      {"w": np.zeros(2, np.float32)}, device="cpu")["w"].device.type == "cpu"


@pytest.mark.parametrize("option", [dict(precision="highest")])
def test_unported_options_raise(option):
  with pytest.raises(NotImplementedError, match="ROADMAP.md"):
    shampoo.distributed_shampoo(learning_rate=0.1, **option)


@pytest.mark.parametrize("option", [
    dict(batch_axis_name="batch", statistics_partition_spec=("d",)),
    dict(shard_optimizer_states=True, compression_rank=4),
    dict(shard_optimizer_states=True, generate_detailed_metrics=True),
    dict(shard_optimizer_states=True, delayed_preconditioning=True),
], ids=["batch-axis-and-specs", "sharded-compression",
        "sharded-detailed-metrics", "sharded-delayed"])
def test_distribution_refusals_raise(option):
  """JAX's four refusals of distribution options
  (precondition_tpu/optim/shampoo.py:514-555) raise in both packages."""
  jax_option = dict(option)
  if "statistics_partition_spec" in option:
    jax_option["statistics_partition_spec"] = jax.sharding.PartitionSpec("d")
    option = dict(option, statistics_partition_spec=mesh.Sharding(None,
                                                                  ("d",)))
  with pytest.raises(ValueError):
    jax_shampoo.distributed_shampoo(learning_rate=0.1, **jax_option)
  with pytest.raises(ValueError):
    shampoo.distributed_shampoo(learning_rate=0.1, **option)


@pytest.mark.parametrize("option", [
    dict(compression_rank=4), dict(frequent_directions=True),
    dict(generate_fd_metrics=True), dict(lobpcg_topk_precondition=2),
    dict(compression_rank=-2, frequent_directions=True),
    dict(reset_preconditioner=True),
    dict(compression_rank=2, frequent_directions=True,
         delayed_preconditioning=True),
    dict(compression_rank=2, frequent_directions=True,
         reset_preconditioner=True, average_grad=True,
         generate_fd_metrics=True),
    dict(compression_rank=2, frequent_directions=True,
         generate_fd_metrics=True, generate_training_metrics=False),
    dict(average_grad=True),
], ids=["compression", "fd-without-rank", "fd-metrics-without-fd", "lobpcg",
        "fd-negative-rank", "reset-without-fd", "fd-delayed",
        "fd-reset-average-metrics", "fd-metrics-without-metrics",
        "average-grad-without-fd"])
def test_option_validation_matches_jax(option):
  """The port raises the `ValueError`s JAX raises on the same options, and
  where JAX accepts them (silently dropping `generate_fd_metrics` without
  FD or training metrics, and `average_grad` without FD) builds a state of
  the same structure: the same reports, the same gradient average."""
  try:
    jax_opt = jax_shampoo.distributed_shampoo(learning_rate=0.1, **option)
  except ValueError:
    with pytest.raises(ValueError):
      shampoo.distributed_shampoo(learning_rate=0.1, **option)
    return
  opt = shampoo.distributed_shampoo(learning_rate=0.1, **option)
  shapes = {"w": (8, 6)}
  ref = convert.state_from_numpy(jax.tree.map(np.asarray, jax_opt.init(
      _tree(lambda s: jnp.ones(s, jnp.float32), shapes))), device="cpu")
  ours = opt.init({"w": torch.ones(8, 6)})
  ps_r, ps_o = ref.stats["w"], ours.stats["w"]
  assert (ps_o.avg_grad is None) == (ps_r.avg_grad is None)
  assert (ps_o.training_metrics is None) == (ps_r.training_metrics is None)
  if ps_r.training_metrics is not None:
    for name in ("lobpcg", "inverse_pth_root_diagnostics",
                 "conditioned_inverse_pth_root_diagnostics", "fd"):
      assert ((getattr(ps_o.training_metrics, name) is None)
              == (getattr(ps_r.training_metrics, name) is None)), name
  assert ([tuple(p.shape) for p in ps_o.preconditioners]
          == [tuple(p.shape) for p in ps_r.preconditioners])


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
    dict(compression_rank=3, frequent_directions=True, average_grad=True,
         generate_fd_metrics=True, statistics_compute_steps=2),
], ids=["default", "quantized", "warm-detailed", "fd-average-metrics"])
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
  port_state = convert.state_from_numpy(jax_state, device="cpu")
  again = convert.state_from_numpy(
      convert.state_to_numpy(port_state, jax_state), device="cpu")
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
    dict(**_FD, average_grad=True, generate_fd_metrics=True,
         generate_detailed_metrics=True, **_UNMERGED),
], ids=["quantized-detailed", "ragged-detailed", "fd-average-metrics"])
def test_legacy_state_round_trip(hypers):
  """Legacy lists, `QuantizedValue` leaves and the residual report go to
  the JAX structure and back unchanged, and JAX steps on the result."""
  params = _tree(lambda s: np.ones(s, np.float32), _RAGGED)
  jax_opt = jax_shampoo.distributed_shampoo(
      **{**_HYPERS, **hypers}, graft_type=jax_shampoo.GraftingType.RMSPROP)
  jax_params = jax.tree.map(jnp.asarray, params)
  jax_state = jax.tree.map(np.asarray, jax_opt.init(jax_params))
  port_state = convert.state_from_numpy(jax_state, device="cpu")
  back = convert.state_to_numpy(port_state, jax_state)
  again = convert.state_from_numpy(back, device="cpu")
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
          "precondition_tpu_torch.ops.lowrank, "
          "precondition_tpu_torch.ops.lobpcg, "
          "precondition_tpu_torch.ops.kernels.newton_root, "
          "precondition_tpu_torch.ops.kernels.matmul_chain, "
          "precondition_tpu_torch.probes.tile_breakdown, "
          "precondition_tpu_torch.probes.step_time\n"
          "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
          " or m == 'precondition_tpu' or m.startswith('precondition_tpu.')]\n"
          "assert not bad, bad\n")
  subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
