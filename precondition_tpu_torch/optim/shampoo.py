"""Distributed Shampoo on one device, in PyTorch.

Port of the single-device mode of `precondition_tpu/optim/shampoo.py`.  For
each parameter block ``G`` the optimizer keeps Kronecker-factor statistics
per axis and preconditions with their inverse ``2k``-th roots, ``k`` the
number of preconditioned axes.  One update has three phases:

1. statistics: the EMA of batched Gram products, one `torch.bmm` per
   preconditioned axis and group of equal-shape blocks;
2. root solve: statistics gathered into one ``[N, m, m]`` batch per
   exponent, then the solver ``solver_backend`` and ``eigh`` pick (by
   default one batched power iteration for the ridge's lambda_max and the
   coupled-Newton kernel, `ops/kernels/newton_root.py`: the CUDA kernel for
   a CUDA tensor, its plain twin on the CPU), and a failure gate that keeps
   the old root where a solve failed;
3. transform: grafting, the per-axis preconditioning contraction, the
   graft-norm rescale, momentum and Nesterov.

State layouts (`Preconditioner`): uniform-block params keep per-axis
``[nb, d, d]`` stacks in the default mode; ragged params, and every param
under ``best_effort_memory_usage_reduction``, ``compression_rank`` or
``frequent_directions``, keep the JAX package's per-block lists, which the
memory-reduced mode stores as int16 `QuantizedValue`s with an f32
diagonal beside int8 momenta.

Compressed modes (`ops/lowrank.py`): with ``compression_rank = k != 0`` a
block of size ``d > |k| + 2`` keeps a packed ``[d, |k| + 2]`` root, solved
by one batched eigendecomposition per exponent (`low_rank_root`); with
``frequent_directions`` its statistic is the gradient's Cholesky factor
(one batched QR per group of equal blocks) and its root a
frequent-directions sketch (`fd_update_root`, one batched SVD).  Smaller
blocks keep full roots.  ``lobpcg_topk_precondition`` deflates the full
roots' statistics first and takes the per-matrix solver.

Distribution (`parallel/mesh.py`): with ``batch_axis_name`` (a
`torch.distributed.ProcessGroup`, or a string for the default group) or a
``preconditioner_partition_spec`` made by `parallel.mesh.sharding`, each
solve group is padded to a multiple of the shard count and every rank of
the group solves its contiguous slice; one all-gather returns the roots and
the metrics to every rank.  ``shard_optimizer_states`` keeps statistics and
roots as one global ``[N, m, m]`` array split over the ranks
(`optim/sharded_shampoo.py`).

`distributed_shampoo` returns the functional ``init``/``update`` pair with
the JAX signature; `DistributedShampoo` wraps it as a
`torch.optim.Optimizer`.  Parameters are a flat dict of name -> tensor
(`utils.convert.params_from_numpy` flattens a JAX tree into one).  The
precision options raise `NotImplementedError`.  Frequency gates are
host-side ``if``s on the step count.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np
import torch
from torch.profiler import record_function

from precondition_tpu_torch.ops import lowrank
from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.kernels import newton_root
from precondition_tpu_torch.ops.pth_root import RootMetrics
from precondition_tpu_torch.parallel import mesh as mesh_lib
from precondition_tpu_torch.utils import diagnostics
from precondition_tpu_torch.utils import shapes as shape_utils
from precondition_tpu_torch.utils.quantization import QuantizedValue

_EPSILON = 1e-25


class GraftingType(enum.IntEnum):
  """Which first-order method supplies the per-layer step size."""
  NONE = 0
  SGD = 1
  ADAGRAD = 2
  RMSPROP = 3
  RMSPROP_NORMALIZED = 4
  SQRT_N = 5
  ADAGRAD_NORMALIZED = 6


class PreconditionerType(enum.IntEnum):
  """Which axes get Kronecker factors."""
  ALL = 1
  INPUT = 2   # one-sided: all but the last (output) dim
  OUTPUT = 3  # one-sided: only the last dim


@dataclasses.dataclass
class ParameterStats:
  """Per-parameter Shampoo state.

  ``statistics`` and ``preconditioners`` hold one ``[nb, d, d]`` stack per
  preconditioned axis (stacked layout) or one entry per (block, axis),
  block-major (legacy layout; `QuantizedValue`s in the quantized mode, as
  are both momenta there).  A compressed legacy entry's root is a packed
  f32 ``[d, |k| + 2]`` buffer, and in the frequent-directions mode its
  statistic is the last gradient's Cholesky factor.
  """
  diagonal_statistics: Optional[torch.Tensor]  # grafting accumulator
  statistics: list                     # Kronecker factors
  preconditioners: list                # matching inverse roots
  diagonal_momentum: Union[torch.Tensor, QuantizedValue]  # grafting's
  momentum: Union[torch.Tensor, QuantizedValue]  # the preconditioned one's
  avg_grad: Optional[torch.Tensor]     # FD gradient average (average_grad)
  training_metrics: Optional[RootMetrics]  # [num_statistics] fields


@dataclasses.dataclass
class ShampooState:
  count: int
  stats: Dict[str, ParameterStats]


class GradientTransformation(NamedTuple):
  init: Callable[[Mapping[str, torch.Tensor]], ShampooState]
  update: Callable[..., Tuple[Dict[str, torch.Tensor], ShampooState]]


class _SolveChunk(NamedTuple):
  """``k`` statistics of one param and one size in an exponent's batch."""
  name: str              # parameter
  slots: Tuple[int, ...]  # (axis,) of a stacked param; a legacy one's entries
  d: int                 # (unpadded) matrix size
  exp: int               # root exponent
  mode: str              # solver: "full", "lowrank" or "fd"
  indices: Tuple[int, ...]  # global statistic index of each matrix
  stacked: bool

  @property
  def k(self) -> int:
    return len(self.indices)


def _is_stacked(mats) -> bool:
  """Whether a param's matrix state is per-axis ``[nb, d, d]`` stacks."""
  return (bool(mats) and not isinstance(mats[0], QuantizedValue)
          and mats[0].dim() == 3)


def _stack(entries) -> torch.Tensor:
  return torch.stack(entries)


def _unstack(stack: torch.Tensor) -> List[torch.Tensor]:
  return list(stack.unbind(0))


def _not_ported(option: str, item: str):
  return NotImplementedError(
      f"{option} is not ported to PyTorch yet; see ROADMAP.md queue 1, "
      f"item {item}")


def _all_gather_metrics(metrics: RootMetrics, shards) -> RootMetrics:
  """Every shard's ``[k]`` metrics, reports included, in shard order:
  one all-gather of the fields packed as ``[k, fields]``."""
  leaves = []
  metrics.map(leaves.append)
  packed = mesh_lib.all_gather_rows(
      torch.stack([x.to(torch.float32) for x in leaves], dim=1), shards)
  columns = iter(packed.unbind(1))
  return metrics.map(lambda x: next(columns).to(x.dtype))


def block_grams(blocks: torch.Tensor, axis: int) -> torch.Tensor:
  """``G_(a) G_(a)^T`` of each block of a ``[k, *block]`` stack along the
  block's ``axis``: one `torch.bmm`, ``[k, d, d]``."""
  flat = blocks.movedim(axis + 1, 1).reshape(blocks.shape[0],
                                             blocks.shape[axis + 1], -1)
  return torch.bmm(flat, flat.transpose(1, 2))


@functools.lru_cache(maxsize=None)
def _block_plan(shape, block_size, merge_block_size, best_effort,
                precond_type):
  """Static per-shape plan: merged shape, partitioner, preconditioned axes."""
  transformed = (list(shape) if not best_effort
                 else shape_utils.merge_small_dims(shape, merge_block_size))
  partitioner = shape_utils.BlockPartitioner(transformed, block_size)
  rank = len(partitioner.split_sizes())
  if precond_type == PreconditionerType.ALL or rank <= 1:
    precond_dims = [True] * rank
  elif precond_type == PreconditionerType.INPUT:
    precond_dims = [True] * (rank - 1) + [False]
  else:  # OUTPUT
    precond_dims = [False] * (rank - 1) + [True]
  return transformed, partitioner, precond_dims


class Preconditioner:
  """Per-parameter blocked Kronecker-factor engine.

  Two state layouts, as in the JAX package.  The stacked layout keeps one
  ``[nb, d, d]`` stack per preconditioned axis; it serves params whose
  blocks are uniform, in the default (f32) mode.  The legacy per-block
  layout keeps a list of ``[d, d]`` matrices, one per (block, axis) in
  block-major order (``b * n_on + slot``); it serves ragged params and
  every param in the quantized mode.  The legacy methods take group hooks:
  ``to_float`` turns a list of equal-shape entries into one ``[B, d, d]``
  float stack and ``from_float`` turns such a stack back into entries, so
  a group is decoded and encoded in one call each.  With a
  ``compression_rank`` the legacy roots of blocks it compresses are packed
  ``[d, |k| + 2]`` buffers (`ops.lowrank`).
  """

  def __init__(self, param, block_size, merge_small_dims_block_size,
               best_effort_shape_interpretation,
               preconditioner_type=PreconditionerType.ALL,
               compression_rank=0):
    self._original_shape = tuple(param.shape)
    self._transformed_shape, self._partitioner, self._precond_dims = (
        _block_plan(self._original_shape, block_size,
                    merge_small_dims_block_size,
                    bool(best_effort_shape_interpretation),
                    PreconditionerType(preconditioner_type)))
    self._compression_rank = compression_rank

  def exponent_for_preconditioner(self) -> int:
    # root exponent p = 2 * number of Kronecker-factored axes.
    return 2 * sum(self._precond_dims)

  def shapes_for_preconditioners(self) -> List[List[int]]:
    """Root shape per (block, preconditioned axis), in partition order:
    ``[d, d]``, or ``[d, |k| + 2]`` where compression saves memory."""
    return [[block[axis],
             lowrank.precond_dim(self._compression_rank, block[axis])]
            for block in self._partitioner.block_shapes()
            for axis, on in enumerate(self._precond_dims) if on]

  def num_statistics(self) -> int:
    return len(self.shapes_for_preconditioners())

  def stacked_layout(self) -> bool:
    """Whether the blocks are uniform (no ragged trailing block) and the
    roots full matrices."""
    return (self._partitioner.uniform_block_shape() is not None
            and self._compression_rank == 0)

  def stacked_shapes(self) -> List[tuple]:
    """Per preconditioned axis: ``(num_blocks, d, d)`` stack shapes."""
    block = self._partitioner.uniform_block_shape()
    nb = self._partitioner.num_blocks()
    return [(nb, block[a], block[a])
            for a, on in enumerate(self._precond_dims) if on]

  def updated_statistics_stacked(self, stats, grad, w1, w2
                                 ) -> List[torch.Tensor]:
    """EMA ``w1 * S + w2 * G_(a) G_(a)^T`` on the per-axis stacks."""
    reshaped = grad.reshape(self._transformed_shape)
    gs_all = self._partitioner.partition_stacked(reshaped)
    axes = [a for a, on in enumerate(self._precond_dims) if on]
    return [w1 * s + w2 * block_grams(gs_all, axis)
            for s, axis in zip(stats, axes)]

  def preconditioned_grad_stacked(self, grad, preconditioners
                                  ) -> torch.Tensor:
    """Apply per-axis stacked roots ``[nb, d, d]`` to the gradient."""
    reshaped = grad.reshape(self._transformed_shape)
    g = self._partitioner.partition_stacked(reshaped)
    slot = 0
    for on in self._precond_dims:
      if not on:
        g = g.movedim(1, -1)
        continue
      g = torch.einsum("bi...,bij->b...j", g, preconditioners[slot])
      slot += 1
    merged = self._partitioner.merge_stacked(g)
    return merged.reshape(self._original_shape)

  def block_groups(self, grad, first: int, last: int):
    """The blocks of the statistics ``[first, last)`` (the legacy layout's
    block-major order), grouped by (block shape, axis): yields ``(shape,
    axis, statistic indices, [k, *shape] blocks)``."""
    reshaped = grad.reshape(self._transformed_shape)
    axes = [a for a, on in enumerate(self._precond_dims) if on]
    uniform = self._partitioner.uniform_block_shape()
    if uniform is not None:
      # One reshape-permute blockifies every block; the groups are the axes,
      # each over a run of consecutive blocks.
      gs = self._partitioner.partition_stacked(reshaped)
      for slot, axis in enumerate(axes):
        lo = max(-(-(first - slot) // len(axes)), 0)
        hi = -(-(last - slot) // len(axes))
        if lo < hi:
          yield (uniform, axis, [b * len(axes) + slot for b in range(lo, hi)],
                 gs[lo:hi])
      return
    blocks = self._partitioner.partition(reshaped)
    groups: Dict[tuple, List[Tuple[int, int]]] = {}
    for i in range(first, last):
      b, slot = divmod(i, len(axes))
      groups.setdefault((tuple(blocks[b].shape), axes[slot]), []).append(
          (i, b))
    for (shape, axis), members in groups.items():
      yield (shape, axis, [i for i, _ in members],
             torch.stack([blocks[b] for _, b in members]))

  def statistics_from_grad(self, grad) -> List[torch.Tensor]:
    """Fresh (unweighted) Gram statistics ``G_(a) G_(a)^T`` per block/axis."""
    reshaped = grad.reshape(self._transformed_shape)
    out = []
    for g in self._partitioner.partition(reshaped):
      for axis, on in enumerate(self._precond_dims):
        if on:
          contracted = [i for i in range(g.dim()) if i != axis]
          out.append(torch.tensordot(g, g, dims=(contracted, contracted)))
    return out

  def updated_statistics_from_grad(self, stats, grad, w1, w2,
                                   to_float=_stack, from_float=_unstack,
                                   frequent_directions=False) -> list:
    """EMA ``w1 * S + w2 * G_(a) G_(a)^T`` for every block/axis entry.

    One batched Gram product per (block shape, axis) group, decoded with
    ``to_float`` and encoded with ``from_float`` a group at a time.  In the
    frequent-directions mode a compressed group's entries become the
    gradient's Cholesky factors instead, one batched QR for the group
    (`ops.lowrank.frequent_directions_update`).
    """
    new_stats = [None] * len(stats)
    for shape, axis, members, gs_group in self.block_groups(grad, 0,
                                                            len(stats)):
      if frequent_directions and lowrank.should_compress(
          self._compression_rank, shape[axis]):
        news = lowrank.frequent_directions_update(gs_group, axis)
      else:
        news = (w1 * to_float([stats[i] for i in members])
                + w2 * block_grams(gs_group, axis))
      for i, new in zip(members, from_float(news)):
        new_stats[i] = new
    return new_stats

  def preconditioned_grad(self, grad, preconditioners, to_float=_stack
                          ) -> torch.Tensor:
    """Apply the per-block roots, one batched contraction per axis for each
    group of equal-shape blocks (a packed one applied by
    `ops.lowrank.apply_low_rank_preconditioner`); ``to_float`` decodes a
    group's roots."""
    reshaped = grad.reshape(self._transformed_shape)
    n_per_block = sum(self._precond_dims)
    uniform = self._partitioner.uniform_block_shape()
    if uniform is not None:
      blocks = None
      g_groups = {uniform: (list(range(self._partitioner.num_blocks())),
                            self._partitioner.partition_stacked(reshaped))}
    else:
      blocks = self._partitioner.partition(reshaped)
      idxs_by_shape: Dict[tuple, List[int]] = {}
      for b, blk in enumerate(blocks):
        idxs_by_shape.setdefault(tuple(blk.shape), []).append(b)
      g_groups = {shape: (idxs, torch.stack([blocks[b] for b in idxs]))
                  for shape, idxs in idxs_by_shape.items()}
    out_blocks = {}
    for idxs, g in g_groups.values():
      slot = 0
      for on in self._precond_dims:
        if not on:
          g = g.movedim(1, -1)
          continue
        pres = to_float([preconditioners[b * n_per_block + slot]
                         for b in idxs])
        if pres.shape[-1] != pres.shape[-2]:
          g = lowrank.apply_low_rank_preconditioner(g, pres,
                                                    self._compression_rank)
        else:
          g = torch.einsum("bi...,bij->b...j", g, pres)
        slot += 1
      if blocks is None:
        merged = self._partitioner.merge_stacked(g)
        return merged.reshape(self._original_shape)
      out_blocks.update(zip(idxs, g.unbind(0)))
    merged = self._partitioner.merge_partitions(
        [out_blocks[b] for b in range(len(blocks))])
    return merged.reshape(self._original_shape)


def distributed_shampoo(
    learning_rate: Union[float, Callable[[int], float]],
    block_size: int = 1024,
    beta1: float = 0.9,
    beta2: float = 0.999,
    diagonal_epsilon: float = 1e-10,
    matrix_epsilon: float = 1e-6,
    weight_decay: float = 0.0,
    start_preconditioning_step: int = 5,
    preconditioning_compute_steps: int = 1,
    statistics_compute_steps: int = 1,
    best_effort_shape_interpretation: bool = True,
    graft_type: GraftingType = GraftingType.SGD,
    nesterov: bool = True,
    exponent_override: int = 0,
    batch_axis_name: Optional[str] = None,
    statistics_partition_spec=None,
    preconditioner_partition_spec=None,
    num_devices_for_pjit: Optional[int] = None,
    inverse_failure_threshold: float = 0.1,
    moving_average_for_momentum: bool = False,
    skip_preconditioning_dim_size_gt: int = 4096,
    clip_by_scaled_gradient_norm: Optional[float] = None,
    precision=None,
    tensordot_precision=None,
    relative_matrix_epsilon: bool = True,
    merge_small_dims_block_size: int = 4096,
    lobpcg_topk_precondition: int = 0,
    lobpcg_max_iter: int = 0,
    precondtioner_type: PreconditionerType = PreconditionerType.ALL,
    skip_preconditioning_rank_lt: int = 1,
    decoupled_learning_rate: bool = True,
    decoupled_weight_decay: bool = False,
    generate_training_metrics: bool = True,
    generate_detailed_metrics: bool = False,
    generate_fd_metrics: bool = False,
    reuse_preconditioner: bool = False,
    delayed_preconditioning: bool = False,
    eigh: bool = False,
    decay_preconditioning_compute_steps: bool = False,
    end_preconditioning_compute_steps: Optional[int] = None,
    shard_optimizer_states: bool = False,
    solver_backend: str = "auto",
    compression_rank: int = 0,
    frequent_directions: bool = False,
    reset_preconditioner: bool = False,
    average_grad: bool = False,
    best_effort_memory_usage_reduction: bool = False,
) -> GradientTransformation:
  """Builds the distributed Shampoo optimizer.

  Arguments carry the JAX package's names, defaults and validation.
  ``precision`` and ``tensordot_precision`` must stay None: every product
  runs in true f32 (TF32 is switched off), which is the JAX package's
  HIGHEST.

  ``solver_backend`` picks the Newton solver of full roots: "auto" and
  "pallas" take the Newton-root kernel (`ops/kernels/newton_root.py`: the
  CUDA kernel for a CUDA tensor, its plain twin on the CPU), with one
  batched power iteration at a loose 1% exit for the ridge; "xla" takes
  the batched solver `ops.pth_root.batched_inverse_pth_root`, the JAX
  package's per-matrix solver, which also takes every batch the kernel
  cannot (``eigh=True``, LOBPCG, statistics larger than
  `newton_root.MAX_M`).  Compressed roots take their eigensolvers
  (`ops/lowrank.py`) whatever the backend.

  Distribution options (JAX's semantics; one rank and none of them is the
  single-device path):
    batch_axis_name: a `torch.distributed.ProcessGroup`, or any string for
      the default group (JAX's name names the mapped axis, which in a torch
      job is the job's ranks).  Each solve group is padded to a multiple of
      the group's size, rank r solves the r-th slice, and one all-gather
      returns roots and metrics to every rank.
    statistics_partition_spec / preconditioner_partition_spec: a
      `parallel.mesh.Sharding`.  With a mesh, the solve splits over the
      group of the preconditioner spec's leading axes (JAX's ``shard_map``
      branch); a spec without a mesh or without an axis solves the whole
      batch on every rank (JAX's ``with_sharding_constraint`` branch, the
      same numbers).
    num_devices_for_pjit: pad each solve group to a multiple of this
      (default: the spec's shard count).
    shard_optimizer_states: the memory-sharded state of
      `optim/sharded_shampoo.py`; ``init(None)`` returns its
      `InitFnState`, whose ``init_fn(params)`` builds this rank's slice.
  """
  if precision is not None or tensordot_precision is not None:
    raise _not_ported("precision options (products always run in true f32)",
                      "5a (refused: every product runs in true f32)")
  if solver_backend not in ("auto", "pallas", "xla"):
    raise ValueError(f"unknown solver_backend {solver_backend!r}")
  if clip_by_scaled_gradient_norm is not None and graft_type not in (
      GraftingType.RMSPROP, GraftingType.RMSPROP_NORMALIZED):
    raise ValueError(
        "clip_by_scaled_gradient_norm only applies to RMSProp grafting.")
  if batch_axis_name and statistics_partition_spec is not None:
    raise ValueError(
        "Use either batch_axis_name (mapped) or partition specs (jit+mesh), "
        "not both.")
  if frequent_directions and compression_rank <= 0:
    raise ValueError(
        "frequent_directions requires a positive compression_rank.")
  # Windowed FD: the EMA window becomes a hard restart every
  # ~1/(1 - beta2) steps (the packed roots are zeroed) with no decay.
  reset_frequency = None
  if reset_preconditioner:
    if not frequent_directions:
      raise ValueError("reset_preconditioner requires frequent_directions.")
    reset_frequency = (int(np.round(1.0 / (1.0 - beta2)))
                       if beta2 != 1.0 else None)
    beta2 = 1.0
  if shard_optimizer_states and compression_rank:
    raise ValueError(
        "compression is not supported in the memory-sharded mode.")
  # As in JAX, generate_fd_metrics is silently off without FD.
  generate_detailed_metrics = (generate_detailed_metrics
                               and generate_training_metrics)
  generate_fd_metrics = (generate_fd_metrics and generate_training_metrics
                         and frequent_directions)
  if shard_optimizer_states and (generate_detailed_metrics
                                 or generate_fd_metrics):
    raise ValueError(
        "detailed/FD diagnostics are not supported in the memory-sharded "
        "mode; scrape them from the default (replicated-metrics) mode.")
  if delayed_preconditioning and frequent_directions:
    raise ValueError(
        "delayed_preconditioning cannot compose with frequent_directions: "
        "the FD solve consumes each gradient factor exactly once, and the "
        "delay would feed it the factor a second time.")
  if delayed_preconditioning and shard_optimizer_states:
    raise ValueError(
        "the memory-sharded mode already applies roots one step delayed "
        "(it transforms with the carried roots before solving); "
        "delayed_preconditioning only applies to the default mode.")

  graft_has_diag_stats = graft_type in (
      GraftingType.ADAGRAD, GraftingType.RMSPROP,
      GraftingType.RMSPROP_NORMALIZED, GraftingType.ADAGRAD_NORMALIZED)
  w2_ema = beta2 if beta2 == 1.0 else 1.0 - beta2
  quantized = best_effort_memory_usage_reduction
  # A spec with a mesh carries the padding multiple its split needs.
  inferred_num_shards = (mesh_lib.shard_count(preconditioner_partition_spec)
                         or mesh_lib.shard_count(statistics_partition_spec))

  def _solve_shards() -> Optional[mesh_lib.ShardGroup]:
    """The ranks that split each solve group, or None: resolved at each
    solve, so the process group may be made after the optimizer."""
    if batch_axis_name:
      return mesh_lib.process_group_shards(
          None if isinstance(batch_axis_name, str) else batch_axis_name)
    if statistics_partition_spec is not None:
      return mesh_lib.shard_group(preconditioner_partition_spec)
    return None

  def preconditioner_from_params(param) -> Preconditioner:
    return Preconditioner(param, block_size, merge_small_dims_block_size,
                          best_effort_shape_interpretation,
                          precondtioner_type, compression_rank)

  def _skip_preconditioning(param) -> bool:
    return (param.dim() < skip_preconditioning_rank_lt or
            any(s > skip_preconditioning_dim_size_gt for s in param.shape))

  # The quantized mode stores momenta as int8 and the legacy layout's
  # square statistics and roots as int16 plus an f32 diagonal; packed roots
  # stay f32.  The matrix hooks work on groups of equal-shape entries (see
  # `Preconditioner`).
  def _quantize_momentum(x):
    if quantized:
      return QuantizedValue.from_float_value(x, torch.int8)
    return x

  def _momentum_to_float(x):
    return x.to_float() if isinstance(x, QuantizedValue) else x

  def _matrices_to_float(entries) -> torch.Tensor:
    if isinstance(entries[0], QuantizedValue):
      return QuantizedValue.stack(entries).to_float()
    return torch.stack(entries)

  def _matrices_from_float(stack: torch.Tensor) -> list:
    if quantized and stack.shape[-1] == stack.shape[-2]:
      return QuantizedValue.from_float_value(
          stack, torch.int16, extract_diagonal=True, batch_dims=1).unbind()
    return list(stack.unbind(0))

  # The stacked layout serves uniform-block params in the default mode.
  use_stacked = (not quantized and not frequent_directions
                 and compression_rank == 0)

  # --------------------------------------------------------------- init --
  def _init_legacy(shapes, device):
    """Statistics ``eps I`` and identity roots (packed roots zeros) of the
    legacy layout, encoded by groups of one shape."""
    statistics = [None] * len(shapes)
    preconditioners = [None] * len(shapes)
    by_shape: Dict[tuple, List[int]] = {}
    for j, shape in enumerate(shapes):
      by_shape.setdefault(tuple(shape), []).append(j)
    for (d, width), js in by_shape.items():
      eye = torch.eye(d, dtype=torch.float32, device=device).expand(
          len(js), d, d)
      # A truncated identity means nothing in the packed layout.
      root = (eye.clone() if width == d else torch.zeros(
          (len(js), d, width), dtype=torch.float32, device=device))
      for out, value in ((statistics, matrix_epsilon * eye),
                         (preconditioners, root)):
        for j, entry in zip(js, _matrices_from_float(value)):
          out[j] = entry
    return statistics, preconditioners

  def init_fn(params: Mapping[str, torch.Tensor]) -> ShampooState:
    stats = {}
    for name, param in params.items():
      statistics, preconditioners = [], []
      num_stats = 0
      if not _skip_preconditioning(param):
        pre = preconditioner_from_params(param)
        if use_stacked and pre.stacked_layout():
          for (nb, d, _) in pre.stacked_shapes():
            eye = torch.eye(d, dtype=torch.float32, device=param.device)
            statistics.append(matrix_epsilon * eye.expand(nb, d, d).clone())
            preconditioners.append(eye.expand(nb, d, d).clone())
            num_stats += nb
        else:
          shapes = pre.shapes_for_preconditioners()
          statistics, preconditioners = _init_legacy(shapes, param.device)
          num_stats = len(shapes)
      metrics = None
      if generate_training_metrics:
        metrics = RootMetrics.zeros(num_stats, generate_detailed_metrics,
                                    generate_fd_metrics, param.device)
      stats[name] = ParameterStats(
          diagonal_statistics=(torch.zeros_like(param)
                               if graft_has_diag_stats else None),
          statistics=statistics,
          preconditioners=preconditioners,
          diagonal_momentum=_quantize_momentum(torch.zeros_like(param)),
          momentum=_quantize_momentum(torch.zeros_like(param)),
          avg_grad=(torch.zeros_like(param)
                    if frequent_directions and average_grad else None),
          training_metrics=metrics)
    return ShampooState(count=0, stats=stats)

  # --------------------------------------------------- statistics update --
  def _update_statistics(grad, state: ParameterStats, param, step):
    if _skip_preconditioning(param):
      return state
    if frequent_directions and average_grad:
      # The FD sketch sees the mean gradient of the statistics window.
      if statistics_compute_steps == 1 or step % statistics_compute_steps == 1:
        avg = grad
      else:
        avg = state.avg_grad + grad
      state = dataclasses.replace(state, avg_grad=avg)
      grad = avg / statistics_compute_steps
    if step % statistics_compute_steps != 0:
      return state
    pre = preconditioner_from_params(param)
    if _is_stacked(state.statistics):
      new = pre.updated_statistics_stacked(state.statistics, grad, w1=beta2,
                                           w2=w2_ema)
    else:
      new = pre.updated_statistics_from_grad(
          state.statistics, grad, w1=beta2, w2=w2_ema,
          to_float=_matrices_to_float, from_float=_matrices_from_float,
          frequent_directions=frequent_directions)
    return dataclasses.replace(state, statistics=new)

  # ------------------------------------------------- preconditioner solve --
  def _solve_batched(stacked, exp, pads, prevs=None):
    """Full-root solve of one exponent's ``[N, m, m]`` batch.

    The Newton-root kernel takes the batch unless ``eigh``, "xla",
    LOBPCG or a size above `newton_root.MAX_M` sends it to the per-matrix
    solver `pth_root.batched_inverse_pth_root`, as JAX sends such batches
    to its vmapped solver.  On the kernel's path the top eigenvalues come
    from one batched power iteration over the whole group with a loose 1%
    relative exit: the estimate only scales the relative ridge, power
    iteration converges from below, and the retry ladder and the failure
    gate guard the rare member that needs a larger ridge.  The kernel
    reports scalar metrics only, so the detailed residuals are rebuilt
    after it.
    """
    if (eigh or solver_backend == "xla" or lobpcg_topk_precondition
        or stacked.shape[-1] > newton_root.MAX_M):
      return pth_root.batched_inverse_pth_root(
          stacked, exp, pads, prevs, ridge_epsilon=matrix_epsilon,
          relative_matrix_epsilon=relative_matrix_epsilon, eigh=eigh,
          generate_diagnostics=generate_detailed_metrics,
          lobpcg_topk_precondition=lobpcg_topk_precondition,
          lobpcg_max_iter=lobpcg_max_iter)
    max_evs = None
    if relative_matrix_epsilon:
      max_evs = pth_root.power_iteration(
          stacked, padding_starts=pads, error_tolerance=1e-2,
          relative_tolerance=True)[1]
    roots, metrics = newton_root.batched_inverse_pth_root(
        stacked, exp, pads, prevs=prevs, max_evs=max_evs,
        ridge_epsilon=matrix_epsilon,
        relative_matrix_epsilon=relative_matrix_epsilon)
    if generate_detailed_metrics:
      eff = (matrix_epsilon
             * torch.clamp(metrics.max_eigenvalue, min=_EPSILON)
             * torch.pow(10.0, torch.clamp(metrics.retries - 1.0, min=0.0)))
      eye = torch.eye(stacked.shape[-1], dtype=torch.float32,
                      device=stacked.device)
      metrics.inverse_pth_root_diagnostics = (
          diagnostics.InversePthRootDiagnostics.create(
              roots, stacked + eff[:, None, None] * eye, exp, pads))
    return roots, metrics

  def _solve_group(mode, exp, stats, pads, prevs, step):
    """One (exponent, mode) group's roots and metrics.  ``prevs`` are the
    previous roots (packed for "fd", where they are required)."""
    if mode == "full":
      return _solve_batched(stats, exp, pads, prevs)
    if mode == "lowrank":
      return lowrank.low_rank_root(
          stats, exp, compression_rank, ridge_epsilon=matrix_epsilon,
          relative_matrix_epsilon=relative_matrix_epsilon,
          padding_starts=pads)
    if reset_frequency is not None and step % reset_frequency == 0:
      prevs = torch.zeros_like(prevs)
    return lowrank.fd_update_root(
        stats, exp, compression_rank, prevs, ridge_epsilon=matrix_epsilon,
        relative_matrix_epsilon=relative_matrix_epsilon, decay=beta2,
        padding_starts=pads, generate_fd_metrics=generate_fd_metrics)

  def _distributed_solve(solve, stats, pads, prevs, shards):
    """``solve(stats, pads, prevs)`` split over ``shards``: this rank
    solves its contiguous slice of the batch, then one all-gather of the
    roots and one of the packed metrics return the whole batch in order.
    A spec's batch that the shard count does not divide is solved whole on
    every rank, as JAX's resharding branch computes it."""
    n = stats.shape[0]
    if shards is None or (not batch_axis_name and n % shards.size):
      return solve(stats, pads, prevs)
    if n % shards.size:
      raise ValueError(f"a solve batch of {n} does not split over "
                       f"{shards.size} ranks")
    per = n // shards.size
    rows = slice(shards.index * per, (shards.index + 1) * per)
    roots, metrics = solve(stats[rows], pads[rows],
                           None if prevs is None else prevs[rows])
    return (mesh_lib.all_gather_rows(roots, shards),
            _all_gather_metrics(metrics, shards))

  def _perform_solve(step) -> bool:
    """The root-recompute gate, with the JAX package's decaying interval
    (`preconditioning_compute_steps_schedule`) in f32 when scheduled."""
    if not (decay_preconditioning_compute_steps
            and end_preconditioning_compute_steps
            and callable(learning_rate)):
      return step % preconditioning_compute_steps == 0
    f32 = np.float32
    decay_factor = f32(learning_rate(step)) / f32(learning_rate(0))
    t = (f32(preconditioning_compute_steps)
         + (f32(1.0) - decay_factor) * f32(end_preconditioning_compute_steps))
    steps_t = np.maximum((t // f32(10)) * f32(10), f32(1))
    return bool(f32(step) % steps_t == 0)

  def _update_preconditioners(states: Dict[str, ParameterStats], params,
                              step) -> Dict[str, ParameterStats]:
    """Solve inverse roots for every statistic across all params at once.

    Statistics are gathered into one ``[N, m, m]`` batch per (exponent,
    solver mode), padded to the largest ``d`` of all params: with an
    identity block for the full and low-rank solvers, and the packed
    previous roots of the FD solver with zeros to ``[m, |k| + 2]``.  A
    stacked param contributes whole ``[nb, d, d]`` stacks; a legacy
    param's per-block entries join their batch decoded a group of one size
    at a time, and take their roots back through the failure gate sliced
    to ``[:d, :width]``, JAX's slicing, and re-encoded (a failed entry
    keeps its decoded old root).  Metrics come back in the global
    statistic order: parameter by parameter, axis-major within a stacked
    param and block-major within a legacy one; each group's metrics lack
    the reports of the other modes, which are zero-filled.
    """
    if not _perform_solve(step):
      return states
    chunks: List[_SolveChunk] = []
    spans = {}  # name -> (first global index, count, chunk ids)
    stat_index = 0
    for name, state in states.items():
      first, ids = stat_index, []
      if state.statistics:
        pre = preconditioner_from_params(params[name])
        exp = (pre.exponent_for_preconditioner()
               if exponent_override == 0 else exponent_override)
        if _is_stacked(state.statistics):
          for slot, s in enumerate(state.statistics):
            k = int(s.shape[0])
            ids.append(len(chunks))
            chunks.append(_SolveChunk(name, (slot,), int(s.shape[-1]), exp,
                                      "full", tuple(range(stat_index,
                                                          stat_index + k)),
                                      True))
            stat_index += k
        else:
          by_size: Dict[int, List[int]] = {}
          for j, s in enumerate(state.statistics):
            by_size.setdefault(int(s.shape[0]), []).append(j)
          for d, js in by_size.items():
            mode = "full"
            if lowrank.should_compress(compression_rank, d):
              mode = "fd" if frequent_directions else "lowrank"
            ids.append(len(chunks))
            chunks.append(_SolveChunk(name, tuple(js), d, exp, mode,
                                      tuple(first + j for j in js), False))
          stat_index += len(state.statistics)
      spans[name] = (first, stat_index - first, ids)
    if stat_index == 0:
      return states

    max_size = max(c.d for c in chunks)
    width = lowrank.precond_dim(compression_rank, max_size)
    shards = _solve_shards()
    num_shards = (shards.size if batch_axis_name
                  else num_devices_for_pjit or inferred_num_shards or 1)
    groups: Dict[tuple, List[int]] = {}
    for ci, c in enumerate(chunks):
      groups.setdefault((c.exp, c.mode), []).append(ci)

    def chunk_mats(c: _SolveChunk, field: str) -> torch.Tensor:
      mats = getattr(states[c.name], field)
      if c.stacked:
        return mats[c.slots[0]]
      return _matrices_to_float([mats[j] for j in c.slots])

    def pad_packed(bufs: torch.Tensor) -> torch.Tensor:
      out = bufs.new_zeros((bufs.shape[0], max_size, width))
      out[:, :bufs.shape[1], :bufs.shape[2]] = bufs
      return out

    fresh = [None] * len(chunks)
    old_roots = {}  # legacy chunk id -> decoded previous roots
    group_metrics, order = [], []
    for (exp, mode), cids in sorted(groups.items()):
      cs = [chunks[ci] for ci in cids]
      grp = torch.cat([shape_utils.pad_square_stack(
          chunk_mats(c, "statistics"), max_size) for c in cs])
      pads = torch.cat([torch.full((c.k,), c.d, dtype=torch.int32,
                                   device=grp.device) for c in cs])
      prevs = None
      # The FD solver needs its previous sketches; with reuse_preconditioner
      # the full solvers warm-start from the previous accepted roots (and
      # certify each warm start, falling back to the cold ladder).
      if mode == "fd" or (mode == "full" and reuse_preconditioner):
        olds = []
        for ci, c in zip(cids, cs):
          olds.append(chunk_mats(c, "preconditioners"))
          if not c.stacked:
            old_roots[ci] = olds[-1]
        pad = pad_packed if mode == "fd" else functools.partial(
            shape_utils.pad_square_stack, max_size=max_size)
        prevs = torch.cat([pad(o) for o in olds])
      # Fillers pad the group to the shard count: identities (pads 0) for
      # the full and low-rank solvers, zeros for FD; identity warm starts,
      # zero packed sketches.  Their metrics are cut off after the solve.
      total_k = grp.shape[0]
      to_pad = (-total_k) % num_shards
      if to_pad:
        fill = grp.new_zeros((to_pad, max_size, max_size))
        if mode != "fd":
          fill += torch.eye(max_size, device=grp.device)
        grp = torch.cat([grp, fill])
        pads = torch.cat([pads, pads.new_zeros(to_pad)])
        if prevs is not None:
          prevs = torch.cat([prevs, prevs.new_zeros((to_pad, max_size, width))
                             if mode == "fd" else fill])
      roots, metrics = _distributed_solve(
          lambda s, d, w: _solve_group(mode, exp, s, d, w, step),
          grp, pads, prevs, shards)
      if to_pad:
        metrics = metrics.map(lambda x: x[:total_k])
      if generate_detailed_metrics or generate_fd_metrics:
        metrics = metrics.fill(RootMetrics.zeros(
            total_k, generate_detailed_metrics, generate_fd_metrics,
            grp.device))
      off = 0
      for ci, c in zip(cids, cs):
        fresh[ci] = roots[off:off + c.k]
        off += c.k
        order.extend(c.indices)
      group_metrics.append(metrics)
    inv = torch.from_numpy(np.argsort(np.asarray(order))).to(grp.device)
    all_metrics = RootMetrics.cat(group_metrics).map(lambda x: x[inv])
    errors = all_metrics.error
    failed = torch.isnan(errors) | (errors >= inverse_failure_threshold)

    new_states = {}
    for name, state in states.items():
      first, count, ids = spans[name]
      if count == 0:
        new_states[name] = state
        continue
      new_pre = list(state.preconditioners)
      for ci in ids:
        c = chunks[ci]
        fr = fresh[ci][:, :c.d, :lowrank.precond_dim(compression_rank, c.d)]
        if c.stacked:
          gate = failed[c.indices[0]:c.indices[0] + c.k]
          new_pre[c.slots[0]] = torch.where(
              gate[:, None, None], state.preconditioners[c.slots[0]], fr)
          continue
        gate = failed[torch.tensor(c.indices, device=failed.device)]
        old = old_roots.get(ci)
        if old is None:
          old = chunk_mats(c, "preconditioners")
        kept = torch.where(gate[:, None, None], old, fr)
        for j, entry in zip(c.slots, _matrices_from_float(kept)):
          new_pre[j] = entry
      metrics = None
      if generate_training_metrics:
        metrics = all_metrics.map(lambda x, a=first, b=first + count: x[a:b])
      new_states[name] = dataclasses.replace(
          state, preconditioners=new_pre, training_metrics=metrics)
    return new_states

  # ------------------------------------------------------ grad transform --
  def _transform_grad(grad, state: ParameterStats, param, step):
    norm = torch.linalg.vector_norm
    new_diag_stats = state.diagonal_statistics
    if graft_type in (GraftingType.ADAGRAD, GraftingType.ADAGRAD_NORMALIZED):
      scaled_grad = grad
      if graft_type == GraftingType.ADAGRAD_NORMALIZED:
        scaled_grad = grad / (norm(grad) + _EPSILON)
      new_diag_stats = state.diagonal_statistics + torch.square(scaled_grad)
      grafting_update = scaled_grad / (
          torch.sqrt(new_diag_stats) + diagonal_epsilon)
    elif graft_type in (GraftingType.RMSPROP, GraftingType.RMSPROP_NORMALIZED):
      scaled_grad = grad
      if graft_type == GraftingType.RMSPROP_NORMALIZED:
        scaled_grad = grad / (norm(grad) + _EPSILON)
      new_diag_stats = (beta2 * state.diagonal_statistics
                        + w2_ema * torch.square(scaled_grad))
      grafting_update = scaled_grad / (
          torch.sqrt(new_diag_stats) + diagonal_epsilon)
      if clip_by_scaled_gradient_norm:
        scaled_norm = (norm(grafting_update) /
                       np.sqrt(float(grafting_update.numel())))
        denom = torch.clamp(scaled_norm / clip_by_scaled_gradient_norm,
                            min=1.0)
        grafting_update = grafting_update / denom
    elif graft_type in (GraftingType.SGD, GraftingType.NONE):
      grafting_update = grad
    else:  # SQRT_N: sign(g), norm sqrt(size)
      grafting_update = torch.sign(grad)

    lr = learning_rate(step) if callable(learning_rate) else learning_rate
    precond_multiplier = lr if not decoupled_learning_rate else 1.0
    grafting_update = grafting_update * precond_multiplier

    if not _skip_preconditioning(param):
      pre = preconditioner_from_params(param)
      if _is_stacked(state.preconditioners):
        precond_grad = pre.preconditioned_grad_stacked(
            grad, state.preconditioners)
      else:
        precond_grad = pre.preconditioned_grad(
            grad, state.preconditioners, to_float=_matrices_to_float)
    else:
      precond_grad = grafting_update

    if graft_type != GraftingType.NONE:
      multiplier = norm(grafting_update) / (norm(precond_grad) + _EPSILON)
    else:
      multiplier = 1.0
    shampoo_update = precond_grad * multiplier

    shampoo_wd = shampoo_update
    graft_wd = grafting_update
    if weight_decay != 0 and not decoupled_weight_decay:
      shampoo_wd = shampoo_update + weight_decay * param
      graft_wd = grafting_update + weight_decay * param

    w = (1.0 - beta1) if moving_average_for_momentum else 1.0
    shampoo_mom = _momentum_to_float(state.momentum) * beta1 + w * shampoo_wd
    graft_mom = (_momentum_to_float(state.diagonal_momentum) * beta1
                 + w * graft_wd)

    run_shampoo = step >= start_preconditioning_step
    momentum_update = shampoo_mom if run_shampoo else graft_mom
    wd_update = shampoo_wd if run_shampoo else graft_wd

    if nesterov:
      momentum_out = w * wd_update + beta1 * momentum_update
    else:
      momentum_out = momentum_update

    if weight_decay != 0 and decoupled_weight_decay:
      wd_lr = 1.0 if decoupled_learning_rate else lr
      momentum_out = momentum_out + wd_lr * weight_decay * param

    momentum_multiplier = lr if decoupled_learning_rate else 1.0
    transformed = -1.0 * momentum_multiplier * momentum_out

    new_state = dataclasses.replace(
        state, diagonal_statistics=new_diag_stats,
        diagonal_momentum=_quantize_momentum(graft_mom),
        momentum=_quantize_momentum(shampoo_mom))
    return transformed, new_state

  # ------------------------------------------------------------- update --
  @torch.no_grad()
  def update_fn(grads: Mapping[str, torch.Tensor], state: ShampooState,
                params: Mapping[str, torch.Tensor]):
    pth_root.require_true_f32()
    step = state.count
    stats = state.stats
    # The profiler scopes carry the JAX package's named-scope names.
    statistics_scope = record_function("ShampooStatistics")
    solve_scope = record_function("ShampooRootSolve")
    if delayed_preconditioning:
      # Solve from the carried statistics (through step t-1): the roots
      # applied at step t lag one statistics update.
      with solve_scope:
        solved = _update_preconditioners(stats, params, step)
      with statistics_scope:
        new_stats = {
            n: dataclasses.replace(
                _update_statistics(grads[n], s, params[n], step),
                preconditioners=solved[n].preconditioners,
                training_metrics=solved[n].training_metrics)
            for n, s in stats.items()}
    else:
      with statistics_scope:
        new_stats = {n: _update_statistics(grads[n], s, params[n], step)
                     for n, s in stats.items()}
      with solve_scope:
        new_stats = _update_preconditioners(new_stats, params, step)
    updates = {}
    with record_function("ShampooPrecondition"):
      for n, s in new_stats.items():
        updates[n], new_stats[n] = _transform_grad(grads[n], s, params[n],
                                                   step)
    return updates, ShampooState(count=step + 1, stats=new_stats)

  if shard_optimizer_states:
    from precondition_tpu_torch.optim import sharded_shampoo

    init_fn_state, sharded_update_fn = sharded_shampoo.make_sharded_fns(
        preconditioner_from_params=preconditioner_from_params,
        skip_preconditioning=_skip_preconditioning,
        transform_grad=_transform_grad,
        solve_batched=_solve_batched,
        graft_has_diag_stats=graft_has_diag_stats,
        matrix_epsilon=matrix_epsilon,
        beta2=beta2,
        statistics_compute_steps=statistics_compute_steps,
        exponent_override=exponent_override,
        statistics_partition_spec=statistics_partition_spec,
        num_devices_for_pjit=num_devices_for_pjit,
        preconditioning_compute_steps=preconditioning_compute_steps,
        inverse_failure_threshold=inverse_failure_threshold,
        generate_training_metrics=generate_training_metrics,
        reuse_preconditioner=reuse_preconditioner,
    )
    return GradientTransformation(init_fn_state, sharded_update_fn)

  return GradientTransformation(init_fn, update_fn)


def state_to_tree(state: ShampooState) -> dict:
  """The state as nested dicts and lists of tensors and plain values, the
  form `torch.save` keeps and `torch.load(weights_only=True)` reads; a
  memory-sharded state keeps this rank's rows
  (`sharded_shampoo.state_to_tree`)."""
  if not isinstance(state.stats, dict):
    from precondition_tpu_torch.optim import sharded_shampoo
    return sharded_shampoo.state_to_tree(state)

  def leaf(x):
    if isinstance(x, QuantizedValue):
      return {"quantized": x.quantized, "diagonal": x.diagonal,
              "bucket_size": x.bucket_size,
              "quantized_dtype": str(x.quantized_dtype).split(".")[-1],
              "extract_diagonal": x.extract_diagonal, "shape": list(x.shape)}
    return x

  def metrics(m):
    if m is None:
      return None
    return {f.name: (getattr(m, f.name) if f.name not in pth_root.REPORTS
                     or getattr(m, f.name) is None
                     else dataclasses.asdict(getattr(m, f.name)))
            for f in dataclasses.fields(m)}

  return {"count": state.count, "stats": {
      name: {"diagonal_statistics": ps.diagonal_statistics,
             "statistics": [leaf(s) for s in ps.statistics],
             "preconditioners": [leaf(p) for p in ps.preconditioners],
             "diagonal_momentum": leaf(ps.diagonal_momentum),
             "momentum": leaf(ps.momentum),
             "avg_grad": ps.avg_grad,
             "training_metrics": metrics(ps.training_metrics)}
      for name, ps in state.stats.items()}}


def state_from_tree(tree: dict, device=None) -> ShampooState:
  """Inverse of `state_to_tree`; tensors move to ``device`` when given."""
  if tree.get("sharded"):
    from precondition_tpu_torch.optim import sharded_shampoo
    return sharded_shampoo.state_from_tree(tree, device)
  move = lambda t: t if t is None or device is None else t.to(device)

  def leaf(x):
    if isinstance(x, dict):
      return QuantizedValue(
          move(x["quantized"]), move(x["diagonal"]), move(x["bucket_size"]),
          getattr(torch, x["quantized_dtype"]), x["extract_diagonal"],
          tuple(x["shape"]))
    return move(x)

  def metrics(m):
    if m is None:
      return None
    return RootMetrics(**{
        k: (move(v) if k not in pth_root.REPORTS or v is None
            else pth_root.REPORTS[k](**{f: move(x) for f, x in v.items()}))
        for k, v in m.items()})

  return ShampooState(count=int(tree["count"]), stats={
      name: ParameterStats(
          diagonal_statistics=move(ps["diagonal_statistics"]),
          statistics=[leaf(s) for s in ps["statistics"]],
          preconditioners=[leaf(p) for p in ps["preconditioners"]],
          diagonal_momentum=leaf(ps["diagonal_momentum"]),
          momentum=leaf(ps["momentum"]),
          avg_grad=move(ps.get("avg_grad")),
          training_metrics=metrics(ps["training_metrics"]))
      for name, ps in tree["stats"].items()})


class DistributedShampoo(torch.optim.Optimizer):
  """`torch.optim.Optimizer` over the functional `distributed_shampoo`.

  One parameter group.  ``lr`` is read from the group at every step, so
  `torch.optim.lr_scheduler` schedulers work; the decaying solve interval
  (``decay_preconditioning_compute_steps``) divides it by the schedule's
  start, the group's ``initial_lr`` (the ``lr`` at construction when no
  scheduler set one).  The other keyword arguments are those of
  `distributed_shampoo`.  Every parameter needs a gradient at
  every step.  The Shampoo state lives in ``self.shampoo_state``;
  `state_dict` carries it under ``"shampoo_state"`` (see `state_to_tree`)
  and `load_state_dict` restores it onto the parameters' device.  With
  ``shard_optimizer_states`` the state is built by the sharded mode's
  ``init(None).init_fn`` and holds this rank's rows, and so does
  `state_dict`.
  """

  def __init__(self, params, lr: float, **kwargs):
    super().__init__(params, dict(lr=lr))
    if len(self.param_groups) != 1:
      raise NotImplementedError("DistributedShampoo takes one parameter group")
    self._named = {str(i): p
                   for i, p in enumerate(self.param_groups[0]["params"])}

    def learning_rate(step):
      # The current step's rate is the group's; any other step the
      # functional form asks for is step 0, the schedule's start.
      group = self.param_groups[0]
      if step == self.shampoo_state.count:
        return group["lr"]
      return group.get("initial_lr", lr)

    self._transform = distributed_shampoo(learning_rate=learning_rate,
                                          **kwargs)
    init = self._transform.init
    if kwargs.get("shard_optimizer_states"):
      init = init(None).init_fn
    self.shampoo_state = init({n: p.detach() for n, p in self._named.items()})

  def state_dict(self):
    out = super().state_dict()
    out["shampoo_state"] = state_to_tree(self.shampoo_state)
    return out

  def load_state_dict(self, state_dict):
    state_dict = dict(state_dict)
    tree = state_dict.pop("shampoo_state")
    super().load_state_dict(state_dict)
    device = next(iter(self._named.values())).device
    self.shampoo_state = state_from_tree(tree, device)

  @torch.no_grad()
  def step(self, closure=None):
    loss = None
    if closure is not None:
      with torch.enable_grad():
        loss = closure()
    grads = {}
    for n, p in self._named.items():
      if p.grad is None:
        raise ValueError(f"parameter {n} has no gradient")
      grads[n] = p.grad
    updates, self.shampoo_state = self._transform.update(
        grads, self.shampoo_state,
        {n: p.detach() for n, p in self._named.items()})
    for n, p in self._named.items():
      p.add_(updates[n])
    return loss
