"""Memory-sharded Shampoo: one global statistics array split over the ranks.

Port of `precondition_tpu/optim/sharded_shampoo.py`.  Every block's
statistic, and its root, is one row of a global ``[N, m, m]`` array (each
padded to the largest size ``m`` with an identity block); the rows split
over the ranks of the statistics spec's group (`parallel.mesh.shard_group`
of ``statistics_partition_spec``), ZeRO-style: rank ``r`` of ``k`` holds
rows ``[r N/k, (r+1) N/k)`` and nothing else of them.  Parameters,
gradients, both momenta, the grafting accumulator and the metrics are
replicated on every rank.  Without a split (no mesh, or a group of one)
every rank holds all rows.

Layout, as in JAX: parameters are taken in JAX's flattening order (their
names sorted by ``/``-separated path, the order `utils.convert` names a
nested tree's leaves in), whatever the order of the params dict; slots
are sorted by ascending exponent, so that every exponent group is one
contiguous range of rows solved with a static exponent;
``num_devices_for_pjit`` pads ``N`` with identity slots, which join the
last group.  ``N`` must split evenly over the group.  The layout is built
once per set of parameter names and shapes; an update checks the state's
per-parameter ``index_start`` and ``sizes`` against it and raises
`ValueError` where they differ (a state made for other parameters).

``init(None)`` returns JAX's trainer contract, `InitFnState(init_fn,
pspec_fn, shape_and_dtype_fn)`: ``shape_and_dtype_fn`` gives the global
shapes (``[N, m, m]``), ``pspec_fn`` the port's `parallel.mesh.Sharding`s,
and ``init_fn(params)`` builds this rank's state, whose global arrays hold
only its rows.

One update, in JAX's order:
1. transform each gradient with the roots carried from step entry,
   all-gathered for the transform (every rank holds every parameter);
2. update the statistics of the rank's own rows.  A rank computes the Gram
   products of its own rows only (`shampoo.Preconditioner.block_groups`),
   not all of them, so the statistics' work and memory split as the state
   does;
3. solve its rows, one batch per exponent group it holds, and
4. gate each group's roots into a new slice of the preconditioners as it
   comes (a failed solve keeps the old root), so that one group's roots
   at a time are held beside the state's rows;
5. all-gather the metrics into each parameter's replicated local stats.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.pth_root import RootMetrics
from precondition_tpu_torch.optim import shampoo
from precondition_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass
class GlobalShardedParameterStats:
  """This rank's rows of the global arrays, and every slot's exponent."""
  statistics: torch.Tensor       # [N / k, m, m] of the global [N, m, m]
  preconditioners: torch.Tensor  # [N / k, m, m]
  exponents: torch.Tensor        # [N] int32, replicated


@dataclasses.dataclass
class LocalShardedParameterStats:
  """Per-parameter state, replicated like the parameter."""
  diagonal_statistics: Optional[torch.Tensor]
  diagonal_momentum: Any
  momentum: Any
  training_metrics: Optional[RootMetrics]
  index_start: int   # the parameter's first global row
  sizes: List[int]   # its statistics' sizes, block-major


class ShardedShampooStats(NamedTuple):
  global_stats: GlobalShardedParameterStats
  local_stats: Dict[str, LocalShardedParameterStats]


class InitFnState(NamedTuple):
  init_fn: Callable
  pspec_fn: Callable
  shape_and_dtype_fn: Callable


class _Layout(NamedTuple):
  """The static layout of a parameter dict's statistics."""
  slots: Dict[str, tuple]  # name -> (index_start, sizes)
  pres: Dict[str, Any]     # name -> its `shampoo.Preconditioner`, if any
  n: int                   # rows that hold statistics
  padded_n: int            # rows with the padding slots
  max_size: int
  groups: List[tuple]      # (exponent, start, count), ascending exponent
  sizes: List[int]         # per row; 0 for a padding slot
  exponents: List[int]     # per row; 1 for a padding slot


def make_sharded_fns(
    *,
    preconditioner_from_params,
    skip_preconditioning,
    transform_grad,
    solve_batched,
    graft_has_diag_stats,
    matrix_epsilon,
    beta2,
    statistics_compute_steps,
    exponent_override,
    statistics_partition_spec,
    num_devices_for_pjit,
    preconditioning_compute_steps,
    inverse_failure_threshold,
    generate_training_metrics,
    reuse_preconditioner=False,
):
  """``(init_fn_state, sharded_update_fn)``.

  The per-mode policy (the grafting and momentum transform, the batched
  solver) comes from `shampoo.distributed_shampoo`, so both modes share
  one implementation of the math; the statistics' EMA weights are
  ``beta2`` and ``1 - beta2`` (``beta2`` when it is 1), JAX's.
  """
  w2 = beta2 if beta2 == 1.0 else 1.0 - beta2

  def _exponent(pre) -> int:
    return (pre.exponent_for_preconditioner() if exponent_override == 0
            else exponent_override)

  layouts: Dict[tuple, _Layout] = {}

  def _layout(params) -> _Layout:
    """The layout of ``params``, built on the first call for their names
    and shapes."""
    key = tuple(sorted((name, tuple(p.shape)) for name, p in params.items()))
    if key not in layouts:
      layouts[key] = _build_layout(params)
    return layouts[key]

  def _build_layout(params) -> _Layout:
    per_param, pres = {}, {}
    for name in sorted(params, key=lambda name: name.split("/")):
      param = params[name]
      if skip_preconditioning(param):
        per_param[name] = ([], 0)
        continue
      pres[name] = pre = preconditioner_from_params(param)
      per_param[name] = ([s[0] for s in pre.shapes_for_preconditioners()],
                         _exponent(pre))
    order = sorted((name for name, (s, _) in per_param.items() if s),
                   key=lambda name: per_param[name][1])
    slots, groups, sizes, exponents = {}, [], [], []
    for name in order:
      ds, exp = per_param[name]
      slots[name] = (len(sizes), ds)
      if groups and groups[-1][0] == exp:
        groups[-1] = (exp, groups[-1][1], groups[-1][2] + len(ds))
      else:
        groups.append((exp, len(sizes), len(ds)))
      sizes += ds
      exponents += [exp] * len(ds)
    n = len(sizes)
    for name, (ds, _) in per_param.items():
      if not ds:
        slots[name] = (n, [])
    padded_n = n
    if num_devices_for_pjit:
      padded_n = -(-n // num_devices_for_pjit) * num_devices_for_pjit
    if padded_n > n and groups:
      # Identity padding slots join the last group: any exponent is exact
      # on the identity.
      exp, start, count = groups[-1]
      groups[-1] = (exp, start, count + padded_n - n)
    sizes += [0] * (padded_n - n)
    exponents += [1] * (padded_n - n)
    return _Layout(slots, pres, n, padded_n, max(sizes, default=0), groups,
                   sizes, exponents)

  def _check_state(layout: _Layout, global_stats, local_stats, rows: int):
    """Raises `ValueError` where the state's rows are not the layout's:
    ``rows`` of the global arrays on this rank, each parameter's
    ``index_start`` and ``sizes``."""
    if global_stats.statistics.shape[0] != rows:
      raise ValueError(
          f"the state holds {global_stats.statistics.shape[0]} rows on this "
          f"rank; its parameters' layout gives it {rows}")
    if set(local_stats) != set(layout.slots):
      raise ValueError(
          f"the state holds the parameters {sorted(local_stats)}, not "
          f"{sorted(layout.slots)}")
    for name, (index_start, ds) in layout.slots.items():
      local = local_stats[name]
      if (local.index_start, list(local.sizes)) != (index_start, ds):
        raise ValueError(
            f"the state puts {name!r} at row {local.index_start} with sizes "
            f"{list(local.sizes)}; its parameters' layout puts it at row "
            f"{index_start} with sizes {ds}")

  def _rows(layout: _Layout):
    """``(shards or None, first row, last row)`` of this rank's rows."""
    shards = mesh_lib.shard_group(statistics_partition_spec)
    if shards is None:
      return None, 0, layout.padded_n
    if layout.padded_n % shards.size:
      raise ValueError(
          f"{layout.padded_n} statistics do not split over {shards.size} "
          "ranks; set num_devices_for_pjit to a multiple of the shard count")
    per = layout.padded_n // shards.size
    return shards, shards.index * per, (shards.index + 1) * per

  def sharded_init_fn(params) -> shampoo.ShampooState:
    """This rank's state: its rows of the global arrays, ``eps I`` and
    ``I`` padded with an identity block (a padding slot is ``I`` in both),
    and the replicated local stats."""
    layout = _layout(params)
    _, lo, hi = _rows(layout)
    device = next(iter(params.values())).device
    m = layout.max_size
    sizes = torch.tensor(layout.sizes[lo:hi], dtype=torch.int32,
                         device=device)
    in_block = (torch.arange(m, dtype=torch.int32, device=device)[None, :]
                < sizes[:, None])
    diag = torch.where(in_block, matrix_epsilon, 1.0).to(torch.float32)
    eye = torch.eye(m, dtype=torch.float32, device=device)
    global_stats = GlobalShardedParameterStats(
        torch.diag_embed(diag), eye.expand(hi - lo, m, m).clone(),
        torch.tensor(layout.exponents, dtype=torch.int32, device=device))
    local = {}
    for name, param in params.items():
      index_start, ds = layout.slots[name]
      local[name] = LocalShardedParameterStats(
          torch.zeros_like(param) if graft_has_diag_stats else None,
          torch.zeros_like(param), torch.zeros_like(param),
          (RootMetrics.zeros(len(ds), device=device)
           if generate_training_metrics else None),
          index_start, ds)
    return shampoo.ShampooState(
        count=0, stats=ShardedShampooStats(global_stats, local))

  def sharded_init_partition_spec_fn(params, params_partition_spec=None,
                                     partition_spec_for_statistics=None):
    """`parallel.mesh.Sharding`s in the structure of `sharded_init_fn`'s
    state: a parameter's own for its local stats (replicated by default),
    the statistics spec for the global arrays."""
    stat_spec = (partition_spec_for_statistics
                 or statistics_partition_spec)
    repl = mesh_lib.replicated(getattr(stat_spec, "mesh", None))
    if params_partition_spec is None:
      params_partition_spec = {name: repl for name in params}
    layout = _layout(params)
    local = {}
    for name in params:
      spec = params_partition_spec[name]
      index_start, ds = layout.slots[name]
      local[name] = LocalShardedParameterStats(
          spec if graft_has_diag_stats else None, spec, spec,
          (RootMetrics(repl, repl, repl, repl, repl)
           if generate_training_metrics else None),
          index_start, ds)
    global_spec = GlobalShardedParameterStats(stat_spec or repl,
                                              stat_spec or repl, repl)
    return shampoo.ShampooState(
        count=repl, stats=ShardedShampooStats(global_spec, local))

  def sharded_init_shape_and_dtype_fn(params):
    """``[shape, dtype]`` in the structure of `sharded_init_fn`'s state,
    with the global arrays' global shapes."""
    layout = _layout(params)
    local = {}
    for name, param in params.items():
      index_start, ds = layout.slots[name]
      shape_dtype = [list(param.shape), param.dtype]
      metrics = None
      if generate_training_metrics and ds:
        metrics = RootMetrics(*[[[len(ds)], torch.float32]] * 5)
      local[name] = LocalShardedParameterStats(
          shape_dtype if graft_has_diag_stats else None, shape_dtype,
          shape_dtype, metrics, index_start, ds)
    m = layout.max_size
    global_shapes = GlobalShardedParameterStats(
        [[layout.padded_n, m, m], torch.float32],
        [[layout.padded_n, m, m], torch.float32],
        [[layout.padded_n], torch.int32])
    return shampoo.ShampooState(
        count=[[], torch.int32],
        stats=ShardedShampooStats(global_shapes, local))

  def _roots_for_transform(pre, full, index_start, ds):
    """A parameter's roots as views of the gathered ``full`` array:
    per-axis ``[nb, d, d]`` stacks for uniform blocks, else one ``[d, d]``
    entry per statistic."""
    if pre.stacked_layout():
      shapes = pre.stacked_shapes()
      nb = shapes[0][0]
      rows = full[index_start:index_start + nb * len(shapes)].view(
          (nb, len(shapes)) + tuple(full.shape[1:]))
      return [rows[:, j, :d, :d] for j, (_, d, _) in enumerate(shapes)]
    return [full[index_start + i, :d, :d] for i, d in enumerate(ds)]

  def _transform(grads, params, local_stats, layout, full, step):
    """Every parameter's update and new local stats, its roots read from
    ``full``, the gathered roots."""
    updates, new_local = {}, {}
    for name, param in params.items():
      local = local_stats[name]
      index_start, ds = layout.slots[name]
      roots = []
      if ds:
        roots = _roots_for_transform(layout.pres[name], full, index_start, ds)
      view = shampoo.ParameterStats(
          local.diagonal_statistics, [], roots, local.diagonal_momentum,
          local.momentum, None, local.training_metrics)
      updates[name], view = transform_grad(grads[name], view, param, step)
      new_local[name] = dataclasses.replace(
          local, diagonal_statistics=view.diagonal_statistics,
          diagonal_momentum=view.diagonal_momentum, momentum=view.momentum)
    return updates, new_local

  @torch.no_grad()
  def sharded_update_fn(grads, state: shampoo.ShampooState, params):
    pth_root.require_true_f32()
    step = state.count
    global_stats, local_stats = state.stats
    layout = _layout(params)
    shards, lo, hi = _rows(layout)
    _check_state(layout, global_stats, local_stats, hi - lo)

    # 1) Transform with the roots from step entry, gathered.  The gathered
    # array dies here: no view of it outlives `_transform`.
    with record_function("ShampooPrecondition"):
      full = global_stats.preconditioners
      if shards is not None and layout.n:
        full = mesh_lib.all_gather_rows(full, shards)
      updates, new_local = _transform(grads, params, local_stats, layout,
                                      full, step)
      del full

    if layout.n == 0:
      return updates, shampoo.ShampooState(
          step + 1, ShardedShampooStats(global_stats, new_local))

    # 2) The statistics of this rank's rows.
    statistics = global_stats.statistics
    if step % statistics_compute_steps == 0:
      with record_function("ShampooStatistics"):
        statistics = statistics.clone()
        for name, (index_start, ds) in layout.slots.items():
          first, last = max(lo - index_start, 0), min(hi - index_start,
                                                      len(ds))
          if first >= last:
            continue
          for _, axis, indices, blocks in layout.pres[name].block_groups(
              grads[name], first, last):
            grams = shampoo.block_grams(blocks, axis)
            rows = torch.tensor(indices, device=statistics.device) + (
                index_start - lo)
            d = grams.shape[-1]
            statistics[rows, :d, :d] = (beta2 * statistics[rows, :d, :d]
                                        + w2 * grams)

    if step % preconditioning_compute_steps != 0:
      return updates, shampoo.ShampooState(step + 1, ShardedShampooStats(
          dataclasses.replace(global_stats, statistics=statistics),
          new_local))

    # 3) Solve this rank's rows, a static exponent per group; 4) gate each
    # group into the new preconditioners.  The groups cover every row.
    with record_function("ShampooRootSolve"):
      pads = torch.tensor(layout.sizes[lo:hi], dtype=torch.int32,
                          device=statistics.device)
      old = global_stats.preconditioners
      preconditioners = torch.empty_like(old)
      metric_parts = []
      for exp, start, count in layout.groups:
        a, b = max(start, lo) - lo, min(start + count, hi) - lo
        if a >= b:
          continue
        roots, met = solve_batched(statistics[a:b], exp, pads[a:b],
                                   old[a:b] if reuse_preconditioner else None)
        failed = torch.isnan(met.error) | (
            met.error >= inverse_failure_threshold)
        torch.where(failed[:, None, None], old[a:b], roots,
                    out=preconditioners[a:b])
        metric_parts.append(met)
        del roots
      metrics = RootMetrics.cat(metric_parts)

    # 5) Every slot's metrics into the parameters' local stats.
    if generate_training_metrics:
      if shards is not None:
        metrics = shampoo._all_gather_metrics(metrics, shards)
      for name, local in new_local.items():
        index_start, ds = layout.slots[name]
        if ds:
          a, b = index_start, index_start + len(ds)
          new_local[name] = dataclasses.replace(
              local, training_metrics=RootMetrics(
                  metrics.error[a:b], metrics.iterations[a:b],
                  metrics.error_ratio[a:b], metrics.max_eigenvalue[a:b],
                  metrics.retries[a:b]))
    new_global = GlobalShardedParameterStats(statistics, preconditioners,
                                             global_stats.exponents)
    return updates, shampoo.ShampooState(
        step + 1, ShardedShampooStats(new_global, new_local))

  def init_fn_state(_):
    return InitFnState(
        init_fn=sharded_init_fn,
        pspec_fn=sharded_init_partition_spec_fn,
        shape_and_dtype_fn=sharded_init_shape_and_dtype_fn)

  return init_fn_state, sharded_update_fn


def _fields(x) -> dict:
  """A dataclass's fields, not copied (`dataclasses.asdict` deep-copies)."""
  return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def state_to_tree(state: shampoo.ShampooState) -> dict:
  """The sharded state as nested dicts of tensors and plain values (this
  rank's rows of the global arrays), the form `torch.save` keeps."""
  g, local = state.stats
  return {"count": state.count, "sharded": True, "global": _fields(g),
          "local": {name: dict(_fields(ls), training_metrics=(
              None if ls.training_metrics is None
              else _fields(ls.training_metrics)))
                    for name, ls in local.items()}}


def state_from_tree(tree: dict, device=None) -> shampoo.ShampooState:
  """Inverse of `state_to_tree`; tensors move to ``device`` when given."""
  move = lambda t: t if t is None or device is None else t.to(device)
  local = {}
  for name, ls in tree["local"].items():
    m = ls["training_metrics"]
    local[name] = LocalShardedParameterStats(
        move(ls["diagonal_statistics"]), move(ls["diagonal_momentum"]),
        move(ls["momentum"]),
        None if m is None else RootMetrics(**{k: move(v)
                                             for k, v in m.items()}),
        int(ls["index_start"]), list(ls["sizes"]))
  return shampoo.ShampooState(int(tree["count"]), ShardedShampooStats(
      GlobalShardedParameterStats(**{k: move(v)
                                     for k, v in tree["global"].items()}),
      local))
