"""Device meshes, shardings and the rank groups that split a solve.

Port of `precondition_tpu/parallel/mesh.py`.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over every rank of the job with
named axes, by default:
  * ``data``  - data parallelism (every rank);
  * ``model`` - tensor parallelism (1).
`sharding(mesh, *spec)` is the counterpart of `NamedSharding(mesh,
P(*spec))`: a `Sharding` holding the mesh and the spec, one entry per array
axis (an axis name, a tuple of names, or None).  The optimizer splits a
stacked ``[N, m, m]`` root solve over the group of a spec's leading axes
(`shard_group`): rank ``r`` of that group solves rows ``[r N/k, (r+1) N/k)``
and one all-gather (`all_gather_rows`) returns every root to every rank,
as JAX's ``shard_map`` does.  A `Sharding` without a mesh is a bare spec,
which splits nothing.

`shard_params` applies rules of parameter names (regex -> spec, the
model's `TP_RULES`) and places every parameter whole on each rank: the
port shards batches, not parameters.  A rule that would split a parameter
over a mesh axis larger than 1 (tensor parallelism) raises
`NotImplementedError` (ROADMAP.md queue 1, item 13b).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "model"),
              device_type: str = "cuda") -> DeviceMesh:
  """A mesh over every rank of the default process group.

  Without a shape every rank lies on the first axis (``data``) and the
  others have size 1.  The shape must cover the group's ranks.  The
  default process group must be initialized first
  (`torch.distributed.init_process_group`); ``device_type="cpu"`` builds a
  mesh of CPU ranks (gloo).
  """
  if not dist.is_initialized():
    raise RuntimeError("make_mesh needs torch.distributed.init_process_group "
                       "first")
  if device_type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("make_mesh: no CUDA device; pass device_type='cpu' for "
                       "a mesh of CPU ranks")
  world = dist.get_world_size()
  if shape is None:
    shape = (world,) + (1,) * (len(axis_names) - 1)
  shape = tuple(int(s) for s in shape)
  if len(shape) != len(axis_names):
    raise ValueError(f"mesh shape {shape} and axis names {tuple(axis_names)} "
                     "differ in length")
  if math.prod(shape) != world:
    raise ValueError(f"Mesh shape {shape} does not cover {world} ranks")
  return init_device_mesh(device_type, shape,
                          mesh_dim_names=tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class ShardGroup:
  """The ranks that split a batch: shard ``j`` of ``size`` is held by group
  rank ``order[j]``; this rank holds shard ``index``."""
  group: Optional[dist.ProcessGroup]  # None: the default group
  size: int
  index: int
  order: Tuple[int, ...]


@dataclasses.dataclass(eq=False)
class Sharding:
  """``NamedSharding(mesh, P(*spec))``; ``mesh=None`` for a bare spec."""
  mesh: Optional[DeviceMesh]
  spec: Tuple = ()
  # The group of the spec's leading axes, made by the first `shard_group`.
  _group: Optional[ShardGroup] = dataclasses.field(default=None, init=False,
                                                    repr=False)


def sharding(mesh: DeviceMesh, *spec) -> Sharding:
  return Sharding(mesh, tuple(spec))


def replicated(mesh: DeviceMesh) -> Sharding:
  return Sharding(mesh, ())


def leading_axes(spec: Sharding) -> Tuple[str, ...]:
  """The mesh axes that split an array's first dimension under ``spec``."""
  lead = spec.spec[0] if len(spec.spec) else None
  return (lead,) if isinstance(lead, str) else tuple(lead or ())


def shard_count(spec) -> Optional[int]:
  """How many shards ``spec`` splits a batch into: the product of its
  leading axes' sizes, or None for anything but a `Sharding` with a mesh
  and a spec (JAX's `_solver_count_from_spec`)."""
  if not isinstance(spec, Sharding) or spec.mesh is None or not spec.spec:
    return None
  names = spec.mesh.mesh_dim_names
  return math.prod(spec.mesh.size(names.index(a)) for a in leading_axes(spec))


def process_group_shards(group: Optional[dist.ProcessGroup]) -> ShardGroup:
  """Every rank of ``group`` (None: the default group) holds one shard, in
  group rank order."""
  size = dist.get_world_size(group)
  return ShardGroup(group, size, dist.get_rank(group), tuple(range(size)))


def shard_group(spec) -> Optional[ShardGroup]:
  """The group that splits a batch under ``spec``, or None where nothing is
  split: no mesh, no leading axis, or leading axes of size 1.

  Shards follow JAX's order, the leading axes' coordinates in the order the
  spec names them.  The first call on a spec with two or more axes larger
  than 1 creates one process group per slice of the mesh, on every rank
  (`torch.distributed.new_subgroups_by_enumeration`), so every rank must
  make it at the same point.
  """
  if (shard_count(spec) or 1) == 1:
    return None
  if spec._group is not None:
    return spec._group
  mesh = spec.mesh
  names = mesh.mesh_dim_names
  dims = [names.index(a) for a in leading_axes(spec)
          if mesh.size(names.index(a)) > 1]
  size = math.prod(mesh.size(d) for d in dims)
  others = [d for d in range(mesh.ndim) if d not in dims]
  rows = mesh.mesh.permute(others + dims).reshape(-1, size).tolist()
  me = dist.get_rank()
  mine = [row for row in rows if me in row]
  if not mine:
    raise ValueError(f"rank {me} is not in the mesh {mesh}")
  if len(dims) == 1:
    group = mesh.get_group(dims[0])
  else:
    group, _ = dist.new_subgroups_by_enumeration(rows)
  spec._group = ShardGroup(
      group, size, mine[0].index(me),
      tuple(dist.get_group_rank(group, r) for r in mine[0]))
  return spec._group


def all_gather_rows(x: torch.Tensor, shards: ShardGroup) -> torch.Tensor:
  """Concatenates every shard's ``x`` along dim 0 in shard order, where
  ``x`` is this rank's shard; one collective on ``shards.group``."""
  x = x.contiguous()
  out = x.new_empty((shards.size * x.shape[0],) + tuple(x.shape[1:]))
  dist.all_gather_into_tensor(out, x, group=shards.group)
  if shards.order != tuple(range(shards.size)):
    out = out.view((shards.size,) + tuple(x.shape))[list(shards.order)]
    out = out.flatten(0, 1)
  return out


def param_spec(name: str, rules) -> Tuple:
  """The spec of the first rule whose regex matches ``name`` (searched
  anywhere in it); ``()``, replicated, where none does."""
  for pattern, spec in rules:
    if re.search(pattern, name):
      return tuple(spec)
  return ()


def shard_params(params, mesh: DeviceMesh, rules):
  """Places a flat param dict by ``rules`` (name regex -> spec) over
  ``mesh``: each param whole on this rank's device.  Raises
  `NotImplementedError` where a rule names a mesh axis larger than 1."""
  names = mesh.mesh_dim_names
  for name in params:
    for entry in param_spec(name, rules):
      for axis in (entry,) if isinstance(entry, str) else entry or ():
        if mesh.size(names.index(axis)) > 1:
          raise NotImplementedError(
              f"tensor-parallel sharding of parameters ({name!r} over mesh "
              f"axis {axis!r} of size {mesh.size(names.index(axis))}) is "
              "not ported to PyTorch yet; see ROADMAP.md queue 1, item 13b")
  device = torch.device(mesh.device_type)
  return {name: p if p.device.type == device.type else p.to(device)
          for name, p in params.items()}
