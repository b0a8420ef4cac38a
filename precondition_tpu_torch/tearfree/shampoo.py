"""Blocked Shampoo with per-tensor stacked statistics (tearfree variant).

PyTorch counterpart of `precondition_tpu/tearfree/shampoo.py`.  Each
tensor's blocks are stacked: per axis, one ``[N, B, B]`` statistic and one
root over all ``N`` blocks.  The statistics are one batched Gram product
per axis, the roots one batched solve per axis, and the preconditioning
one einsum over all axes.

Root backends (``solver_backend``):

* ``"eigh"``: eigendecomposition with eigenvalues at most ``1e-6 *
  lambda_max`` treated as zero (a pseudo-inverse root on rank-deficient
  statistics);
* ``"newton"``: the coupled-Newton ridge root ``(A + 1e-6 lambda_max
  I)^{-1/p}`` of `ops/kernels/newton_root.py`, the CUDA kernel for a CUDA
  tensor and its plain twin on the CPU, with lambda_max from a batched
  power iteration that exits at 1% relative change (`_batched_max_evs`);
* ``"filtered"``: that ridge root between two smooth spectral projectors
  onto the eigenvalues above ``1e-6 * lambda_max``
  (`pth_root.batched_spectral_projector`), which zero-clips as eigh does
  without an eigendecomposition;
* ``"auto"``: ``"filtered"`` for CUDA tensors, ``"eigh"`` elsewhere.

``newton`` and ``filtered`` follow the JAX package's accelerator branch,
its Pallas kernel with explicit lambda_max, for every block size up to the
kernel's `newton_root.MAX_M`; larger blocks take
`pth_root.batched_inverse_pth_root`.  On a CUDA tensor nothing falls back:
a kernel that fails to build or launch raises.

Constraints, checked at init: no unit dimensions, at most two dimensions
>= block_size, large dimensions divisible by the block size.  The
`reshaper` upstream guarantees them for any parameter shape.  Frequency
gates are host ``if``s on the Python-int step count.
"""

from __future__ import annotations

import dataclasses
import math
import string
from typing import Dict, List, Sequence

import torch
from torch.profiler import record_function

from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.kernels import newton_root
from precondition_tpu_torch.optim.shampoo import GradientTransformation

# Eigenvalues at most this fraction of lambda_max are zero to the eigh and
# filtered backends (the Newton roots' ridge, the kernel's default
# ridge_epsilon, is the same fraction).
_EPS = 1e-6


@dataclasses.dataclass
class Options:
  """Blocked-Shampoo options.

  Attributes:
    block_size: block edge for the block-diagonal covariance approximation.
    update_preconditioners_freq: steps between inverse-root refreshes.
    update_statistics_freq: steps between statistics updates.
    second_moment_decay: EMA decay for statistics (1.0 = running sum).
    solver_backend: "eigh", "newton", "filtered" or "auto" (see the module
      docstring).
  """

  block_size: int = 1024
  update_preconditioners_freq: int = 1
  update_statistics_freq: int = 1
  second_moment_decay: float = 0.999
  solver_backend: str = "auto"


def _validate(options: Options) -> None:
  if options.block_size <= 1:
    raise ValueError(f"block_size ({options.block_size}) must be >1")
  if options.update_preconditioners_freq <= 0:
    raise ValueError(
        f"update_preconditioners_freq "
        f"({options.update_preconditioners_freq}) must be positive")
  if options.update_statistics_freq <= 0:
    raise ValueError(
        f"update_statistics_freq ({options.update_statistics_freq}) "
        "must be positive")
  if not 0 <= options.second_moment_decay <= 1:
    raise ValueError(
        f"second_moment_decay ({options.second_moment_decay}) "
        "should be in [0, 1]")
  if options.solver_backend not in ("eigh", "newton", "filtered", "auto"):
    raise ValueError(
        f"solver_backend ({options.solver_backend!r}) must be one of "
        "'eigh', 'newton', 'filtered', 'auto'")


@dataclasses.dataclass
class AxesBlocks:
  """Stacked per-axis factors of one tensor: ``stats[i]`` and
  ``roots[i]`` are ``[N, B_i, B_i]``, N the number of blocks and ``B_i =
  min(dim_i, block_size)``."""
  stats: List[torch.Tensor]
  roots: List[torch.Tensor]


@dataclasses.dataclass
class ShampooState:
  count: int
  blocks: Dict[str, AxesBlocks]


@dataclasses.dataclass(frozen=True)
class _BlocksMeta:
  """Static blocking facts for one tensor shape."""
  block_sizes: List[int]        # per-axis B_i
  num_blocks: int               # N
  param_shape: List[int]
  large_axes: List[int]         # axes with dim >= block_size
  blocks_per_large_axis: List[int]
  blocks_axis: int              # where N sits in the blocked layout
  large_block_size: int


def _blocks_meta(options: Options, shape: Sequence[int]) -> _BlocksMeta:
  bs = options.block_size
  large_axes = [i for i, d in enumerate(shape) if d >= bs]
  blocks_per = [shape[i] // bs for i in large_axes]
  return _BlocksMeta(
      block_sizes=[min(d, bs) for d in shape],
      num_blocks=math.prod(blocks_per) if blocks_per else 1,
      param_shape=list(shape),
      large_axes=large_axes,
      blocks_per_large_axis=blocks_per,
      blocks_axis=min(large_axes, default=0),
      large_block_size=bs)


def _check_shape(name, shape, options: Options):
  if any(d == 1 for d in shape):
    raise ValueError(f"param {name} shape ({shape}) has unit dimensions")
  if sum(d >= options.block_size for d in shape) > 2:
    raise ValueError(
        f"param {name} shape ({shape}) has >2 large dims for block size "
        f"{options.block_size}")
  if any(d % options.block_size != 0 for d in shape
         if d >= options.block_size):
    raise ValueError(
        f"param {name} shape ({shape}) has large dims indivisible by "
        f"block size {options.block_size}")


def _blockify(x: torch.Tensor, meta: _BlocksMeta) -> torch.Tensor:
  """All blocks folded into one ``N`` axis at ``meta.blocks_axis``.

  Every original axis keeps its place (large axes now of length
  ``block_size``).  With two large axes ``a < b`` the per-axis block counts
  are flattened row-major into ``N``.
  """
  if list(x.shape) != meta.param_shape:
    raise ValueError(f"shape {list(x.shape)}, expected {meta.param_shape}")
  if not meta.large_axes:
    return x.unsqueeze(meta.blocks_axis)
  bs = meta.large_block_size
  if len(meta.large_axes) == 1:
    a = meta.large_axes[0]
    n = meta.blocks_per_large_axis[0]
    return x.reshape(list(x.shape[:a]) + [n, bs] + list(x.shape[a + 1:]))
  a, b = meta.large_axes
  na, nb = meta.blocks_per_large_axis
  shape = (list(x.shape[:a]) + [na, bs] + list(x.shape[a + 1:b])
           + [nb, bs] + list(x.shape[b + 1:]))
  x = x.reshape(shape)
  # Move nb (at index b+1 after the insertion of na) to sit after na.
  perm = list(range(len(shape)))
  perm.pop(b + 1)
  perm.insert(a + 1, b + 1)
  x = x.permute(perm)
  merged = (list(x.shape[:a]) + [na * nb, bs]
            + list(x.shape[a + 3:b + 2]) + [bs] + list(x.shape[b + 3:]))
  return x.reshape(merged)


def _deblockify(x: torch.Tensor, meta: _BlocksMeta) -> torch.Tensor:
  """Invert `_blockify`."""
  if not meta.large_axes:
    return x.squeeze(meta.blocks_axis)
  if len(meta.large_axes) == 1:
    return x.reshape(meta.param_shape)
  a, b = meta.large_axes
  na, nb = meta.blocks_per_large_axis
  shape = list(x.shape)
  split = shape[:a] + [na, nb] + shape[a + 1:]
  x = x.reshape(split)
  # Move nb back in front of its block axis (which now sits at b+2).
  perm = list(range(len(split)))
  perm.pop(a + 1)
  perm.insert(b + 1, a + 1)
  return x.permute(perm).reshape(meta.param_shape)


def _ema(old, new, decay):
  if decay == 1.0:
    return old + new
  return old * decay + new * (1 - decay)


def _update_block_stats(decay, blocked, block: AxesBlocks,
                        meta: _BlocksMeta) -> AxesBlocks:
  """One batched Gram product over the blocks for every tensor axis."""
  x = blocked.movedim(meta.blocks_axis, 0)
  new_stats = []
  for axis, cov in enumerate(block.stats):
    flat = x.movedim(axis + 1, 1).reshape(x.shape[0], x.shape[axis + 1], -1)
    new_stats.append(_ema(cov, torch.bmm(flat, flat.transpose(1, 2)), decay))
  return AxesBlocks(stats=new_stats, roots=block.roots)


def _pth_inv_root(p: int, cov: torch.Tensor) -> torch.Tensor:
  """Batched eigh ``cov^{-1/p}`` with relative eigenvalue clipping."""
  # JAX's eigh symmetrizes its operand; torch's reads one triangle.
  w, v = pth_root.nan_safe(torch.linalg.eigh,
                           0.5 * (cov + cov.transpose(1, 2)))
  # Eigenvalues below eps * lambda_max are treated as exactly zero (the
  # covariance is rank-deficient early in training).
  mask = w <= _EPS * w.amax(dim=-1, keepdim=True)
  half = torch.where(mask, 1.0, w) ** (-0.5 / p)
  half = torch.where(mask, 0.0, half)
  half_v = v * half[:, None, :]
  return torch.bmm(half_v, half_v.transpose(1, 2))


def _batched_max_evs(cov: torch.Tensor, pads: torch.Tensor) -> torch.Tensor:
  """Batched top eigenvalues, loose 1% relative exit, ``relative_floor=0``.

  The kernel wrapper's own power iteration keeps the ridge paths' floor
  of 1: on early-training covariances with lambda_max << 1 it exits after
  one step with a gross underestimate, harmless for a ridge and fatal for
  the filtered backend's clip threshold.
  """
  return pth_root.power_iteration(
      cov, padding_starts=pads, error_tolerance=1e-2,
      relative_tolerance=True, relative_floor=0.0)[1]


def _batched_ridge_root(p: int, cov: torch.Tensor, pads: torch.Tensor,
                        max_evs: torch.Tensor) -> torch.Tensor:
  """Batched ``(cov + 1e-6 max_evs I)^{-1/p}``: the Newton-root kernel (or
  its twin on the CPU), or the per-matrix solver above its size limit."""
  if cov.shape[-1] > newton_root.MAX_M:
    return pth_root.batched_inverse_pth_root(cov, p, pads)[0]
  return newton_root.batched_inverse_pth_root(cov, p, pads,
                                              max_evs=max_evs)[0]


def _newton_inv_root(p: int, cov: torch.Tensor) -> torch.Tensor:
  """Batched coupled-Newton ``cov^{-1/p}`` (ridge semantics)."""
  n, d = cov.shape[0], cov.shape[-1]
  pads = torch.full((n,), d, dtype=torch.int32, device=cov.device)
  return _batched_ridge_root(p, cov, pads, _batched_max_evs(cov, pads))


def _filtered_inv_root(p: int, cov: torch.Tensor) -> torch.Tensor:
  """eigh's null-space semantics from the Newton root.

  ``P R P``: ``R ~= (A + eps lambda_max I)^{-1/p}`` from the Newton
  kernel, ``P ~= 1{eig(A) > eps lambda_max}`` from the matmul-only sign
  iteration.  Both are (limits of) polynomials in A, so they commute, and
  the product drops exactly the directions eigh drops while kept
  directions keep the Newton root's value.
  """
  n, d = cov.shape[0], cov.shape[-1]
  pads = torch.full((n,), d, dtype=torch.int32, device=cov.device)
  max_evs = _batched_max_evs(cov, pads)
  roots = _batched_ridge_root(p, cov, pads, max_evs)
  proj = pth_root.batched_spectral_projector(cov, _EPS * max_evs)
  out = torch.bmm(torch.bmm(proj, roots.to(proj.dtype)), proj)
  out = 0.5 * (out + out.transpose(1, 2))
  # A zero covariance (step-0 state) has lambda_max == 0: eigh masks every
  # direction and returns 0; match that rather than P R P's (huge ridge
  # root) x (half projector).
  return out * (max_evs > 0.0)[:, None, None]


_SOLVER_FNS = {
    "eigh": _pth_inv_root,
    "newton": _newton_inv_root,
    "filtered": _filtered_inv_root,
}


def resolve_solver(solver: str, device: torch.device) -> str:
  """``"auto"`` by the statistics' device: the filtered backend for CUDA
  tensors (the Newton kernel and batched matmuls), eigh elsewhere."""
  if solver == "auto":
    return "filtered" if torch.device(device).type == "cuda" else "eigh"
  return solver


def _update_block_precond(block: AxesBlocks, meta: _BlocksMeta,
                          solver: str) -> AxesBlocks:
  p = len(meta.param_shape) * 2
  roots = [_SOLVER_FNS[resolve_solver(solver, s.device)](p, s)
           for s in block.stats]
  return AxesBlocks(stats=block.stats, roots=roots)


def _precondition_blocks(blocked, block: AxesBlocks,
                         meta: _BlocksMeta) -> torch.Tensor:
  """One einsum applying every axis root to the blocked gradient."""
  letters = iter(string.ascii_letters)
  n = next(letters)
  contract = [next(letters) for _ in meta.param_shape]
  out = [next(letters) for _ in meta.param_shape]
  in_sub = contract[:]
  in_sub.insert(meta.blocks_axis, n)
  out_sub = out[:]
  out_sub.insert(meta.blocks_axis, n)
  root_subs = [n + o + c for c, o in zip(contract, out)]
  formula = ",".join(["".join(in_sub)] + root_subs) + "->" + "".join(out_sub)
  return torch.einsum(formula, blocked, *block.roots)


def apply(options: Options) -> GradientTransformation:
  """Blocked-Shampoo gradient transformation."""
  _validate(options)

  def init_fn(params) -> ShampooState:
    blocks = {}
    for name, param in params.items():
      _check_shape(name, list(param.shape), options)
      meta = _blocks_meta(options, param.shape)
      n, dev = meta.num_blocks, param.device
      blocks[name] = AxesBlocks(
          stats=[torch.zeros((n, d, d), dtype=torch.float32, device=dev)
                 for d in meta.block_sizes],
          roots=[torch.eye(d, dtype=torch.float32, device=dev).expand(
              n, d, d).clone() for d in meta.block_sizes])
    return ShampooState(count=0, blocks=blocks)

  def update_fn(updates, state: ShampooState, params=None):
    del params
    count = state.count
    blocks = dict(state.blocks)
    out = {}
    # The profiler scopes carry the JAX package's named-scope names.
    for name, update in updates.items():
      meta = _blocks_meta(options, update.shape)
      blocked = _blockify(update, meta)
      block = blocks[name]
      if count % options.update_statistics_freq == 0:
        with record_function("ShampooStats"):
          block = _update_block_stats(options.second_moment_decay, blocked,
                                      block, meta)
      if count % options.update_preconditioners_freq == 0:
        with record_function("PthInvRoot"):
          block = _update_block_precond(block, meta, options.solver_backend)
      blocks[name] = block
      with record_function("PreconditionShampoo"):
        out[name] = _deblockify(_precondition_blocks(blocked, block, meta),
                                meta)
    return out, ShampooState(count=count + 1, blocks=blocks)

  return GradientTransformation(init_fn, update_fn)
