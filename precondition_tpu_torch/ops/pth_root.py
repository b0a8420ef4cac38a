"""Inverse p-th root helpers on the optimizer's main path.

PyTorch counterpart of the main-path subset of
`precondition_tpu/ops/pth_root.py`: the solver's metrics record, the
padding mask, the static-exponent matrix power and a batched power
iteration.  The coupled-Newton solve itself lives in
`ops/kernels/newton_root.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_EPSILON = 1e-25
# Seed of the power iteration's start vector.  The JAX package draws it
# from `jax.random.PRNGKey(1729)`; torch cannot reproduce those bits, so
# callers that need JAX's exact vector pass it as ``v0``.
_V0_SEED = 1729


@dataclasses.dataclass
class RootMetrics:
  """Diagnostics of one batch of inverse-pth-root solves (``[N]`` each).

  The fields of the JAX package's `RootMetrics`: max entrywise error of
  ``M_k - I``, Newton iterations, final error ratio, the top eigenvalue
  that scaled the ridge, and how many ridge rounds ran.
  """

  error: torch.Tensor
  iterations: torch.Tensor
  error_ratio: torch.Tensor
  max_eigenvalue: torch.Tensor
  retries: torch.Tensor

  def map(self, fn) -> "RootMetrics":
    """Apply ``fn`` to every field."""
    return RootMetrics(**{f.name: fn(getattr(self, f.name))
                          for f in dataclasses.fields(self)})

  @staticmethod
  def cat(parts) -> "RootMetrics":
    return RootMetrics(**{
        f.name: torch.cat([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(RootMetrics)})


def require_true_f32() -> None:
  """Switches TF32 off for CUDA matmuls and checks that it stayed off.

  The coupled Newton iteration needs true f32 products: TF32 keeps about
  three decimal digits, and a solver run on it reports converged residuals
  while it emits wrong roots (the JAX package's DESIGN.md, "Retired:
  mixed-precision ladder").
  """
  torch.backends.cuda.matmul.allow_tf32 = False
  if torch.backends.cuda.matmul.allow_tf32:
    raise RuntimeError("TF32 matmuls could not be switched off")


def _padding_mask(n: int, padding_start, dtype, device=None) -> torch.Tensor:
  """Mask over the last axis: 1 for indices < padding_start, 0 after.

  ``padding_start`` may be an int or an ``[N]`` tensor (one mask row per
  member).
  """
  idx = torch.arange(n, dtype=torch.int32, device=device)
  if isinstance(padding_start, torch.Tensor):
    return (idx[None, :] < padding_start[:, None].to(idx.device)).to(dtype)
  return (idx < padding_start).to(dtype)


def mat_power(m: torch.Tensor, p: int) -> torch.Tensor:
  """``m**p`` for a static int ``p`` by square-and-multiply.

  Works on a single matrix or a batch; the product order matches the JAX
  package's static path.
  """
  if p <= 0:
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    return eye.expand(m.shape).clone()
  result = None
  square = m
  bits = p
  while bits:
    if bits & 1:
      result = square if result is None else torch.matmul(result, square)
    bits >>= 1
    if bits:
      square = torch.matmul(square, square)
  return result


def default_v0(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
  """The power iteration's deterministic start vector, uniform in [-1, 1)."""
  gen = torch.Generator(device="cpu").manual_seed(_V0_SEED)
  v0 = torch.rand(n, generator=gen, dtype=torch.float32) * 2.0 - 1.0
  return v0.to(dtype=dtype, device=device)


def power_iteration(
    matrices: torch.Tensor,
    num_iters: int = 100,
    error_tolerance: float = 1e-6,
    padding_starts: Optional[torch.Tensor] = None,
    v0: Optional[torch.Tensor] = None,
    relative_tolerance: bool = False,
    relative_floor: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Top eigenpairs of a batch ``[N, m, m]`` of symmetric PSD matrices.

  Each member runs its own loop, exactly as the JAX package's
  `power_iteration` under `vmap`: it stops when its Rayleigh quotient
  moves by no more than ``error_tolerance`` (times ``max(|ev|,
  relative_floor)`` when ``relative_tolerance``) or after ``num_iters``
  steps.  The start vector ``v0`` (``[m]`` or ``[N, m]``; `default_v0`
  when omitted) is zeroed beyond each member's ``padding_starts``.

  Returns:
    ``(eigenvectors [N, m], eigenvalues [N])``.
  """
  n, m, _ = matrices.shape
  dtype, device = matrices.dtype, matrices.device
  if v0 is None:
    v0 = default_v0(m, dtype, device)
  v = v0.to(dtype=dtype, device=device).expand(n, m).clone()
  if padding_starts is not None:
    v = v * _padding_mask(m, padding_starts, dtype, device)
  ev = torch.zeros(n, dtype=dtype, device=device)
  active = torch.ones(n, dtype=torch.bool, device=device)
  # One host sync per step for the loop exit, as the vmapped while-loop
  # evaluates its batched predicate once per step.
  for _ in range(num_iters):
    if not bool(active.any()):
      break
    vn = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                         min=_EPSILON)
    mv = torch.bmm(matrices, vn[:, :, None])[:, :, 0]
    ev_new = (vn * mv).sum(dim=1)
    if relative_tolerance:
      scale = torch.clamp(ev_new.abs(), min=relative_floor)
      not_done = (ev_new - ev).abs() > error_tolerance * scale
    else:
      not_done = (ev_new - ev).abs() > error_tolerance
    v = torch.where(active[:, None], mv, v)
    ev = torch.where(active, ev_new, ev)
    active = active & not_done
  v = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                      min=_EPSILON)
  return v, ev
