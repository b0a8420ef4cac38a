"""Per-preconditioner diagnostics of the inverse-root solve.

PyTorch counterpart of `InversePthRootDiagnostics` in
`precondition_tpu/utils/diagnostics.py`, batched: one call reports on a
whole ``[N, m, m]`` batch of roots, each field ``[N]``.  The LOBPCG and
frequent-directions reports come with the solvers that produce them.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class InversePthRootDiagnostics:
  """Entrywise residual of ``B^p A - I`` for each computed root ``B``."""

  max_diag_error: torch.Tensor
  avg_diag_error: torch.Tensor
  max_off_diag_error: torch.Tensor
  avg_off_diag_error: torch.Tensor
  p: torch.Tensor

  @classmethod
  def zeros(cls, n: int, device=None) -> "InversePthRootDiagnostics":
    return cls(*torch.zeros((5, n), dtype=torch.float32, device=device))

  @classmethod
  def create(cls, roots: torch.Tensor, matrices: torch.Tensor, p: int,
             padding_starts=None) -> "InversePthRootDiagnostics":
    """Diagnostics of ``roots [N, m, m]`` against ``matrices [N, m, m]``.

    Rows and columns at and beyond a member's ``padding_starts`` are left
    out, so a padded block does not report ``|0 - 1| = 1`` on its padding
    diagonal.
    """
    # Local import: pth_root imports this module for the diagnostics type.
    from precondition_tpu_torch.ops.pth_root import mat_power

    n, m, _ = roots.shape
    mat_m = torch.matmul(mat_power(roots, p), matrices)
    f32 = torch.float32
    if padding_starts is None:
      valid = torch.ones((n, m), dtype=mat_m.dtype, device=mat_m.device)
      count = torch.full((n,), float(m), dtype=f32, device=mat_m.device)
    else:
      pads = torch.as_tensor(padding_starts, device=mat_m.device)
      valid = (torch.arange(m, device=mat_m.device)[None, :]
               < pads[:, None]).to(mat_m.dtype)
      count = torch.clamp(pads.to(f32), min=1.0)
    num_off_diag = torch.clamp(count * count - count, min=1.0)
    diag = torch.diagonal(mat_m, dim1=-2, dim2=-1)
    diag_error = ((diag - 1).abs() * valid).to(f32)
    off_diag_error = ((mat_m - torch.diag_embed(diag)).abs()
                      * valid[:, :, None] * valid[:, None, :]).to(f32)
    return cls(
        max_diag_error=diag_error.amax(dim=1),
        avg_diag_error=diag_error.sum(dim=1) / count,
        max_off_diag_error=off_diag_error.amax(dim=(1, 2)),
        avg_off_diag_error=off_diag_error.sum(dim=(1, 2)) / num_off_diag,
        p=torch.full((n,), float(p), dtype=f32, device=mat_m.device))

  def map(self, fn) -> "InversePthRootDiagnostics":
    """Apply ``fn`` to every field."""
    return InversePthRootDiagnostics(**{
        f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

  @staticmethod
  def cat(parts) -> "InversePthRootDiagnostics":
    return InversePthRootDiagnostics(**{
        f.name: torch.cat([getattr(q, f.name) for q in parts])
        for f in dataclasses.fields(InversePthRootDiagnostics)})
