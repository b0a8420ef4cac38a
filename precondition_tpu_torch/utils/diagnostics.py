"""Per-preconditioner diagnostics of the inverse-root solves.

PyTorch counterparts of `precondition_tpu/utils/diagnostics.py`, batched:
one call reports on a whole batch of solves, each field ``[N]``.  Three
reports: the entrywise residual of a computed root
(`InversePthRootDiagnostics`), the eigenpair consistency of a LOBPCG
deflation (`LOBPCGDiagnostics`) and the health of a frequent-directions
sketch update (`FDDiagnostics`).
"""

from __future__ import annotations

import dataclasses

import torch


class _Report:
  """``zeros``/``map``/``cat`` shared by the batched reports."""

  @classmethod
  def zeros(cls, n: int, device=None):
    fields = dataclasses.fields(cls)
    return cls(*torch.zeros((len(fields), n), dtype=torch.float32,
                            device=device))

  def map(self, fn):
    """Apply ``fn`` to every field."""
    return type(self)(**{f.name: fn(getattr(self, f.name))
                         for f in dataclasses.fields(self)})

  @classmethod
  def cat(cls, parts):
    return cls(**{f.name: torch.cat([getattr(q, f.name) for q in parts])
                  for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class InversePthRootDiagnostics(_Report):
  """Entrywise residual of ``B^p A - I`` for each computed root ``B``."""

  max_diag_error: torch.Tensor
  avg_diag_error: torch.Tensor
  max_off_diag_error: torch.Tensor
  avg_off_diag_error: torch.Tensor
  p: torch.Tensor

  @classmethod
  def create(cls, roots: torch.Tensor, matrices: torch.Tensor, p: int,
             padding_starts=None) -> "InversePthRootDiagnostics":
    """Diagnostics of ``roots [N, m, m]`` against ``matrices [N, m, m]``.

    Rows and columns at and beyond a member's ``padding_starts`` are left
    out, so a padded block does not report ``|0 - 1| = 1`` on its padding
    diagonal.
    """
    # Local import: pth_root imports this module for the diagnostics types.
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


@dataclasses.dataclass
class LOBPCGDiagnostics(_Report):
  """Eigenpair consistency ``|Av - lv| / (l + |Av|)`` and orthogonality."""

  lobpcg_iters: torch.Tensor
  max_consistency_error: torch.Tensor
  avg_consistency_error: torch.Tensor
  avg_orthogonality_error: torch.Tensor
  max_eigenvalue: torch.Tensor
  min_eigenvalue: torch.Tensor
  num_topk_eigenvectors: torch.Tensor

  @classmethod
  def create(cls, matrices: torch.Tensor, eigvals: torch.Tensor,
             eigvecs: torch.Tensor, lobpcg_iters: torch.Tensor
             ) -> "LOBPCGDiagnostics":
    """``matrices [N, n, n]``, ``eigvals [N, k]``, ``eigvecs [N, n, k]``,
    ``lobpcg_iters [N]``."""
    n, _, k = eigvecs.shape
    f32 = torch.float32
    mat_eigvecs = torch.bmm(matrices, eigvecs)
    consistency_raw = torch.linalg.vector_norm(
        mat_eigvecs - eigvals[:, None, :] * eigvecs, dim=1)
    normalization = torch.linalg.vector_norm(mat_eigvecs, dim=1) + eigvals
    consistency = consistency_raw / normalization
    ortho = torch.bmm(eigvecs.transpose(1, 2), eigvecs)
    ortho = ortho - torch.diag_embed(torch.diagonal(ortho, dim1=1, dim2=2))
    return cls(
        lobpcg_iters=lobpcg_iters.to(f32),
        max_consistency_error=consistency.amax(dim=1).to(f32),
        avg_consistency_error=consistency.mean(dim=1).to(f32),
        avg_orthogonality_error=(ortho.sum(dim=(1, 2))
                                 / (k * (k - 1))).to(f32),
        max_eigenvalue=eigvals.amax(dim=1).to(f32),
        min_eigenvalue=eigvals.amin(dim=1).to(f32),
        num_topk_eigenvectors=torch.full((n,), float(k), dtype=f32,
                                         device=eigvals.device))


@dataclasses.dataclass
class FDDiagnostics(_Report):
  """Health report of frequent-directions preconditioner updates."""

  size_max_size: torch.Tensor
  size_rank: torch.Tensor
  size_padding_start: torch.Tensor
  rho: torch.Tensor            # latest deflation amount
  tail: torch.Tensor           # cumulative escaped mass
  eig_sparsity: torch.Tensor
  eig_max: torch.Tensor
  eig_min: torch.Tensor
  new_grad_abs_max: torch.Tensor
  new_grad_sparsity: torch.Tensor
  new_grad_col_sparsity: torch.Tensor
  ggt_eig_max: torch.Tensor
  ggt_intrinsic_dimension: torch.Tensor
  max_ortho_err: torch.Tensor
  num_neg_eigs: torch.Tensor
  num_zero_initial_eigs: torch.Tensor
  num_unsafe_norms: torch.Tensor
  num_has_padding: torch.Tensor
  square_frob: torch.Tensor
  heuristic_frob: torch.Tensor
  entrywise_err: torch.Tensor
  total_frob: torch.Tensor

  @classmethod
  def create(cls, rho, tail, eigs, new_grad, eigvecs, padding_starts,
             max_size, num_neg_eigs, num_zero_initial_eigs,
             num_unsafe_norms, num_has_padding, frob, expected_frob,
             entrywise_svd_err, total_frob) -> "FDDiagnostics":
    """Batched over ``[N]``: ``eigs [N, k]``, ``new_grad [N, d, d]``,
    ``eigvecs [N, d, k]``, ``padding_starts [N]``; the rest ``[N]``."""
    n, d, rank = eigvecs.shape
    f32 = torch.float32
    dev = eigs.device
    pads = padding_starts.to(dev)
    eig_max = eigs.amax(dim=1).to(f32)
    eig_min = torch.where(eigs != 0, eigs, eig_max[:, None]).amin(dim=1)
    nonpad = (torch.arange(d, device=dev)[None, :]
              < pads[:, None]).to(new_grad.dtype)
    mask = nonpad[:, None, :] * nonpad[:, :, None]
    new_grad = new_grad * mask
    ggt = torch.bmm(new_grad, new_grad.transpose(1, 2))
    ggt_eig_max = torch.linalg.eigvalsh(ggt).amax(dim=1)
    cross = torch.bmm(eigvecs.transpose(1, 2), eigvecs)
    ortho_err = (cross - torch.diag_embed(torch.diagonal(cross, dim1=1,
                                                         dim2=2))).abs()
    col_l1 = new_grad.abs().sum(dim=1)
    pads_f = pads.to(f32)
    full = lambda value: torch.full((n,), float(value), dtype=f32,
                                    device=dev)
    return cls(
        size_max_size=full(max_size),
        size_rank=full(rank),
        size_padding_start=pads_f,
        rho=rho.to(f32),
        tail=tail.to(f32),
        eig_sparsity=(eigs == 0).to(f32).mean(dim=1),
        eig_max=eig_max,
        eig_min=eig_min,
        new_grad_abs_max=new_grad.abs().amax(dim=(1, 2)).to(f32),
        new_grad_sparsity=(mask * (new_grad == 0)).sum(dim=(1, 2)).to(f32)
        / pads_f ** 2,
        new_grad_col_sparsity=(nonpad * (col_l1 == 0)).sum(dim=1).to(f32)
        / pads_f,
        ggt_eig_max=ggt_eig_max,
        ggt_intrinsic_dimension=torch.diagonal(ggt, dim1=1, dim2=2).sum(
            dim=1) / ggt_eig_max,
        max_ortho_err=ortho_err.amax(dim=(1, 2)).to(f32),
        num_neg_eigs=num_neg_eigs.to(f32),
        num_zero_initial_eigs=num_zero_initial_eigs.to(f32),
        num_unsafe_norms=num_unsafe_norms.to(f32),
        num_has_padding=num_has_padding.to(f32),
        square_frob=frob,
        heuristic_frob=expected_frob,
        entrywise_err=entrywise_svd_err,
        total_frob=total_frob)
