"""Low-rank compressed and frequent-directions inverse roots, batched.

PyTorch counterpart of `precondition_tpu/ops/lowrank.py`.  For a block
whose statistic is large next to the rank, the ``[d, d]`` inverse root is
replaced by a rank-``k`` approximation plus a constant on the orthogonal
complement, packed into a ``[d, k + 2]`` buffer:

* `low_rank_root`: eigendecompose the statistic, keep k inverse-root
  eigenpairs, average the rest into one constant;
* `fd_update_root`: one frequent-directions ("Sketchy") step of the packed
  preconditioner itself: stack the decayed, weighted sketch beside the new
  gradient's Cholesky factor, take its SVD, deflate by the (k+1)-th
  singular value, add the escaped mass to a tail and invert the
  upshifted spectrum, with the JAX package's three guards;
* `frequent_directions_update`: the square factor ``R`` with ``R R^T =
  G_(a) G_(a)^T`` of a gradient block, by QR.

Every function is batched over a leading dimension ``N`` and takes a
per-member ``padding_starts [N]``: one library call (eigh, SVD or QR)
serves a whole group of equal-size blocks.

Packing layout (the JAX package's, so states move across unchanged)::

    buf[:, :k]    eigvecs                 buf[:k, -2]  inverted eigvals
    buf[0, -1]    tail constant (root)    buf[1, -1]   tail (raw)
    buf[-k:, -1]  deflated eigvals        buf[-1, -2]  has_zeros flag
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.pth_root import RootMetrics
from precondition_tpu_torch.utils.diagnostics import FDDiagnostics


def precond_dim(compression_rank: int, dim: int) -> int:
  """Storage width: ``|rank| + 2`` when compressing saves memory."""
  if not compression_rank:
    return dim
  compressed = abs(compression_rank) + 2
  return dim if compressed >= dim else compressed


def should_compress(compression_rank: int, dim: int) -> bool:
  return compression_rank != 0 and abs(compression_rank) + 2 < dim


def fd_pack(eigvecs, deflated_eigs, inverted_eigs, const, tail, has_zeros,
            rank: int) -> torch.Tensor:
  """Packs ``eigvecs [N, d, k]``, ``deflated_eigs``/``inverted_eigs
  [N, k]`` and ``const``/``tail``/``has_zeros [N]`` into ``[N, d, k+2]``."""
  rank = abs(rank)
  n, d, _ = eigvecs.shape
  if eigvecs.shape[-1] != rank or precond_dim(rank, d) != rank + 2:
    raise ValueError(f"cannot pack {tuple(eigvecs.shape)} at rank {rank}")
  buf = eigvecs.new_zeros((n, d, rank + 2))
  buf[:, :, :rank] = eigvecs
  buf[:, :rank, -2] = inverted_eigs
  buf[:, 0, -1] = const
  buf[:, 1, -1] = tail
  buf[:, -rank:, -1] = deflated_eigs
  buf[:, -1, -2] = has_zeros.to(buf.dtype)
  return buf


def fd_unpack(buf: torch.Tensor, compression_rank: int):
  """Inverse of `fd_pack`: ``(eigvecs, eigvals, inv_eigvals, const, tail,
  has_zeros)``."""
  r = abs(compression_rank)
  _, d, storage = buf.shape
  if storage != r + 2 or storage >= d:
    raise ValueError(f"not a packed buffer of rank {r}: {tuple(buf.shape)}")
  return (buf[:, :, :r], buf[:, -r:, -1], buf[:, :r, -2], buf[:, 0, -1],
          buf[:, 1, -1], buf[:, -1, -2].to(torch.bool))


def low_rank_pack(eigvecs, eigvals, const, compression_rank: int
                  ) -> torch.Tensor:
  zeros = torch.zeros_like(const)
  return fd_pack(eigvecs, torch.zeros_like(eigvals), eigvals, const, zeros,
                 zeros.to(torch.bool), compression_rank)


def low_rank_unpack(buf: torch.Tensor, compression_rank: int):
  """``(eigvecs, inverted_eigvals, const, has_zeros)``."""
  eigvecs, _, inv, const, _, has_zeros = fd_unpack(buf, compression_rank)
  return eigvecs, inv, const, has_zeros


def frequent_directions_update(g: torch.Tensor, axis: int) -> torch.Tensor:
  """Square factors ``R [B, d, d]`` with ``R R^T = G_(a) G_(a)^T`` for a
  batch of equal-shape gradient blocks ``g [B, ...]``; ``axis`` indexes a
  block's own dimensions.  Only the gradient enters: frequent directions
  keeps its history in the preconditioner's sketch, not the statistic."""
  b, d = g.shape[0], g.shape[axis + 1]
  x = g.movedim(axis + 1, 1).reshape(b, d, -1)
  r = torch.linalg.qr(x.transpose(1, 2), mode="r")[1].transpose(1, 2)
  return torch.nn.functional.pad(r, (0, d - r.shape[-1]))


def _pads(padding_starts, n, d, device):
  if padding_starts is None:
    return torch.full((n,), d, dtype=torch.int32, device=device)
  return padding_starts.to(device)


def low_rank_root(
    matrices: torch.Tensor,
    p: int,
    compression_rank: int,
    ridge_epsilon: float = 1e-6,
    error_tolerance: float = 1e-6,
    relative_matrix_epsilon: bool = True,
    padding_starts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, RootMetrics]:
  """Rank-``k`` plus constant-tail approximations of ``(A + eps I)^{-1/p}``
  for a ``[N, n, n]`` batch, packed ``[N, n, k + 2]``.

  A positive rank keeps the pairs of A's k largest eigenvalues (the
  smallest inverse roots), a negative one those of its k smallest, as the
  JAX package's code does (its docstring says the reverse); the mean
  inverse root of the rest is the constant applied on the orthogonal
  complement.  The ridge is ``ridge_epsilon * max(
  lambda_max, error_tolerance)``, lambda_max by power iteration with the
  tight absolute ``error_tolerance`` exit.  The error is ``max |U^T (A +
  rI) U - diag(e)|``.  A member of size 0 returns zeros with error 0.
  """
  n, d, _ = matrices.shape
  if not compression_rank or d <= abs(compression_rank) + 2:
    raise ValueError(f"rank {compression_rank} does not compress size {d}")
  dev, f32 = matrices.device, torch.float32
  pads = _pads(padding_starts, n, d, dev)
  mat, identity, mask = pth_root._mask_matrix(matrices.to(f32), pads)
  if relative_matrix_epsilon:
    max_ev = pth_root.power_iteration(mat, num_iters=100,
                                      error_tolerance=error_tolerance,
                                      padding_starts=pads)[1]
  else:
    max_ev = torch.ones((n,), dtype=f32, device=dev)
  ridge = (ridge_epsilon * torch.clamp(max_ev, min=error_tolerance))
  regularized = mat + ridge[:, None, None] * identity
  e, u = pth_root.nan_safe(torch.linalg.eigh, regularized)
  # Ascending order: the padding's zero eigenvalues come first.
  flipped = mask.flip(-1)
  e = e * flipped
  recovered = torch.bmm(u.transpose(1, 2), torch.bmm(regularized, u))
  error = pth_root._rowmax_abs((recovered - torch.diag_embed(e))
                               * flipped[:, None, :])
  inv_e = torch.where(e == 0.0, 0.0,
                      torch.pow(torch.maximum(e, ridge[:, None]), -1.0 / p))
  if compression_rank < 0:
    # Keep A's small-eigenvalue end: rotate the padding zeros to the back.
    idx = (torch.arange(d, device=dev)[None, :] + (d - pads)[:, None]) % d
    inv_e = torch.gather(inv_e, 1, idx)
    u = torch.gather(u, 2, idx[:, None, :].expand(n, d, d))
  else:
    # Keep the top of A's spectrum: the padding zeros go to the back.
    inv_e = inv_e.flip(-1)
    u = u.flip(-1)
  k = abs(compression_rank)
  real_elided = (pads - k).to(f32)
  const = inv_e[:, k:].sum(dim=1) / torch.where(real_elided > 0,
                                                real_elided, 1.0)
  buf = low_rank_pack(u[:, :, :k], inv_e[:, :k], const, compression_rank)
  is_padding = pads == 0
  buf = torch.where(is_padding[:, None, None], 0.0, buf)
  error = torch.where(is_padding, 0.0, error)
  zeros = torch.zeros((n,), dtype=f32, device=dev)
  return buf.to(matrices.dtype), RootMetrics(
      error=error.to(f32), iterations=zeros, error_ratio=zeros,
      max_eigenvalue=max_ev.to(f32), retries=zeros)


def fd_update_root(
    new_grads: torch.Tensor,
    p: int,
    rank: int,
    prevs: torch.Tensor,
    ridge_epsilon: float = 1e-6,
    error_tolerance: float = 1e-6,
    relative_matrix_epsilon: bool = True,
    decay: float = 1.0,
    padding_starts: Optional[torch.Tensor] = None,
    generate_fd_metrics: bool = False,
) -> Tuple[torch.Tensor, RootMetrics]:
  """One frequent-directions step of each packed preconditioner.

  ``new_grads [N, d, d]`` are the (zero-padded) Cholesky factors of the new
  gradients' Gram matrices, ``prevs [N, d, rank + 2]`` the previous packed
  buffers.  The ridge is ``ridge_epsilon * max(lambda, error_tolerance)``
  with ``lambda`` the previous sketch's top deflated eigenvalue (1 when not
  ``relative_matrix_epsilon``).  Three guards drop a direction: a
  non-positive deflated eigenvalue, an eigenvector whose norm is not
  within 1% of one, and one whose L1 mass on the padding exceeds 0.01.
  The error is 0.  ``generate_fd_metrics`` attaches `FDDiagnostics`.
  """
  n, d, _ = new_grads.shape
  pd = precond_dim(rank, d)
  if rank <= 0 or tuple(prevs.shape) != (n, d, pd) or pd != rank + 2:
    raise ValueError(f"rank {rank} and prevs {tuple(prevs.shape)} do not "
                     f"fit statistics {tuple(new_grads.shape)}")
  dev, f32 = new_grads.device, torch.float32
  sketch, fwd_eigvals, _, _, tail, _ = fd_unpack(prevs, rank)
  if relative_matrix_epsilon:
    max_ev = fwd_eigvals[:, 0]
  else:
    max_ev = torch.ones((n,), dtype=f32, device=dev)
  ridge = ridge_epsilon * torch.clamp(max_ev, min=error_tolerance)
  pads = _pads(padding_starts, n, d, dev)
  active_d = (pads[:, None] > torch.arange(d, device=dev)).to(f32)
  active_r = (pads[:, None] > torch.arange(rank, device=dev)).to(f32)

  # SVD ignores padding; re-zero it so error cannot compound.
  sketch = sketch * active_d[:, :, None] * active_r[:, None, :]
  fwd_eigvals = (fwd_eigvals + ridge[:, None]) * active_r
  weighted = sketch * torch.sqrt(fwd_eigvals)[:, None, :]
  grad = new_grads * active_d[:, None, :] * active_d[:, :, None]

  # [decayed sketch ; grad factor]: its Gram is decay S S^T + G G^T.
  updated = torch.cat([decay ** 0.5 * weighted, grad], dim=2)
  u, s, vt = pth_root.nan_safe(
      lambda x: torch.linalg.svd(x, full_matrices=False), updated)
  cutoff = s[:, rank]
  rho = cutoff ** 2
  top = s[:, :rank]
  deflated = (top - cutoff[:, None]) * (top + cutoff[:, None])
  eigvecs = u[:, :, :rank]
  tail = tail * decay
  new_tail = tail + rho

  alpha = -1.0 / p
  new_const = torch.where(new_tail <= 0, 0.0, new_tail ** alpha)
  new_tail = torch.where(new_tail <= 0, 0.0, new_tail)
  num_neg_eigs = (deflated < 0).sum(dim=1)
  num_zero_initial_eigs = (deflated == 0.0).sum(dim=1)
  deflated = torch.where(deflated <= 0, 0.0, deflated)
  eigvecs = eigvecs * (deflated > 0)[:, None, :]

  # Guard 1: drop the vectors the SVD returns far from unit norm.
  norms = torch.linalg.vector_norm(eigvecs, dim=1)
  safe = (0.99 <= norms) & (norms <= 1.01)
  eigvecs = (eigvecs * safe[:, None, :]
             / torch.where(safe, norms, 1.0)[:, None, :])
  deflated = deflated * safe
  num_unsafe_norms = (~safe).sum(dim=1) - (num_neg_eigs
                                           + num_zero_initial_eigs)

  # Guard 2: drop directions leaking into the padding subspace.
  pad_rows = (torch.arange(d, device=dev)[None, :] >= pads[:, None])
  pad_mass = (eigvecs * pad_rows[:, :, None]).abs().sum(dim=1)
  leaked = (pad_mass > 0.01).to(f32)
  eigvecs = eigvecs * (1 - leaked)[:, None, :]
  deflated = deflated * (1 - leaked)

  upshifted = torch.where(deflated > 0, top ** 2 + tail[:, None], 0.0)
  inverted = torch.where(upshifted <= 0, 0.0, upshifted ** alpha)
  has_zeros = (deflated <= 0).any(dim=1) | (new_tail <= 0)
  buf = fd_pack(eigvecs, deflated, inverted, new_const, new_tail, has_zeros,
                rank)
  buf = torch.where((pads == 0)[:, None, None], 0.0, buf)
  zeros = torch.zeros((n,), dtype=f32, device=dev)
  metrics = RootMetrics(error=zeros, iterations=zeros, error_ratio=zeros,
                        max_eigenvalue=max_ev.to(f32), retries=zeros)
  if generate_fd_metrics:
    # Top-k fit, against the rank-k reconstruction of the updated sketch.
    recovered = torch.bmm(u[:, :, :rank] * s[:, None, :rank],
                          vt[:, :rank, :])
    diff = recovered - updated
    pads_f = pads.to(f32)
    metrics.fd = FDDiagnostics.create(
        rho, new_tail, deflated, grad, eigvecs, pads, d, num_neg_eigs,
        num_zero_initial_eigs, num_unsafe_norms, leaked.sum(dim=1),
        diff.square().sum(dim=(1, 2)),
        s[:, rank:].square().sum(dim=1),
        diff.abs().sum(dim=(1, 2)) / (pads_f ** 2 + pads_f * rank),
        updated.square().sum(dim=(1, 2)))
  return buf, metrics


def apply_low_rank_preconditioner(g: torch.Tensor,
                                  preconditioners: torch.Tensor,
                                  compression_rank: int) -> torch.Tensor:
  """Applies packed ``[B, d, k+2]`` preconditioners to axis 1 of a batch
  of blocks ``g [B, d, ...]``; the axis moves to the end, as the
  contraction cycle of `Preconditioner.preconditioned_grad` expects.  A
  member whose has_zeros flag is set passes through unscaled."""
  eigvecs, inv_eigvals, const, skip = low_rank_unpack(preconditioners,
                                                      compression_rank)
  lead = (g.shape[0],) + (1,) * (g.dim() - 2)
  basis = torch.einsum("bi...,bik->b...k", g, eigvecs)
  lowrank = torch.einsum("b...k,bjk->b...j", basis, eigvecs)
  rolled = g.movedim(1, -1)
  scaled = torch.einsum("b...k,bjk->b...j",
                        basis * inv_eigvals.reshape(lead + (-1,)), eigvecs)
  new_g = const.reshape(lead + (1,)) * (rolled - lowrank) + scaled
  return torch.where(skip.reshape(lead + (1,)), rolled, new_g)
