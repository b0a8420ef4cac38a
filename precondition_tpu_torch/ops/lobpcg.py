"""Top-k eigenpairs of a batch of symmetric matrices by LOBPCG.

Batched PyTorch port of the routine the JAX package calls for its LOBPCG
deflation, JAX's own `jax.experimental.sparse.linalg.lobpcg_standard`: the
same steps in the same order (SVQB orthonormalization, the projection of
the residuals out of ``[X, P]``, the Rayleigh-Ritz solve on ``[X, P, R]``,
the householder basis extension that starts P), so that a run stopped
after a few iterations, as the deflation stops it, returns the same pairs.
A different eigensolver (`torch.lobpcg` among them) stopped there returns
other pairs, another deflation and another root.

Each member of the batch leaves the loop on its own, as JAX's
`while_loop` under `vmap` lets it: once a member has converged or run out
of iterations its state is frozen.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from precondition_tpu_torch.ops import pth_root


def _norms(x: torch.Tensor) -> torch.Tensor:
  """Column norms of a ``[N, n, k]`` batch, ``[N, 1, k]``."""
  return torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _eigh_descending(a: torch.Tensor):
  # A member can turn NaN, as under JAX: the Ritz vectors of an all-zero
  # member (pure padding) have zero norm and are divided by it.
  w, v = pth_root.nan_safe(torch.linalg.eigh, a)
  return w.flip(-1), v.flip(-1)


def _svqb(x: torch.Tensor) -> torch.Tensor:
  """Orthonormal basis of each member's columns by SVQB; the columns of a
  rank-deficient member's trailing directions come back zero."""
  norms = _norms(x)
  x = x / torch.where(norms == 0, 1.0, norms)
  inner = torch.bmm(x.transpose(1, 2), x)
  w, v = _eigh_descending(inner)
  # A direction whose eigenvalue is below eps times the largest is taken
  # as degenerate.
  tau = torch.finfo(x.dtype).eps * w[:, :1]
  padded = torch.maximum(w, tau)
  sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
  ortho = torch.bmm(x, v * sqrted[:, None, :])
  keep = ((w > tau) & (torch.diagonal(inner, dim1=1, dim2=2) > 0))[:, None]
  ortho = ortho * keep.to(ortho.dtype)
  norms = _norms(ortho)
  keep = keep & (norms > 0)
  return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
  for _ in range(2):  # twice is enough
    basis = _svqb(basis)
  return basis


def _project_out(basis: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
  """The component of ``u`` orthogonal to the (orthonormal, zero columns
  allowed) ``basis``; its nonzero columns are orthonormal, and a column
  that does not keep a norm of 0.99 after the last subtraction is zeroed."""
  for _ in range(2):
    u = u - torch.bmm(basis, torch.bmm(basis.transpose(1, 2), u))
    u = _orthonormalize(u)
  for _ in range(2):
    u = u - torch.bmm(basis, torch.bmm(basis.transpose(1, 2), u))
  return u * (_norms(u) >= 0.99).to(u.dtype)


def _rayleigh_ritz_orth(a: torch.Tensor, s: torch.Tensor):
  """Eigenpairs (descending) of ``S^T A S`` for an orthonormal ``S``."""
  return _eigh_descending(torch.bmm(s.transpose(1, 2), torch.bmm(a, s)))


def _extend_basis(x: torch.Tensor, m: int) -> torch.Tensor:
  """``m`` more orthonormal columns beside an orthonormal ``x [N, n, k]``,
  from a block householder reflector (deterministic, never overlapping
  ``x``)."""
  _, n, k = x.shape
  upper, lower = x[:, :k], x[:, k:]
  u, s, vt = pth_root.nan_safe(torch.linalg.svd, upper)
  y = torch.cat([upper + torch.bmm(u, vt), lower], dim=1)
  other = torch.cat([torch.eye(m, dtype=x.dtype, device=x.device),
                     torch.zeros((n - k - m, m), dtype=x.dtype,
                                 device=x.device)], dim=0)
  w = torch.bmm(y, vt.transpose(1, 2) * ((2 * (1 + s)) ** -0.5)[:, None, :])
  # w (w[k:]^T other), the order jnp.linalg.multi_dot picks for these shapes.
  h = -2 * torch.bmm(w, torch.matmul(w[:, k:].transpose(1, 2), other))
  h[:, k:] += other
  return h


def _check_inputs(n: int, k: int) -> None:
  """JAX's `_check_inputs`: ``0 < k`` and ``5 k < n``."""
  if k == 0:
    raise ValueError(f"must have search dim > 0, got {k}")
  if k * 5 >= n:
    raise ValueError(
        f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")


def lobpcg_standard(a: torch.Tensor, x: torch.Tensor, m: int = 100,
                    tol: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Top-k eigenpairs of each member of a symmetric ``a [N, n, n]``.

  ``x [N, n, k]`` holds the starting search directions (orthonormalized
  here).  A member stops after ``m`` iterations or once all k pairs have
  residual norm ``|A v - l v|`` below ``tol * 10 n (l + |A v|)``; ``tol``
  defaults to the dtype's eps.

  Returns:
    ``(eigenvalues [N, k] descending, eigenvectors [N, n, k],
    iterations [N])``.
  """
  _, n, k = x.shape
  _check_inputs(n, k)
  if tol is None:
    tol = float(torch.finfo(x.dtype).eps)
  x = _orthonormalize(x)
  p = _extend_basis(x, k)
  ax = torch.bmm(a, x)
  theta = (x * ax).sum(dim=1)
  r = ax - theta[:, None, :] * x
  iters = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
  converged = torch.zeros_like(iters)
  active = (iters < m) & (converged < k)
  # One host sync per iteration for the loop exit, as the vmapped
  # while-loop evaluates its batched predicate once per trip.
  while bool(active.any()):
    r_new = _project_out(torch.cat([x, p], dim=2), r)
    xpr = torch.cat([x, p, r_new], dim=2)
    theta_new, q = _rayleigh_ritz_orth(a, xpr)
    b = q[:, :, :k]
    b = b / _norms(b)
    x_new = torch.bmm(xpr, b)
    x_new = x_new / _norms(x_new)
    # P spans the new directions of [X, P] that X leaves out: orthogonalize
    # the Ritz vectors' non-X part against their X part in the standard
    # basis, then map by XPR (orthonormal, so P is too).
    qq, _ = pth_root.nan_safe(torch.linalg.qr, q[:, :k, k:].transpose(1, 2))
    p_new = torch.bmm(xpr, torch.bmm(q[:, :, k:], qq))
    norm_p = _norms(p_new)
    p_new = p_new / torch.where(norm_p == 0, 1.0, norm_p)
    ax = torch.bmm(a, x_new)
    theta_new = theta_new[:, :k]
    r_next = ax - theta_new[:, None, :] * x_new
    resid = torch.linalg.vector_norm(r_next, dim=1)
    reltol = (torch.linalg.vector_norm(ax, dim=1) + theta_new) * n * 10
    conv = (resid < tol * reltol).sum(dim=1).to(converged.dtype)
    a3 = active[:, None, None]
    x = torch.where(a3, x_new, x)
    p = torch.where(a3, p_new, p)
    r = torch.where(a3, r_next, r)
    theta = torch.where(active[:, None], theta_new, theta)
    converged = torch.where(active, conv, converged)
    iters = iters + active.to(iters.dtype)
    active = active & (iters < m) & (converged < k)
  return theta, x, iters
