"""Matrix inverse p-th roots: the batched solvers and their helpers.

PyTorch counterpart of `precondition_tpu/ops/pth_root.py`: the solver's
metrics record, the padding masks, the static-exponent matrix power, a
batched power iteration, `pth_root_difference`, and two batched solvers of
``(A + eps I)^{-1/p}`` over a ``[N, m, m]`` stack,
`batched_inverse_pth_root` (the JAX package's per-matrix coupled Newton,
`matrix_inverse_pth_root` under `vmap`, with its LOBPCG deflation) and its
``eigh=True`` form; and the matmul-only spectral projector
`batched_spectral_projector` of tearfree's filtered roots.  The
Newton-root kernel and its twin live in `ops/kernels/newton_root.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from precondition_tpu_torch.utils.diagnostics import (
    FDDiagnostics, InversePthRootDiagnostics, LOBPCGDiagnostics)

_EPSILON = 1e-25
_METRIC_FIELDS = ("error", "iterations", "error_ratio", "max_eigenvalue",
                  "retries")
# The optional reports of `RootMetrics`, each None unless asked for, and
# their classes.
REPORTS = {
    "lobpcg": LOBPCGDiagnostics,
    "inverse_pth_root_diagnostics": InversePthRootDiagnostics,
    "conditioned_inverse_pth_root_diagnostics": InversePthRootDiagnostics,
    "fd": FDDiagnostics,
}
# Seed of the power iteration's start vector.  The JAX package draws it
# from `jax.random.PRNGKey(1729)`; torch cannot reproduce those bits, so
# callers that need JAX's exact vector pass it as ``v0``.
_V0_SEED = 1729


@dataclasses.dataclass
class RootMetrics:
  """Diagnostics of one batch of inverse-pth-root solves (``[N]`` each).

  The fields of the JAX package's `RootMetrics`: max entrywise error of
  ``M_k - I``, Newton iterations, final error ratio, the top eigenvalue
  that scaled the ridge, and how many ridge rounds ran.  The reports are
  None unless asked for, where JAX holds a `MaskedNode`: the detailed
  metrics (`generate_detailed_metrics`) are ``lobpcg``, the entrywise
  residual ``inverse_pth_root_diagnostics`` and that of the deflated
  problem, ``conditioned_inverse_pth_root_diagnostics``; ``fd`` is the
  frequent-directions report (`generate_fd_metrics`).
  """

  error: torch.Tensor
  iterations: torch.Tensor
  error_ratio: torch.Tensor
  max_eigenvalue: torch.Tensor
  retries: torch.Tensor
  lobpcg: Optional[LOBPCGDiagnostics] = None
  inverse_pth_root_diagnostics: Optional[InversePthRootDiagnostics] = None
  conditioned_inverse_pth_root_diagnostics: Optional[
      InversePthRootDiagnostics] = None
  fd: Optional[FDDiagnostics] = None

  @classmethod
  def zeros(cls, n: int, detailed: bool = False, fd: bool = False,
            device=None) -> "RootMetrics":
    """``[n]`` metrics of zeros, with zero detailed reports if
    ``detailed`` and a zero FD report if ``fd``."""
    fields = torch.zeros((5, n), dtype=torch.float32, device=device)
    out = cls(*fields)
    if detailed:
      out.lobpcg = LOBPCGDiagnostics.zeros(n, device)
      out.inverse_pth_root_diagnostics = InversePthRootDiagnostics.zeros(
          n, device)
      out.conditioned_inverse_pth_root_diagnostics = (
          InversePthRootDiagnostics.zeros(n, device))
    if fd:
      out.fd = FDDiagnostics.zeros(n, device)
    return out

  def map(self, fn) -> "RootMetrics":
    """Apply ``fn`` to every field, the reports' included."""
    reports = {f: getattr(self, f) for f in REPORTS}
    return RootMetrics(
        **{f: fn(getattr(self, f)) for f in _METRIC_FIELDS},
        **{f: None if r is None else r.map(fn) for f, r in reports.items()})

  def fill(self, template: "RootMetrics") -> "RootMetrics":
    """These metrics with each report they lack taken from ``template``."""
    return dataclasses.replace(template, **{
        f.name: getattr(self, f.name) for f in dataclasses.fields(self)
        if getattr(self, f.name) is not None})

  @staticmethod
  def cat(parts) -> "RootMetrics":
    reports = {}
    for f, cls in REPORTS.items():
      values = [getattr(p, f) for p in parts]
      reports[f] = None if values[0] is None else cls.cat(values)
    return RootMetrics(
        **{f: torch.cat([getattr(p, f) for p in parts])
           for f in _METRIC_FIELDS}, **reports)


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


def nan_safe(decompose, a: torch.Tensor):
  """``decompose(a)`` (`torch.linalg.eigh`, `svd`, ...) on a ``[N, ...]``
  batch, with every output of a member that holds a non-finite entry NaN.

  LAPACK under JAX returns NaN for such a member, and the failure gate
  rejects its root; torch raises instead, so the member is decomposed as
  zeros and its outputs set to NaN afterwards.  No host sync.
  """
  bad = ~torch.isfinite(a).flatten(1).all(dim=1)
  outs = decompose(torch.where(bad.view((-1,) + (1,) * (a.dim() - 1)), 0.0,
                               a))
  return tuple(torch.where(bad.view((-1,) + (1,) * (o.dim() - 1)), torch.nan,
                           o) for o in outs)


def _padding_mask(n: int, padding_start, dtype, device=None) -> torch.Tensor:
  """Mask over the last axis: 1 for indices < padding_start, 0 after.

  ``padding_start`` may be an int or an ``[N]`` tensor (one mask row per
  member).
  """
  idx = torch.arange(n, dtype=torch.int32, device=device)
  if isinstance(padding_start, torch.Tensor):
    return (idx[None, :] < padding_start[:, None].to(idx.device)).to(dtype)
  return (idx < padding_start).to(dtype)


def _mask_matrix(matrix: torch.Tensor, padding_starts: torch.Tensor):
  """Zeroes rows and columns ``>= padding_starts`` of a ``[N, m, m]`` batch;
  returns ``(masked matrices, masked identities, [N, m] mask)``."""
  mask = _padding_mask(matrix.shape[-1], padding_starts, matrix.dtype,
                       matrix.device)
  matrix = matrix * mask[:, :, None] * mask[:, None, :]
  return matrix, torch.diag_embed(mask), mask


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


def newton_step(mat_m: torch.Tensor, mat_h: torch.Tensor, eye: torch.Tensor,
                p: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """One coupled-Newton step on a batch: ``T = (1 + 1/p) I - M / p``, then
  ``M <- T^p M`` and ``H <- H T``."""
  inv_p = 1.0 / p
  mat_t = (1.0 + inv_p) * eye + (-inv_p) * mat_m
  return torch.bmm(mat_power(mat_t, p), mat_m), torch.bmm(mat_h, mat_t)


def warm_start_products(mat: torch.Tensor, prev: torch.Tensor, p: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(C A C, C C)`` with ``C = prev^{p/2}``: the warm start's problem is
  ``C (A + r I) C = CAC + r CC`` for whichever ridge r a round takes."""
  mat_c = mat_power(prev, p // 2)
  cmc = torch.bmm(mat_c, torch.bmm(mat, mat_c))
  return 0.5 * (cmc + cmc.transpose(1, 2)), torch.bmm(mat_c, mat_c)


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


def batched_spectral_projector(stats: torch.Tensor, thresholds: torch.Tensor,
                               num_iters: int = 30) -> torch.Tensor:
  """Smooth spectral projector ``P ~= 1{eig(A) > threshold}``, batched.

  The JAX package's `batched_spectral_projector`: on ``B_0 = (A - t I) /
  s`` (spectrum in [-1, 1]) iterate the Newton-Schulz quintic for the
  matrix sign function, ``f(x) = (15 x - 10 x^3 + 3 x^5) / 8``, which maps
  [-1, 1] into itself monotonically with slope 15/8 at 0; then ``P = (I +
  sign(A - t I)) / 2``.  An eigenvalue at relative distance ``delta`` from
  the threshold resolves after ``log(1/delta) / log(15/8)`` iterations.

  The scale ``s`` is a guaranteed upper bound of lambda_max, ``min(||A||_F,
  ||A||_inf)``, never an estimate: the quintic diverges for |x| above about
  1.3, so a low estimate (a loose power iteration on a covariance with
  lambda_max << 1) is fatal, while a high bound costs only a few more
  iterations.  Each iteration is three batched products in true f32.

  Args:
    stats: ``[N, d, d]`` symmetric batch.
    thresholds: ``[N]`` absolute eigenvalue cutoffs (e.g. ``eps * λmax``).
    num_iters: sign-iteration count.

  Returns:
    ``[N, d, d]`` symmetric projector batch with eigenvalues in [0, 1].
  """
  require_true_f32()
  eye = torch.eye(stats.shape[-1], dtype=stats.dtype, device=stats.device)
  fro = torch.sqrt(torch.sum(torch.square(stats), dim=(1, 2)))
  infn = torch.amax(torch.sum(torch.abs(stats), dim=2), dim=1)
  bound = torch.minimum(fro, infn)
  # The shifted matrix's extremes are lambda_max - t (above) and -t
  # (below); bound >= lambda_max >= both magnitudes for t >= 0, and the
  # threshold term keeps the negative end in basin even if t > bound.
  scale = torch.clamp(torch.maximum(bound, thresholds), min=_EPSILON)
  b = (stats - thresholds[:, None, None] * eye) / scale[:, None, None]
  for _ in range(num_iters):
    c = torch.bmm(b, b)
    c2 = torch.bmm(c, c)
    b = torch.bmm(b, 1.875 * eye - 1.25 * c + 0.375 * c2)
  return 0.5 * (b + eye)


def _rowmax_abs(x: torch.Tensor) -> torch.Tensor:
  """``max |x|`` per member of a ``[N, m, m]`` batch; propagates NaN."""
  return x.abs().amax(dim=(1, 2))


def pth_root_difference(w: torch.Tensor, alpha: torch.Tensor,
                        beta: torch.Tensor, p: int) -> torch.Tensor:
  """``(w + alpha)^{-1/p} - (w + beta)^{-1/p}`` without cancellation.

  The larger term is factored out and the rest taken in log space with
  ``expm1``/``log1p``, on whichever side has the smaller ``log1p``
  argument.  The arguments broadcast.
  """
  a = w + alpha
  b = w + beta
  d = alpha - beta
  exp = -1.0 / p

  def stable(base, diff):
    return (base ** exp) * torch.expm1(exp * torch.log1p(diff / base))

  return torch.where((d / b).abs() < (d / a).abs(), -stable(a, -d),
                     stable(b, d))


def _deflate(mat, k, max_iter, diagnose):
  """LOBPCG's top-k pairs of each member, and the member with them
  deflated to the smallest of the k: ``(deflated, eigvals [N, k],
  eigvecs [N, m, k], LOBPCGDiagnostics or None)``."""
  # Local import: lobpcg imports this module for `nan_safe`.
  from precondition_tpu_torch.ops import lobpcg

  n, m, _ = mat.shape
  search = torch.zeros((n, m, k), dtype=mat.dtype, device=mat.device)
  search[:, :k] = torch.eye(k, dtype=mat.dtype, device=mat.device)
  eigvals, eigvecs, iters = lobpcg.lobpcg_standard(mat, search,
                                                   max_iter or k)
  report = (LOBPCGDiagnostics.create(mat, eigvals, eigvecs, iters)
            if diagnose else None)
  scaled = eigvecs * torch.sqrt(
      eigvals - eigvals.amin(dim=1, keepdim=True))[:, None, :]
  return (mat - torch.bmm(scaled, scaled.transpose(1, 2)), eigvals, eigvecs,
          report)


def batched_inverse_pth_root(
    stats: torch.Tensor,
    p: int,
    padding_starts: Optional[torch.Tensor] = None,
    prevs: Optional[torch.Tensor] = None,
    *,
    num_iters: int = 100,
    ridge_epsilon: float = 1e-6,
    error_tolerance: float = 1e-6,
    relative_matrix_epsilon: bool = True,
    eigh: bool = False,
    retry_loop_error_threshold: float = 0.05,
    num_tries: int = 6,
    max_error_ratio: float = 1.2,
    warm_error_threshold: float = 0.05,
    generate_diagnostics: bool = False,
    cold_power_iteration_tolerance: Optional[float] = None,
    lobpcg_topk_precondition: int = 0,
    lobpcg_max_iter: int = 0,
) -> Tuple[torch.Tensor, RootMetrics]:
  """``(A + eps I)^{-1/p}`` for every member of a ``[N, m, m]`` PSD batch.

  The JAX package's `batched_inverse_pth_root`: its per-matrix
  `matrix_inverse_pth_root` (coupled Newton, or `eigh` with ``eigh=True``)
  under `vmap`, here one batched loop in which each member leaves on its
  own, as a vmapped while-loop lets it.  ``p`` is a static int.

  * The ridge is ``ridge_epsilon * max(lambda_max, 1e-25)``, lambda_max
    from an in-solver power iteration: for a cold solve with the tight
    absolute 1e-6 exit, or a loose relative one at
    ``cold_power_iteration_tolerance`` when given (the JAX module knob
    `COLD_POWER_ITERATION_TOLERANCE`); for a warm solve with a loose
    relative 1% exit.
  * Newton from ``M0 = z (A + rI)``, ``z = (1 + p) / (2 |A + rI|_F)``,
    ``H0 = z^{1/p} I``, one step between exit tests (the JAX knob
    `DEFAULT_NEWTON_UNROLL` at its default; in eager PyTorch unrolling only
    thins the exit tests); a member stops when its error is at most
    ``error_tolerance``, after ``num_iters`` steps, or once a test finds
    its error ratio ``>= max_error_ratio``.
  * A member whose error stays above ``retry_loop_error_threshold`` retries
    with the ridge x10, ``num_tries`` rounds in all.
  * With ``prevs`` and an even p, round 0 first tries the certified warm
    start ``C (A + rI) C``, ``C = prev^{p/2}``, one extra round.
  * ``padding_starts`` masks each member to its valid size; a member of
    size 0 returns zeros with error 0.
  * ``lobpcg_topk_precondition = k > 0`` deflates each member before the
    Newton solve: `ops.lobpcg.lobpcg_standard` (``lobpcg_max_iter``
    iterations, k when 0; JAX's own routine, so its unconverged pairs are
    JAX's) finds the top k pairs, and their eigenvalues drop to the
    smallest of them.  The largest of the k scales the ridge, the solve is
    cold, and the root is re-deflated with `pth_root_difference`; the
    reported error is ``max |H^p (A + rI) - I|`` against the undeflated
    problem at the ridge of the last round.

  Where this differs from the Newton-root kernel and its twin
  (`ops/kernels/newton_root.py`), which port the Pallas kernel's own
  semantics; both share `newton_step` and `warm_start_products`:
  * a divergent step is taken, then undone: the root is the iterate from
    before it, but the error, error ratio and iteration count are those of
    the divergent step, so such a member may retry where the kernel stops;
  * the ridge's lambda_max comes from this solver's own power iteration
    (the kernel takes the optimizer's, always at the loose 1% exit);
  * ``error_ratio`` is reported (the kernel reports 0);
  * ridges grow by exact powers of ten, norms are floored at 1e-25;
  * a cold root is not symmetrised, and with ``prevs`` every round's root
    is (the kernel symmetrises cold roots, and warm ones only where the
    warm start was taken);
  * ``m == 1`` is solved in closed form with zero metrics.

  Returns:
    ``(roots [N, m, m] in stats.dtype, RootMetrics with [N] fields)``;
    with ``generate_diagnostics`` the metrics carry the entrywise residual
    report against the ridge of the round that produced each root, and
    under LOBPCG the eigenpairs' report and the residual of the deflated
    problem (zeros without LOBPCG).
  """
  if stats.dim() != 3 or stats.shape[1] != stats.shape[2]:
    raise ValueError(f"expected a [N, m, m] batch, got {tuple(stats.shape)}")
  if not isinstance(p, int) or p < 1:
    raise ValueError(f"p must be a positive int, got {p!r}")
  n, m, _ = stats.shape
  dev, f32 = stats.device, torch.float32
  if padding_starts is None:
    padding_starts = torch.full((n,), m, dtype=torch.int32, device=dev)
  mat, eye, mask = _mask_matrix(stats.to(f32), padding_starts)
  if eigh:
    roots, metrics = _eigh_roots(mat, eye, mask, padding_starts, p,
                                 ridge_epsilon, error_tolerance,
                                 relative_matrix_epsilon,
                                 generate_diagnostics)
    return roots.to(stats.dtype), metrics
  # A root of the undeflated problem cannot seed the deflated one.
  warm = prevs is not None and p % 2 == 0 and lobpcg_topk_precondition == 0
  original = mat
  eigvals = eigvecs = lobpcg_report = None
  if lobpcg_topk_precondition > 0:
    mat, eigvals, eigvecs, lobpcg_report = _deflate(
        mat, lobpcg_topk_precondition, lobpcg_max_iter, generate_diagnostics)

  if eigvals is not None and relative_matrix_epsilon:
    max_ev = eigvals.amax(dim=1)
  elif relative_matrix_epsilon:
    loose = warm or cold_power_iteration_tolerance is not None
    tol = 1e-2 if warm else (cold_power_iteration_tolerance or 1e-6)
    max_ev = power_iteration(mat, num_iters=100, error_tolerance=tol,
                             padding_starts=padding_starts,
                             relative_tolerance=loose)[1]
  else:
    max_ev = torch.ones((n,), dtype=f32, device=dev)
  ridge = ridge_epsilon * torch.clamp(max_ev, min=_EPSILON)
  zeros = torch.zeros((n,), dtype=f32, device=dev)

  if m == 1:
    root = (mat + ridge[:, None, None]) ** (-1.0 / p)
    error, iters, ratio, retries = zeros, zeros, zeros, zeros
  else:
    if warm:
      prev_w = prevs.to(f32) * mask[:, :, None] * mask[:, None, :]
      cmc, cc = warm_start_products(mat, prev_w, p)
      total_rounds = num_tries + 1
    else:
      total_rounds = num_tries

    def newton(m0, h0, err0, active):
      """One round's Newton phase for the ``active`` members."""
      i = torch.zeros((n,), dtype=torch.int64, device=dev)
      mat_m, mat_h, old_h, error = m0, h0, h0, err0
      ratio = torch.ones((n,), dtype=f32, device=dev)
      active = active & (error > error_tolerance) & (ratio < max_error_ratio)
      # One host sync per test for the loop exit, as the vmapped
      # while-loop evaluates its batched predicate once per trip.
      while bool(active.any()):
        new_m, new_h = newton_step(mat_m, mat_h, eye, p)
        new_error = _rowmax_abs(new_m - eye)
        a3 = active[:, None, None]
        old_h = torch.where(a3, mat_h, old_h)
        mat_m = torch.where(a3, new_m, mat_m)
        mat_h = torch.where(a3, new_h, mat_h)
        ratio = torch.where(active, new_error / error, ratio)
        error = torch.where(active, new_error, error)
        i = i + active
        active = (active & (i < num_iters) & (error > error_tolerance)
                  & (ratio < max_error_ratio))
      return i.to(f32), mat_m, mat_h, old_h, ratio

    root = eye.clone()
    error = torch.full((n,), 1000.0, dtype=f32, device=dev)
    iters = torch.full((n,), 100.0, dtype=f32, device=dev)
    ratio = torch.ones((n,), dtype=f32, device=dev)
    retries = zeros
    failed = torch.ones((n,), dtype=torch.bool, device=dev)
    for rnd in range(total_rounds):
      if not bool(failed.any()):
        break
      ridge_i = ridge * float(10.0 ** (max(rnd - 1, 0) if warm else rnd))
      damped = mat + ridge_i[:, None, None] * eye
      fro = torch.linalg.vector_norm(damped, dim=(1, 2))
      z = (1 + p) / (2 * torch.clamp(fro, min=_EPSILON))
      m0 = damped * z[:, None, None]
      h0 = eye * torch.pow(z, 1.0 / p)[:, None, None]
      if warm:
        m0_w = cmc + ridge_i[:, None, None] * cc
        bound = m0_w.abs().sum(dim=-1).amax(dim=-1)
        z_w = torch.clamp((1 + p) / (2 * torch.clamp(bound, min=_EPSILON)),
                          max=1.0)
        err0_w = _rowmax_abs(m0_w * z_w[:, None, None] - eye)
        use_warm = ((err0_w <= warm_error_threshold) & (rnd == 0))[:, None,
                                                                  None]
        m0 = torch.where(use_warm, m0_w * z_w[:, None, None], m0)
        h0 = torch.where(use_warm,
                         prev_w * torch.pow(z_w, 1.0 / p)[:, None, None], h0)
      err0 = _rowmax_abs(m0 - eye)
      r_iters, mat_m, mat_h, old_h, r_ratio = newton(m0, h0, err0, failed)
      r_error = _rowmax_abs(mat_m - eye)
      converged = (r_ratio < max_error_ratio).to(f32)[:, None, None]
      r_root = converged * mat_h + (1 - converged) * old_h
      if warm:
        r_root = 0.5 * (r_root + r_root.transpose(1, 2))
      # Only members that entered this round adopt its results.
      f3 = failed[:, None, None]
      root = torch.where(f3, r_root, root)
      error = torch.where(failed, r_error, error)
      iters = torch.where(failed, r_iters, iters)
      ratio = torch.where(failed, r_ratio, ratio)
      retries = retries + failed.to(f32)
      failed = failed & (r_error > retry_loop_error_threshold)

  # The ridge the ladder last solved at: a warm round 0 runs at the base
  # ridge, cold round i at ridge * 10^i.
  eff_pow = torch.clamp(retries - (2.0 if warm else 1.0), min=0.0)
  eff_ridge = (ridge * torch.pow(10.0, eff_pow))[:, None, None]
  conditioned_root = root
  if eigvals is not None:
    # The deflated directions were solved at the smallest of the k
    # eigenvalues; put back the difference of their true inverse roots.
    diff = pth_root_difference(ridge[:, None],
                               eigvals.amin(dim=1, keepdim=True), eigvals, p)
    scaled = eigvecs * torch.sqrt(diff)[:, None, :]
    root = root - torch.bmm(scaled, scaled.transpose(1, 2))
    err = torch.bmm(mat_power(root, p), original + eff_ridge * eye) - eye
    error = _rowmax_abs(err * mask[:, :, None] * mask[:, None, :])

  is_padding = padding_starts.to(dev) == 0
  root = torch.where(is_padding[:, None, None], 0.0, root)
  error = torch.where(is_padding, 0.0, error)
  metrics = RootMetrics(error=error, iterations=iters, error_ratio=ratio,
                        max_eigenvalue=max_ev.to(f32), retries=retries)
  if generate_diagnostics:
    suppress = lambda x: torch.where(is_padding, 0.0, x)
    metrics.inverse_pth_root_diagnostics = InversePthRootDiagnostics.create(
        root, original + eff_ridge * eye, p, padding_starts).map(suppress)
    if eigvals is None:
      metrics.lobpcg = LOBPCGDiagnostics.zeros(n, dev)
      metrics.conditioned_inverse_pth_root_diagnostics = (
          InversePthRootDiagnostics.zeros(n, dev))
    else:
      # ``mat`` holds the deflated problem.
      metrics.lobpcg = lobpcg_report.map(suppress)
      metrics.conditioned_inverse_pth_root_diagnostics = (
          InversePthRootDiagnostics.create(
              conditioned_root, mat + eff_ridge * eye, p,
              padding_starts).map(suppress))
  return root.to(stats.dtype), metrics


def _eigh_roots(mat, eye, mask, padding_starts, p, ridge_epsilon,
                error_tolerance, relative_matrix_epsilon,
                generate_diagnostics):
  """The JAX package's `matrix_inverse_pth_root_eigh`, batched.

  ``mat`` and ``eye`` are masked to each member's size.  Eigenvalues are
  clamped at the ridge ``ridge_epsilon * max(lambda_max,
  error_tolerance)``, the padding's zero eigenvalues map to zero, and the
  root is ``R R^T`` with ``R = U sqrt(e^{-1/p})``, symmetric by
  construction.  The error is ``max |U^T (A + rI) U - diag(e)|``.
  """
  n, m, _ = mat.shape
  f32 = torch.float32
  if relative_matrix_epsilon:
    max_ev = power_iteration(mat, num_iters=100,
                             error_tolerance=error_tolerance,
                             padding_starts=padding_starts)[1]
  else:
    max_ev = torch.ones((n,), dtype=f32, device=mat.device)
  ridge = (ridge_epsilon * torch.clamp(max_ev, min=error_tolerance)
           )[:, None, None]
  regularized = mat + ridge * eye
  e, u = nan_safe(torch.linalg.eigh, regularized)
  # eigh sorts ascending: the padding's zero eigenvalues come first.
  flipped = mask.flip(-1)
  e = e * flipped
  inv_e = torch.where(e == 0.0, 0.0,
                      torch.pow(torch.maximum(e, ridge[:, :, 0]), -1.0 / p))
  sqrt_root = u * torch.sqrt(inv_e)[:, None, :]
  root = torch.bmm(sqrt_root, sqrt_root.transpose(1, 2))
  recovered = torch.bmm(u.transpose(1, 2), torch.bmm(regularized, u))
  eig_err = (recovered - torch.diag_embed(e)) * flipped[:, None, :]
  error = _rowmax_abs(eig_err)
  is_padding = padding_starts.to(mat.device) == 0
  root = torch.where(is_padding[:, None, None], 0.0, root)
  error = torch.where(is_padding, 0.0, error)
  zeros = torch.zeros((n,), dtype=f32, device=mat.device)
  metrics = RootMetrics(error=error, iterations=zeros, error_ratio=zeros,
                        max_eigenvalue=max_ev.to(f32), retries=zeros)
  if generate_diagnostics:
    diag = InversePthRootDiagnostics.create(root, regularized, p,
                                            padding_starts)
    metrics = metrics.fill(RootMetrics.zeros(n, detailed=True,
                                             device=mat.device))
    metrics.inverse_pth_root_diagnostics = diag.map(
        lambda x: torch.where(is_padding, 0.0, x))
  return root, metrics
