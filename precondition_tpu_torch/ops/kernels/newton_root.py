"""Batched coupled-Newton inverse p-th root: Hopper kernel and plain twin.

Replaces the Pallas TPU kernel `precondition_tpu/ops/pallas/newton_root.py`
(`_kernel`, launched by `batched_inverse_pth_root_pallas`) with a CUDA C++
kernel written for ``sm_90a``, `csrc/newton_root.cu`.  On the card the
kernel is bound by the f32 FMA rate of the CUDA cores: every Newton step is
a chain of dependent ``[m, m]`` products that must stay in true f32 (TF32
rounding breaks the coupled iteration's invariant, see the JAX package's
DESIGN.md on the retired mixed-precision ladder), so tensor cores are out.
One CTA solves one matrix at a time over a persistent grid, so every member
leaves its Newton loop and retry ladder on its own.  The C launcher picks
one of two paths from ``(m, p)`` (`kernel_path`):

* **resident** (``m <= 128`` and p a power of two or one more, the main
  path's p = 4 and 2 among them): the iterates stay in three shared-memory
  buffers of the CTA and never touch global memory inside the Newton loop;
  no workspace is allocated.  T is computed where a product reads it and a
  product's output waits in registers, so three buffers hold M, H and the
  one scratch such a p needs.  A fourth buffer does not fit, which caps it
  at m = 128 and at those p.
* **global** (every other ``(m, p)``, up to m = 1024): the iterates live in
  a per-CTA workspace in global memory, and the products stream them
  through shared memory; the source file says more.

Three entry points share one signature and one semantics:

* `batched_inverse_pth_root_cuda` launches the kernel on a CUDA tensor;
* `batched_inverse_pth_root_plain` is the same computation in plain
  PyTorch (batched `torch.bmm` with per-member masks), written from the
  Pallas `_kernel`;
* `batched_inverse_pth_root` dispatches on the tensor's device: a CPU
  tensor takes the twin, a CUDA tensor the kernel.  Nothing falls back.

`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.kernels import _build
from precondition_tpu_torch.ops.pth_root import RootMetrics

_LN10 = 2.302585092994046
# Largest matrix the kernel admits (the optimizer's default block size).
MAX_M = 1024
# CTAs per SM of the persistent grid.  The resident path's 202,752 B of
# shared memory admit one CTA per SM.  The global path uses 237 registers a
# thread (ptxas, sm_90a), so one 256-thread CTA fills an SM's register file
# there too; 1, 2 and 4 measured the same on an H100 80GB HBM3 at 700 W.
_CTAS_PER_SM = 1

LAUNCHES = 0


def _prepare(stats, p, padding_starts, prevs, max_evs,
             relative_matrix_epsilon):
  """The JAX wrapper's argument handling, shared by kernel and twin."""
  if stats.dim() != 3 or stats.shape[1] != stats.shape[2]:
    raise ValueError(f"expected a [N, m, m] batch, got {tuple(stats.shape)}")
  n, m, _ = stats.shape
  if not 1 <= m <= MAX_M:
    raise ValueError(f"matrix size {m} outside [1, {MAX_M}]")
  if not isinstance(p, int) or p < 1:
    raise ValueError(f"p must be a positive int, got {p!r}")
  if padding_starts is None:
    padding_starts = torch.full((n,), m, dtype=torch.int32,
                                device=stats.device)
  # Warm starts need an even exponent (C = prev^{p/2}); odd p solves cold.
  if prevs is not None and p % 2:
    prevs = None
  if relative_matrix_epsilon and max_evs is None:
    # Loose 1% exit: the estimate only scales the ridge, power iteration
    # converges from below, and the retry ladder guards the rare member
    # that needs a larger ridge.
    max_evs = pth_root.power_iteration(
        stats, padding_starts=padding_starts, error_tolerance=1e-2,
        relative_tolerance=True)[1]
  if max_evs is None:
    max_evs = torch.zeros((n,), dtype=torch.float32, device=stats.device)
  return padding_starts, prevs, max_evs


def batched_inverse_pth_root_plain(
    stats: torch.Tensor,
    p: int,
    padding_starts: Optional[torch.Tensor] = None,
    *,
    prevs: Optional[torch.Tensor] = None,
    max_evs: Optional[torch.Tensor] = None,
    num_iters: int = 100,
    ridge_epsilon: float = 1e-6,
    error_tolerance: float = 1e-6,
    relative_matrix_epsilon: bool = True,
    warm_error_threshold: float = 0.05,
    retry_loop_error_threshold: float = 0.05,
    num_tries: int = 6,
    max_error_ratio: float = 1.2,
) -> Tuple[torch.Tensor, RootMetrics]:
  """Plain-PyTorch twin of the kernel; see `batched_inverse_pth_root`."""
  pth_root.require_true_f32()
  padding_starts, prevs, max_evs = _prepare(
      stats, p, padding_starts, prevs, max_evs, relative_matrix_epsilon)
  n, m, _ = stats.shape
  dev = stats.device
  f32 = torch.float32
  mask = pth_root._padding_mask(m, padding_starts, f32, dev)  # [N, m]
  valid = mask[:, :, None] * mask[:, None, :]
  eye = torch.diag_embed(mask)

  def rowmax(x):  # [N, m, m] -> [N, 1, 1]; propagates NaN like jnp.max
    return x.amax(dim=(1, 2), keepdim=True)

  mat = stats.to(f32) * valid
  if relative_matrix_epsilon:
    max_ev = max_evs.to(f32).reshape(n, 1, 1)
  else:
    max_ev = torch.ones((n, 1, 1), dtype=f32, device=dev)
  ridge = ridge_epsilon * torch.clamp(max_ev, min=1e-25)
  pf = float(p)
  inv_p = 1.0 / pf

  warm = prevs is not None
  if warm:
    prev = prevs.to(f32) * valid
    cmc, cc = pth_root.warm_start_products(mat, prev, p)
    total_rounds = num_tries + 1
  else:
    total_rounds = num_tries

  def newton(m0, h0, err0, active):
    mat_m, mat_h, error = m0, h0, err0
    iters = torch.zeros_like(err0)
    for _ in range(num_iters):
      if not bool(active.any()):
        break
      new_m, new_h = pth_root.newton_step(mat_m, mat_h, eye, p)
      new_error = rowmax((new_m - eye).abs())
      ratio = new_error / torch.clamp(error, min=1e-30)
      # A divergent step is rejected: (H, error) keep the last good pair.
      step_ok = active & (ratio < max_error_ratio)
      mat_m = torch.where(step_ok, new_m, mat_m)
      mat_h = torch.where(step_ok, new_h, mat_h)
      error = torch.where(step_ok, new_error, error)
      iters = iters + step_ok.to(f32)
      active = step_ok & (error > error_tolerance)
    return mat_h, error, iters

  root = torch.zeros((n, m, m), dtype=f32, device=dev)
  k11 = torch.zeros((n, 1, 1), dtype=f32, device=dev)
  error, iters, retries = k11 + 1000.0, k11.clone(), k11.clone()
  failed = torch.ones((n, 1, 1), dtype=torch.bool, device=dev)
  warm_final = torch.zeros_like(failed)
  for rnd in range(total_rounds):
    if not bool(failed.any()):
      break
    expo = max(rnd - 1, 0) if warm else rnd
    ridge_i = ridge * torch.exp(torch.tensor(float(expo), dtype=f32) * _LN10)
    damped = mat + ridge_i * eye
    fro = torch.sqrt((damped * damped).sum(dim=(1, 2), keepdim=True))
    z = (1.0 + pf) / (2.0 * torch.clamp(fro, min=1e-30))
    m0 = damped * z
    h0 = eye * torch.exp(torch.log(z) * inv_p)
    use_warm = torch.zeros_like(failed)
    if warm:
      m0_w = cmc + ridge_i * cc
      bound = m0_w.abs().sum(dim=2, keepdim=True).amax(dim=1, keepdim=True)
      z_w = torch.clamp((1.0 + pf) / (2.0 * torch.clamp(bound, min=1e-30)),
                        max=1.0)
      err0_w = rowmax((m0_w * z_w - eye).abs())
      use_warm = (err0_w <= warm_error_threshold) & (rnd == 0)
      m0 = torch.where(use_warm, m0_w * z_w, m0)
      h0 = torch.where(use_warm, prev * torch.exp(torch.log(z_w) * inv_p), h0)
    err0 = rowmax((m0 - eye).abs())
    mat_h, n_error, n_iters = newton(m0, h0, err0,
                                     failed & (err0 > error_tolerance))
    # Only members that entered this round adopt its results.
    root = torch.where(failed, mat_h, root)
    error = torch.where(failed, n_error, error)
    iters = torch.where(failed, n_iters, iters)
    retries = retries + failed.to(f32)
    warm_final = torch.where(failed, use_warm, warm_final)
    failed = failed & (error > retry_loop_error_threshold)

  # The cold principal root is symmetric up to rounding; a warm root is
  # symmetrised only where the warm round was taken.
  sym = 0.5 * (root + root.transpose(1, 2))
  root = torch.where(warm_final, sym, root) if warm else sym
  is_padding = (padding_starts.reshape(n, 1, 1) == 0).to(dev)
  root = torch.where(is_padding, 0.0, root * valid)
  error = torch.where(is_padding, 0.0, error)
  metrics = RootMetrics(
      error=error.reshape(n),
      iterations=iters.reshape(n),
      error_ratio=torch.zeros((n,), dtype=f32, device=dev),
      max_eigenvalue=max_ev.reshape(n),
      retries=retries.reshape(n))
  return root.to(stats.dtype), metrics


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
  lib = _build.load("newton_root")
  ptr, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
  lib.newton_root_launch.argtypes = [
      ptr, ptr, ptr, ptr,            # stats, pads, max_evs, prevs
      ptr, ptr, ptr, ptr, ptr, ptr,  # roots, errors, iters, retries, maxev, ws
      i32, i32, i32, i32, i32,       # n, m, p, grid, num_iters
      f, f, i32, f, f, i32, f,       # ridge, tol, relative, warm, retry, tries, ratio
      ptr]                           # stream
  lib.newton_root_launch.restype = i32
  lib.newton_root_workspace_buffers.argtypes = [i32, i32]  # m, p
  lib.newton_root_workspace_buffers.restype = i32
  lib.newton_root_error_string.argtypes = [i32]
  lib.newton_root_error_string.restype = ctypes.c_char_p
  return lib


def kernel_path(m: int, p: int) -> str:
  """Which path of the kernel solves ``[N, m, m]`` at exponent p: "resident"
  (no global workspace) or "global".  Builds the kernel on first use."""
  return "global" if _library().newton_root_workspace_buffers(m, p) else "resident"


def _check_operand(name, x, shape, dtype, device):
  if x.device != device:
    raise ValueError(f"{name} is on {x.device}, stats on {device}")
  if x.dtype != dtype:
    raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
  if tuple(x.shape) != tuple(shape):
    raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
  if not x.is_contiguous():
    raise ValueError(f"{name} must be contiguous")


def batched_inverse_pth_root_cuda(
    stats: torch.Tensor,
    p: int,
    padding_starts: Optional[torch.Tensor] = None,
    *,
    prevs: Optional[torch.Tensor] = None,
    max_evs: Optional[torch.Tensor] = None,
    num_iters: int = 100,
    ridge_epsilon: float = 1e-6,
    error_tolerance: float = 1e-6,
    relative_matrix_epsilon: bool = True,
    warm_error_threshold: float = 0.05,
    retry_loop_error_threshold: float = 0.05,
    num_tries: int = 6,
    max_error_ratio: float = 1.2,
) -> Tuple[torch.Tensor, RootMetrics]:
  """Launches the Hopper kernel; see `batched_inverse_pth_root`.

  Launches on the current stream and does not synchronise.
  """
  global LAUNCHES
  if not stats.is_cuda:
    raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {stats.device}")
  padding_starts, prevs, max_evs = _prepare(
      stats, p, padding_starts, prevs, max_evs, relative_matrix_epsilon)
  n, m, _ = stats.shape
  dev = stats.device
  _check_operand("stats", stats, (n, m, m), torch.float32, dev)
  _check_operand("padding_starts", padding_starts, (n,), torch.int32, dev)
  _check_operand("max_evs", max_evs, (n,), torch.float32, dev)
  if prevs is not None:
    _check_operand("prevs", prevs, (n, m, m), torch.float32, dev)

  roots = torch.empty_like(stats)
  errors, iters, retries, maxevs = torch.empty(
      (4, n), dtype=torch.float32, device=dev)
  metrics = RootMetrics(error=errors, iterations=iters,
                        error_ratio=torch.zeros_like(errors),
                        max_eigenvalue=maxevs, retries=retries)
  if n == 0:
    return roots, metrics
  lib = _library()
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  grid = min(n, sms * _CTAS_PER_SM)
  # Only the global path has a workspace.  Allocated on the stream the
  # kernel runs on: once the tensor dies on return, the caching allocator
  # reuses its memory (and that of the operands `_prepare` made) only for
  # work queued after the kernel there.
  buffers = lib.newton_root_workspace_buffers(m, p)
  workspace = torch.empty(grid * buffers * m * m, dtype=torch.float32,
                          device=dev) if buffers else None
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
  rc = lib.newton_root_launch(
      stats.data_ptr(), padding_starts.data_ptr(), max_evs.data_ptr(),
      None if prevs is None else prevs.data_ptr(),
      roots.data_ptr(), errors.data_ptr(), iters.data_ptr(),
      retries.data_ptr(), maxevs.data_ptr(),
      None if workspace is None else workspace.data_ptr(),
      n, m, p, grid, num_iters,
      ridge_epsilon, error_tolerance, int(bool(relative_matrix_epsilon)),
      warm_error_threshold, retry_loop_error_threshold, num_tries,
      max_error_ratio, stream)
  if rc != 0:
    raise RuntimeError("newton_root kernel launch failed: "
                       + lib.newton_root_error_string(rc).decode())
  LAUNCHES += 1
  return roots, metrics


def batched_inverse_pth_root(stats: torch.Tensor, p: int,
                             padding_starts: Optional[torch.Tensor] = None,
                             **kwargs) -> Tuple[torch.Tensor, RootMetrics]:
  """``(A + r I)^{-1/p}`` for every member of a ``[N, m, m]`` PSD batch.

  ``r = ridge_epsilon * max(lambda_max, 1e-25)`` (``lambda_max = 1`` when
  not ``relative_matrix_epsilon``).  Semantics of the JAX package's
  `batched_inverse_pth_root_pallas`:

  * coupled Newton from ``M0 = z (A + rI)``, ``H0 = z^{1/p} I``; each member
    stops at error ``<= error_tolerance`` or after ``num_iters`` steps, and
    a step whose error ratio is ``>= max_error_ratio`` is rejected;
  * members whose error stays above ``retry_loop_error_threshold`` retry
    with the ridge x10, ``num_tries`` rounds in all;
  * with ``prevs`` and an even p, round 0 first tries the certified warm
    start ``C (A + rI) C``, ``C = prev^{p/2}`` (one extra round); prevs
    are ignored for odd p;
  * ``max_evs`` omitted: one batched power iteration with a loose 1%
    relative exit supplies them;
  * ``padding_starts`` gives each member's valid size; padding rows and
    columns of the roots are zero, and a member of size 0 is all zeros
    with error 0.

  Args mirror `batched_inverse_pth_root_cuda`.  A CPU tensor takes the
  plain twin, a CUDA tensor the kernel.

  Returns:
    ``(roots [N, m, m], RootMetrics with [N] fields)``.
  """
  if stats.is_cuda:
    return batched_inverse_pth_root_cuda(stats, p, padding_starts, **kwargs)
  if stats.device.type == "cpu":
    return batched_inverse_pth_root_plain(stats, p, padding_starts, **kwargs)
  raise ValueError(f"no Newton-root implementation for {stats.device}")

