"""The Newton iteration's matmul chain with no control: Hopper kernel and plain twin.

Replaces the Pallas TPU kernel `benchmarks/pallas_tile_breakdown.py`
(`_matmul_only_kernel`, launched by `_matmul_only`) with a CUDA C++ kernel
written for ``sm_90a``, `csrc/matmul_chain.cu`.  It is a timing probe, not
part of the optimizer: for each member of a ``[N, m, m]`` batch it starts
from ``M = stats``, ``H = I`` and repeats ``iters`` times

    T = 1.25 I - 0.25 M;  M <- (T^p M) / max(max|T^p M|, 1e-30);  H <- H T

then returns ``H + M``.  These are the Newton step's products with no
masks, selects, exit tests or retry ladder.  The kernel makes them with the
Newton-root kernel's resident product code (`csrc/resident_gemm.cuh`), in
the Newton loop's order, so the difference of the two kernels' per-step
times is the Newton control's cost (`probes/tile_breakdown.py`).  Like the
resident path it takes ``m <= 128`` and p a power of two or one more.

Three entry points share one signature and one semantics:

* `matmul_chain_cuda` launches the kernel on a CUDA tensor;
* `matmul_chain_plain` is the chain in plain PyTorch (`torch.bmm` and
  `pth_root.mat_power`'s square-and-multiply order);
* `matmul_chain` dispatches on the tensor's device: a CPU tensor takes the
  twin, a CUDA tensor the kernel.  Nothing falls back.

`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.kernels import _build

# Largest matrix the kernel admits: three [128, 132] f32 buffers fill a
# block's shared memory.
MAX_M = 128

LAUNCHES = 0


def _check(stats: torch.Tensor, p: int, iters: int) -> None:
  """The kernel's rule, applied on every device."""
  if stats.dim() != 3 or stats.shape[1] != stats.shape[2]:
    raise ValueError(f"expected a [N, m, m] batch, got {tuple(stats.shape)}")
  m = stats.shape[-1]
  q = p - 1 if isinstance(p, int) and p > 1 and p % 2 else p
  if not (1 <= m <= MAX_M and isinstance(p, int) and p >= 1
          and q & (q - 1) == 0):
    raise ValueError(
        f"the matmul chain takes m <= {MAX_M} and p = 2^k or 2^k + 1 (the "
        f"Newton kernel's resident rule), got m={m}, p={p!r}")
  if not isinstance(iters, int) or iters < 0:
    raise ValueError(f"iters must be a non-negative int, got {iters!r}")


def matmul_chain_plain(stats: torch.Tensor, p: int, iters: int) -> torch.Tensor:
  """Plain-PyTorch twin of the kernel; see `matmul_chain`."""
  pth_root.require_true_f32()
  _check(stats, p, iters)
  n, m, _ = stats.shape
  eye = torch.eye(m, dtype=torch.float32, device=stats.device)
  mat_m = stats.to(torch.float32)
  mat_h = eye.expand(n, m, m)
  for _ in range(iters):
    mat_t = 1.25 * eye - 0.25 * mat_m
    new_m = torch.bmm(pth_root.mat_power(mat_t, p), mat_m)
    mat_h = torch.bmm(mat_h, mat_t)
    # amax and clamp propagate NaN, as jnp.max and jnp.maximum do.
    scale = new_m.abs().amax(dim=(1, 2), keepdim=True)
    mat_m = new_m / torch.clamp(scale, min=1e-30)
  return mat_h + mat_m


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
  lib = _build.load("matmul_chain")
  ptr, i32 = ctypes.c_void_p, ctypes.c_int
  lib.matmul_chain_launch.argtypes = [
      ptr, ptr,                 # stats, out
      i32, i32, i32, i32, i32,  # n, m, p, iters, grid
      ptr]                      # stream
  lib.matmul_chain_launch.restype = i32
  lib.matmul_chain_error_string.argtypes = [i32]
  lib.matmul_chain_error_string.restype = ctypes.c_char_p
  return lib


def matmul_chain_cuda(stats: torch.Tensor, p: int, iters: int) -> torch.Tensor:
  """Launches the Hopper kernel; see `matmul_chain`.

  Launches on the current stream and does not synchronise.
  """
  global LAUNCHES
  if not stats.is_cuda:
    raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {stats.device}")
  _check(stats, p, iters)
  if stats.dtype != torch.float32:
    raise TypeError(f"stats must be torch.float32, got {stats.dtype}")
  if not stats.is_contiguous():
    raise ValueError("stats must be contiguous")
  n, m, _ = stats.shape
  out = torch.empty_like(stats)
  if n == 0:
    return out
  lib = _library()
  dev = stats.device
  grid = min(n, torch.cuda.get_device_properties(dev).multi_processor_count)
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
  rc = lib.matmul_chain_launch(stats.data_ptr(), out.data_ptr(), n, m, p,
                               iters, grid, stream)
  if rc != 0:
    raise RuntimeError("matmul_chain kernel launch failed: "
                       + lib.matmul_chain_error_string(rc).decode())
  LAUNCHES += 1
  return out


def matmul_chain(stats: torch.Tensor, p: int, iters: int) -> torch.Tensor:
  """``iters`` renormalised Newton products of ``[N, m, m]`` f32 ``stats``.

  The arithmetic of the JAX package's `_matmul_only_kernel`: ``M = stats``,
  ``H = I``; each step ``T = 1.25 I - 0.25 M``, ``M <- T^p M /
  max(max|T^p M|, 1e-30)`` (NaN propagates), ``H <- H T``.  ``T`` keeps
  the JAX body's constants for every p.

  Args:
    stats: ``[N, m, m]`` float32, ``m <= 128``.
    p: 2^k or 2^k + 1; the T^p chain is square-and-multiply.
    iters: steps, ``>= 0``.

  A CPU tensor takes the plain twin, a CUDA tensor the kernel.

  Returns:
    ``H + M``, ``[N, m, m]`` float32.
  """
  if stats.is_cuda:
    return matmul_chain_cuda(stats, p, iters)
  if stats.device.type == "cpu":
    return matmul_chain_plain(stats, p, iters)
  raise ValueError(f"no matmul-chain implementation for {stats.device}")
