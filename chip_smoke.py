"""Drives the PyTorch port's main path on one CUDA GPU and checks it.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  (a) build the Newton-root and matmul-chain kernels from
      precondition_tpu_torch/csrc with nvcc, one nvcc each, started
      together; check that ptxas reports no spills in either, and that the
      resident Newton kernel keeps its registers (RESIDENT_REGISTERS);
  (b) hold the Newton kernel against its plain-PyTorch twin on the card at the
      optimizer's shapes ([6144,128,128] p=4 and [32,128,128] p=2, the
      kernel's shared-memory-resident path): cold, warm (with garbage warm
      starts that must fall back to cold), mixed padding, and an
      ill-conditioned batch that drives the retry ladder; then the global-
      workspace path on a [64,256,256] p=4 cold batch; roots, ladder rounds
      and iterations are compared, the true residual is checked in float64
      on the host, and kernel and twin are timed beside the kernel's bound;
      then the matmul-chain kernel against its twin at [6144,128,128] p=4,
      8 steps, timed beside its bound; then the per-matrix solvers ("xla",
      eigh, LOBPCG-deflated with k = 4) timed at [6144,128,128] p=4;
  (c) five `distributed_shampoo` updates on the 58.7M-parameter
      transformer-shaped tree of the JAX package's bench.py (4 layers,
      d=1024, ff=4096, vocab 8192, block 128, RMSProp grafting), counting
      kernel launches, plus the same optimizer on the GPU against its CPU
      path on small trees: the default one, ragged ones under the
      quantized, eigh, "xla" and detailed-metrics option sets, and blocks
      of 128 under compression +-32, FD (plain, with reset, with
      average_grad, with FD metrics), LOBPCG k=2 and a mixed-size FD tree;
      and a [1100, 8] param at block 2048, above the kernel's limit;
  (c2) the same five updates with best_effort_memory_usage_reduction
      (int8 momenta, int16 per-block statistics and roots): two launches a
      step, every root accepted, each step's update within 0.1 relative
      Frobenius of (c)'s, the state's bytes within 0.1% of the JAX
      package's shape count; step times, peak memory and the host cost of
      decoding and encoding the per-block state;
  (c3) Sketchy: two updates of the same fixture with frequent_directions
      and compression_rank=32 (every block of 128 compresses): no Newton
      launch, every FD error 0, state bytes within 0.1% of the JAX count,
      64 sampled members of the last step's solve re-solved on the host
      and compared as operators; step times and peak memory (no profiled
      step: parsing its host events took most of the phase); then the
      compressed solves' library calls timed (QR, each of cuSOLVER's SVD
      algorithms, eigh);
  (c4) the same with low-rank roots (compression_rank=32 alone), two
      updates, every root accepted by the failure gate;
  (g) SM3 on the same fixture, 5 updates: finite, state bytes within 0.1%
      of the JAX count, step times and peak memory; and the card against
      the CPU path on a small tree;
  (h) tearfree blocked Shampoo on the same fixture with the JAX package's
      benchmarks/tearfree_backend_trajectory.py options at block 128, roots
      every step from step 0: "filtered" (what "auto" picks on the card) 5
      updates and "newton" 5, each launching the Newton kernel 32 times a
      step (one per param and axis), and "eigh" 2; 64 sampled blocks of the
      last solves held to float64 on the host (Newton roots to their true
      residual, filtered roots to an eigh root with the 1e-6 clip); state
      bytes against the JAX count; step times and peak memory; one more
      filtered and one more newton step under torch.profiler (host ms of
      the statistics, roots and preconditioning scopes, kernel ms); and
      every backend and Sketchy on the card against the CPU path on a
      small tree;
  (i) tearfree Sketchy at rank 128 on the same fixture, 2 updates: finite,
      state bytes against the JAX count, step times and peak memory;
  (d) `DistributedShampoo` training a width-1024 least-squares model;
  (e) the tile-breakdown probe (precondition_tpu_torch.probes.tile_breakdown)
      at the JAX script's [712,128,128] p=4 and at the main path's
      [6144,128,128] p=4, each JSON on its own line, counting launches;
  (j) distribution on the one card, ranks spawned after (a) built the
      kernels (`parallel.local.run_local_ranks`), which load the built
      libraries: (j1) `batch_axis_name` over 2 gloo ranks, 3 steps on the
      bench fixture, each rank launching the Newton kernel on its half of
      each exponent group (16 and 3,072 members), every root accepted,
      updates and roots against a one-process run of the same fixture;
      the same over 1 NCCL rank, 3 steps; (j2) `shard_optimizer_states`
      over a mesh of 2 gloo ranks, 3 steps: each rank's statistics and
      roots half of JAX's global 809,500,672 B, updates and gathered roots
      against a one-rank sharded run; step times per rank, and the peak
      memory of each rank's updates beside the bytes it held before them;
  (k) the LM of precondition_tpu_torch/models/transformer.py at
      bench.py's widths (4 layers, d=1024, 16 heads, ff 4096, vocab 8192;
      68,166,656 parameters, bf16 activations, remat) trained 6 steps on
      one seeded [8, 1025] batch through train.loop.make_train_step and
      distributed_shampoo (block 128, RMSProp grafting, roots every step):
      finite, falling loss; 2 Newton launches a step (72 members at p=2,
      6,272 at p=4), every root accepted; medians of steps 2-6 of the
      step, forward+backward and the optimizer's update, tokens/s,
      train_mfu and the peak; one more step under torch.profiler (the
      optimizer scopes' host ms, kernel ms, the largest kernels);
      decode_step at 8 positions against forward; and a small LM (2
      layers, d=128, block 32, f32) 3 steps on the card against the CPU
      path;
  (k2) the LM's data-parallel train step at 2 layers (f32 activations)
      over 2 gloo ranks on the one card, then 1 NCCL rank, under
      batch_axis_name and under shard_optimizer_states, 2 steps each:
      losses and each step's parameter change against one process on the
      full batch;
  (f) the card's name, power limit and TF32 setting.
Each phase's seconds are printed on a line of their own ("phase (x) took
N s").  The line before the last is nvidia-smi's name and power limit, a
line before it the kernels' JSON record, and the last line
{"ok": true, "device": {...}}.
"""

import concurrent.futures
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from precondition_tpu_torch.models import transformer
from precondition_tpu_torch.ops import lowrank
from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.kernels import _build
from precondition_tpu_torch.ops.kernels import matmul_chain
from precondition_tpu_torch.ops.kernels import newton_root
from precondition_tpu_torch.optim import shampoo
from precondition_tpu_torch.optim import sm3
from precondition_tpu_torch.parallel import local
from precondition_tpu_torch.parallel import mesh
from precondition_tpu_torch.probes import tile_breakdown
from precondition_tpu_torch.tearfree import grafting as tf_grafting
from precondition_tpu_torch.tearfree import momentum as tf_momentum
from precondition_tpu_torch.tearfree import optimizer as tf_optimizer
from precondition_tpu_torch.tearfree import second_order as tf_second_order
from precondition_tpu_torch.tearfree import shampoo as tf_shampoo
from precondition_tpu_torch.tearfree import sketchy as tf_sketchy
from precondition_tpu_torch.train import loop
from precondition_tpu_torch.utils import shapes as shape_utils
from precondition_tpu_torch.utils.quantization import QuantizedValue

KERNELS = ("newton_root", "matmul_chain")
SOURCES = {k: f"precondition_tpu_torch/csrc/{k}.cu" for k in KERNELS}
REPLACES = {
    "newton_root": "precondition_tpu/ops/pallas/newton_root.py:148",
    "matmul_chain": "benchmarks/pallas_tile_breakdown.py:86",
}
# ptxas' registers for the resident Newton kernel (sm_90a, CUDA 12.8) when
# its products moved into csrc/resident_gemm.cuh; a change shows here first.
RESIDENT_REGISTERS = 242
# Steps of the matmul chain in phase (b): the probe's first budget.
CHAIN_ITERS = 8
# Tolerances of kernel against twin: the JAX package's own kernel test
# (tests/test_pallas_kernels.py:59).  Both are f32 with sums in other orders.
RTOL, ATOL = 1e-3, 1e-5
# The H100 SXM's published f32 FMA rate outside the tensor cores and its
# memory rate (NVIDIA's data sheet, 700 W).
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# The JAX package's bench.py HYPERS, with its RMSProp grafting.
HYPERS = dict(learning_rate=0.1, block_size=128, beta1=0.9, beta2=0.999,
              matrix_epsilon=1e-6, start_preconditioning_step=0,
              statistics_compute_steps=1,
              graft_type=shampoo.GraftingType.RMSPROP)


def check(ok, message):
  if not ok:
    raise RuntimeError(message)


def log(*args):
  print(*args, flush=True)


def psd_batch(gen, n, m, device, ridge=0.1):
  a = torch.randn(n, m, m, generator=gen, device=device)
  eye = torch.eye(m, device=device)
  return torch.bmm(a, a.transpose(1, 2)) / m + ridge * eye


def zero_padding(stats, pads):
  mask = pth_root._padding_mask(stats.shape[-1], pads, stats.dtype,
                                stats.device)
  return stats * mask[:, :, None] * mask[:, None, :]


def residual_check(stats, pads, p, metrics, relative, floor=1e-3):
  """Returns ``roots -> (residual, bound)``: per member max|H^p (A + r I) - I|
  in float64 on the host, and the f32 bound 100 * eps * p * cond(A + r I)
  (at least ``floor``), r the ridge of the ladder round that produced the
  root.  Members of size 0 get an infinite bound."""
  m = stats.shape[-1]
  mask = pth_root._padding_mask(m, pads.cpu(), torch.float64)
  eye = torch.diag_embed(mask)
  scale = metrics.max_eigenvalue.double().cpu() if relative else 1.0
  ridge = 1e-6 * scale * 10.0 ** torch.clamp(
      metrics.retries.double().cpu() - 1.0, min=0.0)
  d = stats.double().cpu() + ridge[:, None, None] * eye
  # A diagonal entry lies inside the spectrum, so writing one on the
  # padding diagonal leaves the valid corner's condition number unchanged.
  ev = torch.linalg.eigvalsh(d + torch.diag_embed(1.0 - mask) * d[:, :1, :1])
  cond = ev[:, -1] / ev[:, 0]
  bound = torch.where(pads.cpu() > 0,
                      torch.clamp(100 * 1.2e-7 * p * cond, min=floor),
                      torch.inf)

  def residual(roots):
    hp = pth_root.mat_power(roots.double().cpu(), p)
    return (hp @ d - eye).abs().amax(dim=(1, 2)), bound

  return residual


def newton_bound_ms(n, m, p, mean_iters):
  """The least time the card could take for ``n`` members of mean
  ``mean_iters`` Newton steps (accepted steps for the Newton kernel, all
  steps for the matmul chain): each step is the square-and-multiply chain
  for T^p, T^p M and H T, 2 m^3 FLOP a product at the f32 FMA peak, against
  reading the input once and writing the output once.
  Returns (ms, "operations" or "bytes")."""
  products = tile_breakdown.products_per_step(p)
  ops_ms = 1e3 * n * mean_iters * products * 2 * m ** 3 / PEAK_F32_FLOPS
  bytes_ms = 1e3 * 2 * n * m * m * 4 / PEAK_BYTES_S
  return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def cuda_ms(fn, reps):
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def compare(name, stats, p, pads=None, prevs=None, max_evs=None,
            relative=True, elementwise=slice(None)):
  """Kernel against twin on one batch; returns (max |roots diff| over the
  ``elementwise`` members, kernel roots, kernel metrics).

  Roots of the ``elementwise`` members are held to the twin's at RTOL and
  ATOL; every member's true residual is held to its f32 bound.
  A warm root is ``prev (z C (A + rI) C)^{-1/p}``, C = prev^{p/2}, which is
  the true root only as far as prev commutes with A; the warm certificate
  admits starts with |z C (A + rI) C - I| <= 0.05, so warm roots are held
  to a true residual of 0.05 at most.
  """
  kw = dict(prevs=prevs, max_evs=max_evs, relative_matrix_epsilon=relative)
  r_k, m_k = newton_root.batched_inverse_pth_root_cuda(stats, p, pads, **kw)
  r_p, m_p = newton_root.batched_inverse_pth_root_plain(stats, p, pads, **kw)
  torch.cuda.synchronize()
  diff = (r_k[elementwise] - r_p[elementwise]).abs().max().item()
  check(bool(torch.isfinite(r_k).all()), f"{name}: non-finite kernel roots")
  check(torch.allclose(r_k[elementwise], r_p[elementwise], rtol=RTOL,
                       atol=ATOL),
        f"{name}: roots differ from the twin by up to {diff}")
  check(torch.equal(m_k.retries, m_p.retries),
        f"{name}: ladder rounds differ from the twin")
  it_diff = (m_k.iterations - m_p.iterations).abs().max().item()
  check(it_diff <= 1, f"{name}: iterations differ by {it_diff}")
  if pads is None:
    pads = torch.full((stats.shape[0],), stats.shape[-1], dtype=torch.int32)
  residual = residual_check(stats, pads, p, m_k, relative,
                            floor=1e-3 if prevs is None else 0.05)
  for label, r in (("kernel", r_k), ("twin", r_p)):
    resid, bound = residual(r)
    worst = (resid / bound).max().item()
    check(worst < 1.0, f"{name}: {label} true residual over its bound "
          f"(max resid/bound {worst})")
  log(f"  {name} ({newton_root.kernel_path(stats.shape[-1], p)} path): "
      f"N={stats.shape[0]} m={stats.shape[-1]} p={p} "
      f"max|kernel-twin|={diff:.3e} iterations mean "
      f"{m_k.iterations.mean().item():.2f} max {m_k.iterations.max().item():.0f}"
      f" (|diff| <= {it_diff:.0f}), retries max {m_k.retries.max().item():.0f}, "
      f"error max {m_k.error.max().item():.3e}, "
      f"f64 residual max {resid.max().item():.3e}")
  return diff, r_k, m_k


def phase_build():
  log("(a) build")
  start = time.perf_counter()
  # One nvcc for each source, all started together.
  with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
    built = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
  log(f"  both built in {time.perf_counter() - start:.1f} s with the hash "
      "check")
  registers = {}
  for name, lib in built.items():
    log(f"  {SOURCES[name]} -> {lib.path.name}: nvcc "
        f"{' '.join(_build.NVCC_FLAGS)} took {lib.seconds:.1f} s")
    spills, entry = 0, None
    for line in lib.log.splitlines():
      if "entry function" in line or "registers" in line or "spill" in line:
        log("  ptxas: " + line.strip())
      match = re.search(r"entry function '([^']+)'", line)
      if match:
        entry = match.group(1)
      match = re.search(r"Used (\d+) registers", line)
      if match:
        registers[entry] = int(match.group(1))
      match = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
      if match:
        spills += int(match.group(1)) + int(match.group(2))
    if lib.log:  # empty when the library was built by an earlier run
      check(spills == 0, f"ptxas reports {spills} bytes of spills in {name}")
  if built["newton_root"].log:
    resident = [r for e, r in registers.items() if "newton_root_resident" in e]
    check(resident == [RESIDENT_REGISTERS],
          f"the resident Newton kernel uses {resident} registers, expected "
          f"{RESIDENT_REGISTERS}")
  return {name: lib.seconds for name, lib in built.items()}


def phase_kernel(device, n4=6144, n2=32, m=128, n_ill=512):
  log("(b) kernel against its twin on the card")
  gen = torch.Generator(device=device).manual_seed(0)
  diffs = []
  stats4 = psd_batch(gen, n4, m, device)
  stats2 = psd_batch(gen, n2, m, device)
  # The optimizer's power iteration supplies lambda_max on the main path.
  ev4 = pth_root.power_iteration(stats4, error_tolerance=1e-2,
                                 relative_tolerance=True)[1]
  ev2 = pth_root.power_iteration(stats2, error_tolerance=1e-2,
                                 relative_tolerance=True)[1]
  d, cold4, _ = compare("cold p=4", stats4, 4, max_evs=ev4)
  diffs.append(d)
  d, cold2, _ = compare("cold p=2", stats2, 2, max_evs=ev2)
  diffs.append(d)

  # Warm: the statistics drift by 0.1%, the previous roots start the
  # solve; the first g members get a garbage previous root, which the
  # warm certificate must reject, falling back to the cold solve.
  for p, stats, cold, n in ((4, stats4, cold4, n4), (2, stats2, cold2, n2)):
    g = min(16, n // 2)
    drifted = 0.999 * stats + 0.001 * psd_batch(gen, n, m, device)
    prevs = cold.clone()
    prevs[:g] = 100.0 * torch.randn(g, m, m, generator=gen, device=device)
    ev = pth_root.power_iteration(drifted, error_tolerance=1e-2,
                                  relative_tolerance=True)[1]
    d, warm_roots, warm_met = compare(f"warm p={p}", drifted, p, prevs=prevs,
                                      max_evs=ev)
    diffs.append(d)
    cold_roots, cold_met = newton_root.batched_inverse_pth_root_cuda(
        drifted, p, max_evs=ev)
    check(torch.allclose(warm_roots[:g], cold_roots[:g], rtol=RTOL,
                         atol=ATOL),
          f"warm p={p}: garbage warm starts did not fall back to cold")
    check(bool(warm_met.iterations[g:].mean()
               < cold_met.iterations[g:].mean()),
          f"warm p={p}: warm starts took no fewer iterations than cold")
    log(f"  warm p={p}: iterations mean {warm_met.iterations[g:].mean():.2f}"
        f" warm vs {cold_met.iterations[g:].mean():.2f} cold; the {g} "
        "garbage warm starts equal the cold solve")

  # Mixed padding_starts, including 0 (a pure-padding member).
  sizes = torch.tensor([m, 3 * m // 4, m // 2, m // 8 + 1, 1, 0],
                       dtype=torch.int32, device=device)
  pads = sizes.repeat(n4 // len(sizes) + 1)[:n4].contiguous()
  padded = zero_padding(stats4, pads)
  ev = pth_root.power_iteration(padded, padding_starts=pads,
                                error_tolerance=1e-2,
                                relative_tolerance=True)[1]
  d, roots, met = compare("padded p=4", padded, 4, pads=pads, max_evs=ev)
  diffs.append(d)
  zero = pads == 0
  check(bool((roots[zero] == 0).all()) and bool((met.error[zero] == 0).all()),
        "padded p=4: a pure-padding member is not all zeros")

  # Ill-conditioned, absolute ridge 1e-6 (relative_matrix_epsilon=False),
  # as the JAX package's ladder test builds it: healthy members beside
  # ill-conditioned ones.  A quarter are healthy; 3/8 have cond 1e6
  # (spectrum 1e3 .. 1e-3); 3/8 are rank-m/8 Grams with eigenvalues 3e4,
  # whose solve fails while cond(A + rI) >= 3e7 and converges from 3e6 on
  # (the fifth round): the ladder escalates, and its rounds sit a factor 3
  # from f32's edge near 1e7 on either side, so kernel and twin take the
  # same rounds.  Two f32 solves at cond >= 1e6 agree only to rounding
  # amplified by the conditioning (0.11 apart at most on roots of spectral
  # norm 5.6, on an H100 80GB HBM3 at 700 W), so, as in the JAX package's `test_retry_ladder_ill_conditioned`,
  # only the healthy members' roots are held to the twin's; the others are
  # held to their f64 true residual bound, ladder rounds and iterations.
  n_ok, n_cond = n_ill // 4, 3 * n_ill // 8
  q, _ = torch.linalg.qr(torch.randn(n_ill, m, m, generator=gen,
                                     device=device, dtype=torch.float64))
  spectrum = torch.zeros(n_ill, m, dtype=torch.float64, device=device)
  spectrum[n_ok:n_ok + n_cond] = 1e3 * torch.logspace(
      0, -6, m, device=device, dtype=torch.float64)
  spectrum[n_ok + n_cond:, :m // 8] = 3e4
  ill = ((q * spectrum[:, None, :]) @ q.transpose(1, 2)).float()
  ill[:n_ok] = psd_batch(gen, n_ok, m, device)
  d, _, met = compare("ill-conditioned p=4", ill.contiguous(), 4,
                      relative=False, elementwise=slice(0, n_ok))
  diffs.append(d)
  check(bool((met.retries[:n_ok] == 1).all()),
        "ill-conditioned p=4: a healthy member escalated its ridge")
  check(bool((met.retries[n_ok + n_cond:] > 1).all()),
        "ill-conditioned p=4: the ladder did not escalate")
  check(bool((met.error < 0.05).all()),
        "ill-conditioned p=4: a member did not converge within the ladder")

  # The global-workspace path, which takes every m above 128.
  n_g, m_g = 64, 2 * m
  check(newton_root.kernel_path(m, 4) == "resident"
        and newton_root.kernel_path(m, 2) == "resident"
        and newton_root.kernel_path(m_g, 4) == "global",
        "the kernel paths are not the ones the main path should take")
  stats_g = psd_batch(gen, n_g, m_g, device)
  ev_g = pth_root.power_iteration(stats_g, error_tolerance=1e-2,
                                  relative_tolerance=True)[1]
  d, _, _ = compare("cold p=4", stats_g, 4, max_evs=ev_g)
  diffs.append(d)

  timings = {}
  for name, stats, p, ev in (
      (f"[{n4},{m},{m}] p=4", stats4, 4, ev4),
      (f"[{n2},{m},{m}] p=2", stats2, 2, ev2),
      (f"[{n_g},{m_g},{m_g}] p=4", stats_g, 4, ev_g)):
    run_k = lambda: newton_root.batched_inverse_pth_root_cuda(
        stats, p, max_evs=ev)
    run_p = lambda: newton_root.batched_inverse_pth_root_plain(
        stats, p, max_evs=ev)
    iters = run_k()[1].iterations.mean().item()
    run_p()
    # Plain, kernel, kernel, plain on one card.
    t_p = [cuda_ms(run_p, 3)]
    t_k = [cuda_ms(run_k, 3), cuda_ms(run_k, 3)]
    t_p.append(cuda_ms(run_p, 3))
    kernel_ms, plain_ms = float(np.mean(t_k)), float(np.mean(t_p))
    bound_ms, bound_by = newton_bound_ms(stats.shape[0], stats.shape[-1], p,
                                         iters)
    path = newton_root.kernel_path(stats.shape[-1], p)
    timings[name] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, mean_iters=iters, path=path)
    log(f"  time {name} cold ({path} path, {iters:.2f} mean iterations): "
        f"kernel {t_k} ms, twin {t_p} ms, bound {bound_ms:.3f} ms "
        f"({bound_by}), {100 * bound_ms / kernel_ms:.1f}% of the bound")
  solvers = solver_timings(stats4, timings[f"[{n4},{m},{m}] p=4"]["ms"])
  return max(diffs), timings, chain_check(stats4, 4), solvers


def chain_check(stats, p, iters=CHAIN_ITERS):
  """The matmul-chain kernel against its twin on ``stats`` and both timed,
  plain, kernel, kernel, plain."""
  run_k = lambda: matmul_chain.matmul_chain_cuda(stats, p, iters)
  run_p = lambda: matmul_chain.matmul_chain_plain(stats, p, iters)
  got, want = run_k(), run_p()
  torch.cuda.synchronize()
  diff = (got - want).abs().max().item()
  check(bool(torch.isfinite(got).all()), "matmul chain: non-finite output")
  check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
        f"matmul chain: differs from the twin by up to {diff}")
  t_p = [cuda_ms(run_p, 3)]
  t_k = [cuda_ms(run_k, 3), cuda_ms(run_k, 3)]
  t_p.append(cuda_ms(run_p, 3))
  n, m = stats.shape[0], stats.shape[-1]
  bound_ms, bound_by = newton_bound_ms(n, m, p, iters)
  timing = dict(ms=float(np.mean(t_k)), plain_ms=float(np.mean(t_p)),
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=diff,
                path="resident")
  log(f"  matmul chain [{n},{m},{m}] p={p}, {iters} steps: "
      f"max|kernel-twin|={diff:.3e}; kernel {t_k} ms, twin {t_p} ms, bound "
      f"{bound_ms:.3f} ms ({bound_by}), "
      f"{100 * bound_ms / timing['ms']:.1f}% of the bound")
  return timing


def bench_tree_shapes(d=1024, ff=4096, vocab=8192, layers=4):
  """The parameter shapes of the JAX package's bench.py `_param_tree`."""
  shapes = {"embed": (vocab, d)}
  for i in range(layers):
    shapes.update({f"blk{i}/qkv": (d, 3 * d), f"blk{i}/out": (d, d),
                   f"blk{i}/ffn_in": (d, ff), f"blk{i}/ffn_out": (ff, d),
                   f"blk{i}/norm": (d,)})
  return shapes


# The small trees of the GPU-against-CPU check: the default tree, then
# ragged params, a [200,130] at block 128 (blocks 128 and 72 by 128 and 2)
# and the JAX package's [10,6] at block 4 unmerged (tests/test_shampoo.py:
# 78-90), under each option set of the legacy per-block layout.
SMALL_TREES = (
    ("default", {"w": (256, 384), "v": (128, 128), "norm": (256,)}, {}),
    ("ragged, block 128", {"w": (256, 384), "r": (200, 130), "norm": (256,)},
     {}),
    ("ragged [10,6], block 4", {"w": (10, 6), "norm": (5,)},
     dict(block_size=4, best_effort_shape_interpretation=False)),
)
SMALL_OPTIONS = (
    ("quantized", dict(best_effort_memory_usage_reduction=True)),
    ("eigh", dict(eigh=True)),
    ("xla", dict(solver_backend="xla")),
    ("detailed metrics", dict(generate_detailed_metrics=True)),
)
# The compressed modes' small trees hold blocks of 128 whose gradients
# have full rank, as the bench tree's matrices do: a rank-k root of a
# rank-deficient statistic keeps tied eigenvalues whose basis, and an FD
# tail whose rounding-level value, each LAPACK build picks its own way.
# The mixed-size tree's [20, 30] block takes full roots (20 and 30 are at
# most k + 2 = 34) beside FD blocks of 128, so its members launch the
# kernel, padded to 128.  (label, tree, options, kernel launches).
COMPRESSION_RANK = 32
_FD = dict(compression_rank=COMPRESSION_RANK, frequent_directions=True)
_BLOCKS_128 = {"w": (256, 384), "v": (128, 128)}
COMPRESSED_RUNS = (
    ("compression +32", _BLOCKS_128, dict(compression_rank=32), 0),
    ("compression -32", _BLOCKS_128, dict(compression_rank=-32), 0),
    ("FD", _BLOCKS_128, _FD, 0),
    ("FD with reset every 2", _BLOCKS_128,
     dict(_FD, reset_preconditioner=True, beta2=0.5), 0),
    ("FD with average_grad", _BLOCKS_128,
     dict(_FD, average_grad=True, statistics_compute_steps=2), 0),
    ("FD metrics", _BLOCKS_128, dict(_FD, generate_fd_metrics=True), 0),
    ("LOBPCG k=2", _BLOCKS_128, dict(lobpcg_topk_precondition=2), 0),
    ("mixed-size FD", {"w": (256, 384), "s": (20, 30)},
     dict(_FD, best_effort_shape_interpretation=False), 3),
)


def small_tree_check(device):
  """The same optimizer on the GPU (kernel) and on the CPU (twin) from
  the same small inputs: 3 updates must agree, on the default tree, on
  the ragged trees under every option set and on the compressed modes'
  trees (updates rtol 1e-3 / atol 1e-4 * max|x|; 2 * max|x| / 127
  quantized, where an int8 code may round the other way on one side).
  Every root must pass the failure gate, except under LOBPCG, whose k
  iterations leave pairs unconverged and roots the gate rejects: there
  both devices must reject the same members."""
  runs = [(SMALL_TREES[0][0], SMALL_TREES[0][1], {}, 6)]
  runs += [(f"{tree}, {label}", shapes, {**base, **options},
            0 if options.get("eigh") or options.get("solver_backend") == "xla"
            else 6)
           for tree, shapes, base in SMALL_TREES[1:]
           for label, options in SMALL_OPTIONS]
  runs += list(COMPRESSED_RUNS)
  for label, shapes, options, want_launches in runs:
    gen = torch.Generator().manual_seed(1)
    params = {n: 0.1 * torch.randn(s, generator=gen)
              for n, s in shapes.items()}
    grads = [{n: 0.1 * torch.randn(s, generator=gen)
              for n, s in shapes.items()} for _ in range(3)]
    out, rejected = {}, {}
    launches = newton_root.LAUNCHES
    for dev in ("cpu", device):
      opt = shampoo.distributed_shampoo(**{**HYPERS, **options})
      p = {n: x.to(dev) for n, x in params.items()}
      state = opt.init(p)
      for g in grads:
        upd, state = opt.update({n: x.to(dev) for n, x in g.items()}, state,
                                p)
        p = {n: p[n] + upd[n] for n in p}
      out[dev] = p
      errors = torch.cat([ps.training_metrics.error
                          for ps in state.stats.values()])
      rejected[dev] = (errors >= 0.1).cpu()
      check(options.get("lobpcg_topk_precondition")
            or not bool(rejected[dev].any()),
            f"small tree ({label}) on {dev}: the failure gate rejected roots")
    check(torch.equal(rejected["cpu"], rejected[device]),
          f"small tree ({label}): the devices' failure gates disagree")
    launches = newton_root.LAUNCHES - launches
    kernel = want_launches > 0
    check(launches == want_launches,
          f"small tree ({label}): {launches} kernel launches, expected "
          f"{want_launches}")
    quantized = options.get("best_effort_memory_usage_reduction", False)
    worst = 0.0
    for n in shapes:
      got, ref = out[device][n].cpu(), out["cpu"][n]
      worst = max(worst, (got - ref).abs().max().item())
      scale = ref.abs().max()
      check(torch.allclose(got, ref, rtol=1e-3,
                           atol=2 * scale / 127 if quantized
                           else 1e-4 * scale),
            f"small tree ({label}): GPU and CPU paths disagree on {n}")
    log(f"  small tree ({label}), 3 updates: GPU "
        f"({'kernel' if kernel else 'torch solvers'}) against CPU max |diff| "
        f"{worst:.3e}, {launches} kernel launches, "
        f"{int(rejected[device].sum())} of {len(rejected[device])} roots "
        "rejected by the gate")


def state_bytes(state):
  """Bytes of the tensors in an optimizer state of dataclasses, dicts,
  lists and tuples: sum of numel * element_size."""
  if isinstance(state, torch.Tensor):
    return state.numel() * state.element_size()
  if isinstance(state, QuantizedValue):
    return sum(state_bytes(t) for t in state.tensors())
  if isinstance(state, dict):
    return sum(state_bytes(v) for v in state.values())
  if isinstance(state, (list, tuple)):
    return sum(state_bytes(v) for v in state)
  if dataclasses.is_dataclass(state):
    return sum(state_bytes(getattr(state, f.name))
               for f in dataclasses.fields(state))
  return 0


def bench_fixture(device, **tree):
  """The bench tree's parameters and a source of its gradients, from the
  seed 0 on the card; the same calls give the same numbers."""
  gen = torch.Generator(device=device).manual_seed(0)
  shapes = bench_tree_shapes(**tree)
  params = {n: 0.02 * torch.randn(s, generator=gen, device=device)
            for n, s in shapes.items()}
  grads = lambda: {n: 0.01 * torch.randn(s, generator=gen, device=device)
                   for n, s in shapes.items()}
  return params, grads


def timed_steps(label, tx, params, grads, steps, launches_per_step,
                on_step=None):
  """Initializes ``tx``'s state, resets the peak-memory counter and runs
  ``steps`` updates of the bench fixture, host clock around each, with the
  kernels' counts set to 0 just before the first; checks the Newton
  kernel's launches (``launches_per_step`` a step), finite updates, which
  it adds to ``params``, and no launch of the matmul chain, and calls
  ``on_step(step, updates, state)`` after each.  Returns a dict: step
  seconds and their median after step 1, the state before the last step
  and after it, the launches, the bytes held before the steps and the
  peak bytes."""
  state = tx.init(params)
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  times = []
  newton_root.LAUNCHES = matmul_chain.LAUNCHES = 0
  for step in range(steps):
    g = grads()
    before = state
    torch.cuda.synchronize()
    start = time.perf_counter()
    updates, state = tx.update(g, state, params)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - start)
    want = launches_per_step * (step + 1)
    check(newton_root.LAUNCHES == want,
          f"{label} step {step}: {newton_root.LAUNCHES} kernel launches, "
          f"expected {want}")
    for n, u in updates.items():
      check(u.shape == params[n].shape and bool(torch.isfinite(u).all()),
            f"{label} step {step}: update of {n} is not finite or has a "
            "wrong shape")
      params[n] += u
    if on_step is not None:
      on_step(step, updates, state)
  check(matmul_chain.LAUNCHES == 0,
        f"{label}: the matmul chain ran on the optimizer's path")
  peak = torch.cuda.max_memory_allocated()
  median_ms = 1e3 * float(np.median(times[1:] if steps > 1 else times))
  log(f"  {label}, {steps} steps: Newton launches {newton_root.LAUNCHES}; "
      f"step times {[round(1e3 * t, 3) for t in times]} ms; median after "
      f"step 1 {median_ms:.3f} ms; peak memory {peak / 2**30:.3f} GiB, of "
      f"which {base / 2**30:.3f} GiB were held before the steps")
  return dict(times=times, step_ms=median_ms, before=before, state=state,
              launches=newton_root.LAUNCHES, base=base, peak=peak)


def run_steps(label, opt, params, grads, steps, reference=None,
              launches_per_step=2):
  """`timed_steps` of a `distributed_shampoo` with the roots every step,
  which also checks the failure gate after each step and, with
  ``reference`` (a list of each step's updates on the host), each step's
  relative Frobenius difference from it.  Adds to `timed_steps`' dict the
  updates on the host (without ``reference``), the max rel diff and the
  max root error."""
  kept, rel_worst = [], [0.0]

  def on_step(step, updates, state):
    errors = torch.cat([ps.training_metrics.error
                        for ps in state.stats.values()])
    check(not bool(torch.isnan(errors).any())
          and errors.max().item() < 0.1,  # inverse_failure_threshold
          f"{label} step {step}: the failure gate rejected roots (max error "
          f"{errors.max().item()})")
    host = {n: u.cpu() for n, u in updates.items()}
    if reference is not None:
      num = sum(float((host[n] - reference[step][n]).square().sum())
                for n in host)
      den = sum(float(reference[step][n].square().sum()) for n in host)
      rel = math.sqrt(num / den)
      check(rel < 0.1, f"{label} step {step}: update differs from the f32 "
            f"run's by {rel:.3e} (relative Frobenius)")
      rel_worst[0] = max(rel_worst[0], rel)
    else:
      kept.append(host)

  run = timed_steps(label, opt, params, grads, steps, launches_per_step,
                    on_step)
  errors = torch.cat([ps.training_metrics.error
                      for ps in run["state"].stats.values()])
  return dict(run, updates=kept, rel=rel_worst[0],
              max_error=errors.max().item())


def phase_main_path(device, steps=5, **tree):
  log("(c) main path: distributed_shampoo on the bench fixture")
  small_tree_check(device)
  f1_check(device)
  params, grads = bench_fixture(device, **tree)
  n_params = sum(p.numel() for p in params.values())
  opt = shampoo.distributed_shampoo(**HYPERS)
  run = run_steps("(c)", opt, params, grads, steps)
  updates, times, state = run["updates"], run["times"], run["state"]
  max_error, peak = run["max_error"], run["peak"]
  launches = newton_root.LAUNCHES
  census = {}
  for name, ps in state.stats.items():
    p = 2 * len(ps.statistics)
    for s in ps.statistics:
      census[p] = census.get(p, 0) + s.shape[0]
  log(f"  {n_params / 1e6:.1f}M parameters; statistics per exponent "
      f"{dict(sorted(census.items()))} of size "
      f"[{HYPERS['block_size']},{HYPERS['block_size']}]")
  profiled = profile_step(opt, state, params, grads)
  median_ms = 1e3 * float(np.median(times[1:]))
  nbytes = state_bytes(state)
  log(f"  {steps} steps: kernel launches {launches}; step times "
      f"{[round(1e3 * t, 3) for t in times]} ms; median after step 1 "
      f"{median_ms:.3f} ms; peak memory {peak / 2**30:.3f} GiB; "
      f"state {nbytes} B; max root error {max_error:.3e}")
  log(f"  one more step under torch.profiler: {json.dumps(profiled)}")
  return dict(launches=launches, step_ms=median_ms, peak_bytes=peak,
              state_bytes=nbytes, profiled_step=profiled), updates


# Optimizer-state bytes of the JAX package on the bench tree, counted from
# its state's shapes and dtypes (benchmarks/quantized_probe.py,
# STEP_BREAKDOWN_TPU.json): f32 and memory-reduced, without training
# metrics.  The port's must agree within 0.1%.
JAX_STATE_BYTES = {"f32": 1514.2e6, "quantized": 770.0e6}
# `jax.eval_shape` of the JAX package's SM3 and tearfree inits on the bench
# tree, with (h)'s and (i)'s options (tests/test_torch_sm3.py and
# tests/test_torch_tearfree_chain.py hold these to JAX and the port's
# counts to them); JAX keeps each step count as an int32, the port as a
# Python int.
JAX_SM3_STATE_BYTES = 59_191_316
JAX_TEARFREE_SHAMPOO_STATE_BYTES = 1_275_101_192
JAX_TEARFREE_SKETCHY_STATE_BYTES = 503_382_280
# The JAX package's memory-sharded state on the bench tree with (j2)'s
# options, by its `shape_and_dtype_fn` (tests/test_torch_sharded.py holds
# both to it): the global statistics and roots, [6176, 128, 128] f32 each,
# and the whole state with the exponents, the replicated per-parameter
# stats and the int32 step count.
JAX_SHARDED_ROOT_BYTES = 809_500_672
JAX_SHARDED_STATE_BYTES = 1_514_341_124


SCOPES = ("ShampooStatistics", "ShampooRootSolve", "ShampooPrecondition")
# Tearfree Shampoo's profiler scopes: statistics, roots, preconditioning.
TEARFREE_SCOPES = ("ShampooStats", "PthInvRoot", "PreconditionShampoo")


def profile_step(opt, state, params, grads, trace_device=True,
                 scopes=SCOPES):
  """One more update under `torch.profiler`: the host ms of each of the
  optimizer's ``scopes``, the kernels' device ms in all and the five
  largest by name (None and absent without ``trace_device``), and the
  step's wall ms (inflated by the profiler)."""
  g = grads()
  return profile_call(lambda: opt.update(g, state, params), trace_device,
                      scopes)


def profile_call(fn, trace_device=True, scopes=SCOPES):
  """`profile_step`'s record of one call of ``fn()``."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  activities = [ProfilerActivity.CPU]
  if trace_device:
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities) as prof:
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
  events = prof.key_averages()
  out = {"wall_ms": 1e3 * wall}
  for e in events:
    if e.key in scopes and e.device_type == DeviceType.CPU:
      out[f"{e.key}_host_ms"] = e.cpu_time_total / 1e3
  # Device events other than the scopes' own spans: kernels, copies, sets.
  device = [e for e in events
            if e.device_type == DeviceType.CUDA and e.key not in scopes]
  out["kernels_ms"] = (sum(e.self_device_time_total for e in device) / 1e3
                       if trace_device else None)
  if trace_device:
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:5]
    out["top_kernels_ms"] = {e.key[:60]: e.self_device_time_total / 1e3
                             for e in top}
  return out


# Repetitions of each timed decode and encode of the per-block state.
CODEC_REPS = 3


def host_codec_ms(state):
  """Host-clock ms to decode every legacy statistic of ``state`` in
  equal-shape groups (stack, decode) and to encode them back (encode,
  split into per-block entries), as the optimizer does each step."""
  groups = {}
  for ps in state.stats.values():
    for q in ps.statistics:
      groups.setdefault(tuple(q.shape), []).append(q)
  decode = lambda: [QuantizedValue.stack(g).to_float()
                    for g in groups.values()]
  encode = lambda fs: [QuantizedValue.from_float_value(
      f, torch.int16, extract_diagonal=True, batch_dims=1).unbind()
                       for f in fs]
  floats = decode()
  torch.cuda.synchronize()
  out = {}
  for name, fn in (("decode", decode), ("encode", lambda: encode(floats))):
    start = time.perf_counter()
    for _ in range(CODEC_REPS):
      fn()
    torch.cuda.synchronize()
    out[name] = 1e3 * (time.perf_counter() - start) / CODEC_REPS
  out["entries"] = sum(len(g) for g in groups.values())
  # A full collection of Python's garbage collector with the state alive:
  # the per-block state is tens of thousands of tracked objects.
  out["gc_objects"] = len(gc.get_objects())
  start = time.perf_counter()
  gc.collect()
  out["gc_ms"] = 1e3 * (time.perf_counter() - start)
  return out


def phase_memory_reduced(device, reference, f32_bytes, steps=5, **tree):
  """(c2): the bench fixture with best_effort_memory_usage_reduction, the
  JAX package's benchmarks/quantized_probe.py configuration, on the same
  parameters and gradients as (c)."""
  log("(c2) memory-reduced main path: best_effort_memory_usage_reduction "
      "on the bench fixture")
  params, grads = bench_fixture(device, **tree)
  opt = shampoo.distributed_shampoo(
      **HYPERS, best_effort_memory_usage_reduction=True)
  run = run_steps("(c2)", opt, params, grads, steps, reference=reference)
  times, state, rel = run["times"], run["state"], run["rel"]
  max_error, base, peak = run["max_error"], run["base"], run["peak"]
  launches = newton_root.LAUNCHES
  median_ms = 1e3 * float(np.median(times[1:]))
  nbytes = state_bytes(state)
  codec = host_codec_ms(state)
  profiled = profile_step(opt, state, params, grads)
  metric_bytes = sum(4 * 5 * ps.training_metrics.error.numel()
                     for ps in state.stats.values())
  for key, got in (("quantized", nbytes), ("f32", f32_bytes)):
    want = JAX_STATE_BYTES[key]
    check(abs(got - want) <= 1e-3 * want,
          f"(c2) {key} state {got} B differs from the JAX count {want} B "
          "by more than 0.1%")
  log(f"  {steps} steps: kernel launches {launches}; step times "
      f"{[round(1e3 * t, 3) for t in times]} ms; median after step 1 "
      f"{median_ms:.3f} ms; peak memory {peak / 2**30:.3f} GiB, of which "
      f"{base / 2**30:.3f} GiB were held before the steps; state "
      f"{nbytes} B against (c)'s {f32_bytes} B (training metrics "
      f"{metric_bytes} B of each; JAX shape count {JAX_STATE_BYTES['quantized']:.0f} and "
      f"{JAX_STATE_BYTES['f32']:.0f} B without them); max relative "
      f"Frobenius difference from (c)'s updates {rel:.3e}; max root error "
      f"{max_error:.3e}; host decode of the {codec['entries']} statistics "
      f"{codec['decode']:.1f} ms, encode {codec['encode']:.1f} ms; a full "
      f"garbage collection over {codec['gc_objects']} objects "
      f"{codec['gc_ms']:.1f} ms")
  log(f"  one more step under torch.profiler: {json.dumps(profiled)}")
  return dict(profiled_step=profiled, launches=launches, step_ms=median_ms,
              step_times_ms=[1e3 * t for t in times], peak_bytes=peak,
              base_bytes=base, state_bytes=nbytes, f32_state_bytes=f32_bytes,
              metric_bytes=metric_bytes, max_rel_update_diff=rel,
              host_decode_ms=codec["decode"], host_encode_ms=codec["encode"],
              gc_objects=codec["gc_objects"], gc_ms=codec["gc_ms"])


# Optimizer-state bytes of the JAX package on the bench tree with
# compression_rank=32, with or without frequent directions, without
# training metrics: `jax.eval_shape` of its `init` (the port's count is
# held to it on the CPU by tests/test_torch_state_bytes.py).
JAX_COMPRESSED_STATE_BYTES = 1_216_954_372
# Members of the last step's compressed solve re-solved on the host.
SAMPLED = 64
# Members of the library timings that loop over the batch on the card.
LOOPED_MEMBERS = 256


def packed_operators(bufs, rank):
  """``U diag(inv) U^T + const (I - U U^T)`` of packed roots ``[N, d, k+2]``:
  what each applies, whatever basis its tied eigenvalues took."""
  u, inv, const, _ = lowrank.low_rank_unpack(bufs, rank)
  eye = torch.eye(bufs.shape[1], dtype=bufs.dtype, device=bufs.device)
  return (torch.einsum("nik,nk,njk->nij", u, inv, u)
          + const[:, None, None] * (eye - u @ u.transpose(1, 2)))


def host_resolve(label, run, params, solve):
  """Re-solves SAMPLED members of the last step's batched compressed solve
  on the host from the same statistics (and, for FD, the same previous
  roots) with ``solve(stats, prevs)``, and holds the card's packed roots to
  them as operators beside their scalar columns (relative Frobenius
  difference at most 1e-3).  The members are spread evenly over the 2-D
  params' blocks, whose gradients have full rank; the norm vectors' rank-1
  statistics tie eigenvalues and put rounding-level values in FD tails."""
  picks = [(n, j) for n in run["state"].stats if params[n].dim() == 2
           for j in range(len(run["state"].stats[n].statistics))]
  picks = [picks[i] for i in np.linspace(0, len(picks) - 1,
                                         SAMPLED).astype(int)]
  new, old = run["state"].stats, run["before"].stats
  take = lambda stats, field: torch.stack(
      [getattr(stats[n], field)[j] for n, j in picks]).cpu()
  got = take(new, "preconditioners")
  want, _ = solve(take(new, "statistics"), take(old, "preconditioners"))
  rel = lambda a, b: (torch.linalg.vector_norm(a - b, dim=(1, 2))
                      / torch.linalg.vector_norm(b, dim=(1, 2)))
  op_rel = rel(packed_operators(got, COMPRESSION_RANK),
               packed_operators(want, COMPRESSION_RANK)).max().item()
  k = COMPRESSION_RANK
  scalar_rel = rel(got[:, :, k:], want[:, :, k:]).max().item()
  log(f"  {label}: {SAMPLED} sampled members re-solved on the host: max "
      f"relative Frobenius difference {op_rel:.3e} (operators), "
      f"{scalar_rel:.3e} (packed scalars)")
  check(op_rel <= 1e-3 and scalar_rel <= 1e-3,
        f"{label}: the card's packed roots differ from the host's")
  return dict(operator_rel=op_rel, scalar_rel=scalar_rel)


def phase_compressed(label, device, steps, frequent_directions, **tree):
  """(c3) and (c4): the bench fixture with compression_rank=32, frequent
  directions or low-rank roots, on the same parameters and gradients as
  (c).  Every block of 128 compresses (34 < 128), so no member takes the
  Newton kernel."""
  params, grads = bench_fixture(device, **tree)
  opt = shampoo.distributed_shampoo(
      **HYPERS, compression_rank=COMPRESSION_RANK,
      frequent_directions=frequent_directions)
  run = run_steps(label, opt, params, grads, steps, launches_per_step=0)
  state, times = run["state"], run["times"]
  errors = torch.cat([ps.training_metrics.error
                      for ps in state.stats.values()])
  if frequent_directions:
    check(bool((errors == 0).all()), f"{label}: an FD error is not 0")
  nbytes = state_bytes(state)
  metric_bytes = sum(4 * 5 * ps.training_metrics.error.numel()
                     for ps in state.stats.values())
  check(abs(nbytes - metric_bytes - JAX_COMPRESSED_STATE_BYTES)
        <= 1e-3 * JAX_COMPRESSED_STATE_BYTES,
        f"{label}: state {nbytes} B ({metric_bytes} B of metrics) differs "
        f"from the JAX count {JAX_COMPRESSED_STATE_BYTES} B by more than 0.1%")
  kw = dict(ridge_epsilon=HYPERS["matrix_epsilon"])
  if frequent_directions:
    solve = lambda stats, prevs: lowrank.fd_update_root(
        stats, 4, COMPRESSION_RANK, prevs, decay=HYPERS["beta2"], **kw)
  else:
    solve = lambda stats, prevs: lowrank.low_rank_root(
        stats, 4, COMPRESSION_RANK, **kw)
  median_ms = 1e3 * float(np.median(times[1:]))
  log(f"  {steps} steps: step times {[round(1e3 * t, 3) for t in times]} ms")
  resolved = host_resolve(label, run, params, solve)
  # No profiled step: under the profiler cuSOLVER's per-matrix loop leaves
  # over a million host events a step, whose parsing took most of these
  # phases' time (PERF.md), and tracing the device outlasted a 20-minute
  # call.
  log(f"  {steps} steps: Newton launches {newton_root.LAUNCHES}; step times "
      f"{[round(1e3 * t, 3) for t in times]} ms; median after step 1 "
      f"{median_ms:.3f} ms; peak memory {run['peak'] / 2**30:.3f} GiB, of "
      f"which {run['base'] / 2**30:.3f} GiB were held before the steps; "
      f"state {nbytes} B ({metric_bytes} B of training metrics; JAX count "
      f"{JAX_COMPRESSED_STATE_BYTES} B without them); max root error "
      f"{run['max_error']:.3e}")
  return dict(step_times_ms=[1e3 * t for t in times], step_ms=median_ms,
              peak_bytes=run["peak"], base_bytes=run["base"],
              state_bytes=nbytes, metric_bytes=metric_bytes,
              max_error=run["max_error"], **resolved)


def linalg_timings(device):
  """The library calls of the compressed solves at the bench tree's
  shapes, CUDA events, one timed call each after a warm-up: the FD
  statistic's QR (mode "r") at the 6,176 members; on LOOPED_MEMBERS
  Gaussian members, eigh and each SVD driver, which but "gesvda" loop
  over the batch a matrix at a time.  "gesvda" (batched, through x^T x,
  on the tall transpose) raises on the rank-deficient members the norm
  vectors give the FD solve, so the solve takes the default driver."""
  gen = torch.Generator(device=device).manual_seed(3)
  n, d, w = 6176, 128, 128 + COMPRESSION_RANK
  x = torch.randn(n, d, d, generator=gen, device=device)
  few = slice(0, LOOPED_MEMBERS)
  wide = torch.randn(LOOPED_MEMBERS, d, w, generator=gen, device=device)
  psd = x[few] @ x[few].transpose(1, 2) / d + 1e-3 * torch.eye(
      d, device=device)
  calls = {
      f"qr_r[{n},{d},{d}]": lambda: torch.linalg.qr(x, mode="r"),
      f"eigh[{LOOPED_MEMBERS},{d},{d}]": lambda: torch.linalg.eigh(psd),
  }
  for driver in (None, "gesvd", "gesvdj"):
    calls[f"svd_{driver or 'default'}[{LOOPED_MEMBERS},{d},{w}]"] = (
        lambda driver=driver: torch.linalg.svd(wide, full_matrices=False,
                                               driver=driver))
  calls[f"svd_gesvda[{LOOPED_MEMBERS},{w},{d}]"] = lambda: torch.linalg.svd(
      wide.transpose(1, 2), full_matrices=False, driver="gesvda")
  out = {}
  for name, fn in calls.items():
    fn()
    out[name] = cuda_ms(fn, 1)
  log(f"  library calls (ms, one call each): {json.dumps(out)}")
  return out


def solver_timings(stats, kernel_ms, p=4):
  """The per-matrix solvers at the main path's ``stats`` beside the Newton
  kernel's ``kernel_ms``: "xla" (`pth_root.batched_inverse_pth_root`), its
  eigh form and its LOBPCG-deflated form (k = 4), CUDA events, one call
  each after a warm-up on 64 members."""
  n, m, _ = stats.shape
  solvers = {
      "xla": dict(),
      "eigh": dict(eigh=True),
      "lobpcg_k4": dict(lobpcg_topk_precondition=4),
  }
  out = {"newton_kernel": kernel_ms}
  for name, kw in solvers.items():
    fn = lambda s, kw=kw: pth_root.batched_inverse_pth_root(s, p, **kw)
    fn(stats[:64])
    result = {}
    out[name] = cuda_ms(lambda: result.update(metrics=fn(stats)[1]), 1)
    errors = result["metrics"].error
    check(not bool(torch.isnan(errors).any()), f"solver {name}: NaN errors")
    out[f"{name}_rejected"] = int((errors >= 0.1).sum())
  log(f"  per-matrix solvers at [{n},{m},{m}] p={p} (ms, one call each; "
      f"members the failure gate would reject): {json.dumps(out)}")
  return out


def f1_check(device):
  """A statistic above the kernel's MAX_M takes the per-matrix solver: a
  [1100, 8] param at block 2048, one update on the card."""
  opt = shampoo.distributed_shampoo(learning_rate=0.1, block_size=2048,
                                    start_preconditioning_step=0)
  gen = torch.Generator(device=device).manual_seed(4)
  params = {"w": torch.randn(1100, 8, generator=gen, device=device)}
  launches = newton_root.LAUNCHES
  upd, state = opt.update({"w": torch.randn(1100, 8, generator=gen,
                                            device=device)},
                          opt.init(params), params)
  errors = state.stats["w"].training_metrics.error
  check(bool(torch.isfinite(upd["w"]).all()) and errors.max().item() < 0.1
        and newton_root.LAUNCHES == launches,
        "a [1100, 8] param at block 2048 did not solve without the kernel")
  log(f"  [1100, 8] at block 2048: solved by the per-matrix solver, errors "
      f"{errors.tolist()}")


def card_against_cpu(label, make_tx, device, shapes, quantized=False,
                     steps=3):
  """The transformation ``make_tx()`` on the card and on the CPU from the
  same small inputs: the summed updates of ``steps`` steps must agree
  (rtol 1e-3, atol 1e-4 * max|x|; two int8 steps of the scale with an
  int8 momentum, where a code may round the other way on one side).
  Returns the card's Newton-kernel launches."""
  gen = torch.Generator().manual_seed(1)
  params = {n: 0.1 * torch.randn(s, generator=gen) for n, s in shapes.items()}
  grads = [{n: 0.1 * torch.randn(s, generator=gen) for n, s in shapes.items()}
           for _ in range(steps)]
  total = {}
  for dev in ("cpu", device):
    tx = make_tx()
    p = {n: x.to(dev) for n, x in params.items()}
    state = tx.init(p)
    launches = newton_root.LAUNCHES
    acc = {n: torch.zeros_like(x) for n, x in p.items()}
    for g in grads:
      upd, state = tx.update({n: x.to(dev) for n, x in g.items()}, state, p)
      for n in p:
        acc[n] += upd[n]
        p[n] = p[n] + upd[n]
    total[dev] = {n: x.cpu() for n, x in acc.items()}
    launches = newton_root.LAUNCHES - launches
  worst = 0.0
  for n in shapes:
    got, ref = total[device][n], total["cpu"][n]
    scale = ref.abs().max()
    worst = max(worst, (got - ref).abs().max().item())
    check(bool(torch.isfinite(got).all())
          and torch.allclose(got, ref, rtol=1e-3,
                             atol=2 * scale / 127 if quantized
                             else 1e-4 * scale),
          f"{label}: card and CPU disagree on {n} by up to {worst}")
  log(f"  {label}, {steps} updates: card against CPU max |diff| "
      f"{worst:.3e}, {launches} kernel launches on the card")
  return launches


def check_state_bytes(label, state, want, counts):
  """The state's tensor bytes against the JAX package's shape count
  ``want``, which holds ``counts`` int32 step counts the port keeps as
  Python ints: within 0.1%."""
  nbytes = state_bytes(state)
  check(abs(nbytes + 4 * counts - want) <= 1e-3 * want,
        f"{label}: state {nbytes} B differs from the JAX count {want} B by "
        "more than 0.1%")
  log(f"  {label}: state {nbytes} B; JAX count {want} B ({counts} int32 "
      "step counts more)")
  return nbytes


SM3_HYPERS = dict(learning_rate=0.1, beta1=0.9, beta2=0.999)
# A small tree for the card against the CPU: a norm vector, blocks [64, 128]
# (one statistic rank-deficient with a clean gap, at p = 4 on the Newton
# kernel's resident path) and a 3-D block [32, 64, 128] (full rank, p = 6
# on its global path; no two of its dims merge at tearfree's merge_dims
# of 1024).  No square block: the eigenvalues of a square Gaussian block
# can fall at the 1e-6 clip, which the eigh and filtered backends then
# decide by rounding.
SMALL_TEARFREE_TREE = {"w": (64, 256), "t": (32, 64, 128), "b": (256,)}
# Kernel launches of the small tree a step: two axes of "w", three of "t".
SMALL_TEARFREE_LAUNCHES = 5


def phase_sm3(device, steps=5, **tree):
  log("(g) SM3 on the bench fixture")
  card_against_cpu("SM3 small tree", lambda: sm3.sm3(**SM3_HYPERS), device,
                   SMALL_TEARFREE_TREE, quantized=True)
  params, grads = bench_fixture(device, **tree)
  run = timed_steps("(g) SM3", sm3.sm3(**SM3_HYPERS), params, grads, steps,
                    launches_per_step=0)
  nbytes = check_state_bytes("(g) SM3", run["state"], JAX_SM3_STATE_BYTES,
                             counts=1)
  return dict(step_times_ms=[1e3 * t for t in run["times"]],
              step_ms=run["step_ms"], peak_bytes=run["peak"],
              base_bytes=run["base"], state_bytes=nbytes)


def tearfree_options(backend="filtered", sketch=False, rank=128):
  """The JAX package's benchmarks/tearfree_backend_trajectory.py:89-107
  options (RMSProp grafting at decay 0.999, statistics decay 0.999,
  momentum 0.9) at the bench block, 128, with roots every step from step
  0; Sketchy at ``rank``, by default the Options' 128."""
  if sketch:
    so = tf_second_order.Options(
        second_order_type=tf_second_order.SecondOrderType.SKETCHY,
        shampoo_options=None, sketchy_options=tf_sketchy.Options(rank=rank))
  else:
    so = tf_second_order.Options(
        second_order_type=tf_second_order.SecondOrderType.SHAMPOO,
        shampoo_options=tf_shampoo.Options(
            block_size=128, update_preconditioners_freq=1,
            second_moment_decay=0.999, solver_backend=backend))
  return tf_optimizer.TearfreeOptions(
      grafting_options=tf_grafting.Options(
          grafting_type=tf_grafting.GraftingType.RMSPROP,
          second_moment_decay=0.999, start_preconditioning_step=0),
      second_order_options=so,
      momentum_options=tf_momentum.Options(momentum_decay=0.9))


# Kernel launches of a tearfree Shampoo step on the bench tree at block
# 128: one per preconditioned (param, axis), 4 layers x 4 matrices x 2.
TEARFREE_LAUNCHES = 32


def sampled_blocks(state):
  """SAMPLED (statistic, root) pairs spread evenly over the last solve's
  blocks: ``([n, 128, 128] stats, [n, 128, 128] roots)`` on the card."""
  blocks = state[0].direction.blocks
  picks = [(name, axis, j) for name, b in blocks.items()
           for axis, s in enumerate(b.stats) for j in range(s.shape[0])]
  picks = [picks[i] for i in np.linspace(0, len(picks) - 1,
                                         SAMPLED).astype(int)]
  take = lambda field: torch.stack(
      [getattr(blocks[n], field)[a][j] for n, a, j in picks])
  return take("stats"), take("roots")


def check_newton_roots(stats, roots, p=4):
  """Roots of the ``newton`` backend against their float64 true residual,
  at the ridge the kernel solved: the sampled statistics solved again by
  the kernel with the backend's own lambda_max give the ridge and ladder
  round (relaunched after the run's count was read)."""
  pads = torch.full((stats.shape[0],), stats.shape[-1], dtype=torch.int32,
                    device=stats.device)
  again, metrics = newton_root.batched_inverse_pth_root_cuda(
      stats, p, pads, max_evs=tf_shampoo._batched_max_evs(stats, pads))
  resid, bound = residual_check(stats, pads, p, metrics, relative=True)(
      roots)
  worst = (resid / bound).max().item()
  diff = (again - roots).abs().max().item()
  log(f"  newton: {SAMPLED} sampled roots, f64 true residual max "
      f"{resid.max().item():.3e} (max resid/bound {worst:.3e}); "
      f"max |root - root solved again| {diff:.3e}")
  check(worst < 1.0, "newton: a sampled root's true residual is over its "
        "bound")
  return dict(residual_max=resid.max().item(), resid_over_bound=worst)


def check_filtered_roots(stats, roots, p=4):
  """Roots of the ``filtered`` backend against a float64 eigh root of the
  same statistics with the 1e-6 relative clip, on the host: max-abs within
  0.05 of the largest root entry (the JAX suite's bound,
  tests/test_tearfree.py:178-180)."""
  w, v = torch.linalg.eigh(stats.double().cpu())
  mask = w <= 1e-6 * w.amax(dim=-1, keepdim=True)
  inv = torch.where(mask, 0.0, torch.where(mask, 1.0, w) ** (-1.0 / p))
  want = (v * inv[:, None, :]) @ v.transpose(1, 2)
  err = ((roots.double().cpu() - want).abs().amax(dim=(1, 2))
         / want.abs().amax(dim=(1, 2)))
  log(f"  filtered: {SAMPLED} sampled roots against a float64 eigh root "
      f"with the clip, max |diff| / max |root| {err.max().item():.3e}")
  check(err.max().item() < 0.05,
        "filtered: a sampled root is off the eigh root by more than 0.05")
  return dict(rel_max_abs_diff=err.max().item())


def phase_tearfree(device, **tree):
  """(h): tearfree blocked Shampoo on the bench fixture; returns each
  backend's record."""
  log("(h) tearfree Shampoo on the bench fixture")
  for backend in ("filtered", "newton", "eigh"):
    launches = card_against_cpu(
        f"tearfree {backend} small tree",
        lambda: tf_optimizer.tearfree(0.1, tearfree_options(backend)),
        device, SMALL_TEARFREE_TREE)
    want = 0 if backend == "eigh" else 3 * SMALL_TEARFREE_LAUNCHES
    check(launches == want, f"tearfree {backend} small tree: {launches} "
          f"kernel launches on the card, expected {want}")
  # Rank 16: at the default 128 the first gradient of "w"'s 256-long axis
  # has rank 64 <= k, and the sketch keeps rounding-level singular values
  # whose basis and inverse roots each LAPACK build picks its own way
  # (PERF.md §6, "Ties"); the bench tree's axes have rank 1,024 or more.
  card_against_cpu(
      "tearfree Sketchy small tree",
      lambda: tf_optimizer.tearfree(0.1, tearfree_options(sketch=True,
                                                          rank=16)),
      device, SMALL_TEARFREE_TREE)
  check(tf_shampoo.resolve_solver("auto", device) == "filtered",
        "tearfree's auto does not resolve to filtered on the card")
  out = {}
  for backend, steps in (("filtered", 5), ("newton", 5), ("eigh", 2)):
    params, grads = bench_fixture(device, **tree)
    tx = tf_optimizer.tearfree(0.1, tearfree_options(backend))
    run = timed_steps(f"(h) {backend}", tx, params, grads, steps,
                      0 if backend == "eigh" else TEARFREE_LAUNCHES)
    state = run["state"]
    blocks = state[0].direction.blocks
    precond = sum(state_bytes(b) for b in blocks.values())
    nbytes = check_state_bytes(f"(h) {backend}", state,
                               JAX_TEARFREE_SHAMPOO_STATE_BYTES, counts=2)
    record = dict(step_times_ms=[1e3 * t for t in run["times"]],
                  step_ms=run["step_ms"], peak_bytes=run["peak"],
                  base_bytes=run["base"], state_bytes=nbytes,
                  stats_and_roots_bytes=precond, launches=run["launches"],
                  blocks=sum(s.shape[0] for b in blocks.values()
                             for s in b.stats))
    if backend != "eigh":
      stats, roots = sampled_blocks(state)
      check_roots = (check_newton_roots if backend == "newton"
                     else check_filtered_roots)
      record.update(check_roots(stats, roots))
      record["profiled_step"] = profile_step(tx, state, params, grads,
                                             scopes=TEARFREE_SCOPES)
      log(f"  one more {backend} step under torch.profiler: "
          f"{json.dumps(record['profiled_step'])}")
    out[backend] = record
    del state, blocks, run, params
    gc.collect()
    torch.cuda.empty_cache()
  return out


def phase_tearfree_sketchy(device, steps=2, **tree):
  log("(i) tearfree Sketchy at rank 128 on the bench fixture")
  params, grads = bench_fixture(device, **tree)
  tx = tf_optimizer.tearfree(0.1, tearfree_options(sketch=True))
  run = timed_steps("(i) Sketchy", tx, params, grads, steps,
                    launches_per_step=0)
  nbytes = check_state_bytes("(i) Sketchy", run["state"],
                             JAX_TEARFREE_SKETCHY_STATE_BYTES, counts=2)
  return dict(step_times_ms=[1e3 * t for t in run["times"]],
              step_ms=run["step_ms"], peak_bytes=run["peak"],
              base_bytes=run["base"], state_bytes=nbytes)


def phase_trainer(device, width=1024, rows=4096, steps=20):
  log("(d) DistributedShampoo on least squares")
  gen = torch.Generator(device=device).manual_seed(2)
  x = torch.randn(rows, width, generator=gen, device=device)
  target = torch.randn(width, width, generator=gen, device=device)
  y = x @ target / width ** 0.5
  w = torch.zeros(width, width, device=device, requires_grad=True)
  b = torch.zeros(width, device=device, requires_grad=True)
  opt = shampoo.DistributedShampoo(
      [w, b], lr=1e-3, block_size=128, start_preconditioning_step=1,
      graft_type=shampoo.GraftingType.RMSPROP)
  losses = []
  for _ in range(steps):
    opt.zero_grad()
    loss = ((x @ w + b - y) ** 2).mean()
    loss.backward()
    opt.step()
    losses.append(loss.item())
  log(f"  width {width}, {steps} steps: loss {losses[0]:.4f} -> "
      f"{losses[-1]:.4f}")
  check(all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0],
        f"least-squares loss did not fall: {losses}")


def phase_probe(fixtures=(712, 6144)):
  """The tile-breakdown probe's path: returns the launches of each kernel
  over its runs."""
  log("(e) tile-breakdown probe")
  newton_root.LAUNCHES = matmul_chain.LAUNCHES = 0
  for n in fixtures:
    out = tile_breakdown.measure(n=n, m=128, p=4)
    log(json.dumps({"tile_breakdown": out}))
    for key, value in out.items():
      if isinstance(value, float):
        check(math.isfinite(value), f"probe [{n},128,128]: {key} = {value}")
    check(out["fullbody_iters24_mean_iters"] >= 23
          and out["fullbody_iters8_mean_iters"] >= 7,
          f"probe [{n},128,128]: the fixed budgets were not reached")
    check(out["matmulonly_per_iter_ms"] > 0 and out["fullbody_per_iter_ms"] > 0,
          f"probe [{n},128,128]: a per-step slope is not positive")
  launches = {"newton_root": newton_root.LAUNCHES,
              "matmul_chain": matmul_chain.LAUNCHES}
  log(f"  launches over the probe's runs: {launches}")
  check(all(launches.values()), "the probe did not launch both kernels")
  return launches


# Phase (j): distribution on the one card.  Ranks are spawned processes
# joined by gloo (NCCL refuses two ranks on one device); the kernels are
# built by the parent first, and the ranks load the built libraries.
DIST_RANKS = 2
DIST_STEPS = 3
# Timed all-gathers of one rank's half of (j1)'s roots.
GATHER_REPS = 3
# A gloo collective on the bench tree moves up to 809.5 MB through the
# host; the group's timeout bounds each one.
DIST_TIMEOUT_S = 300.0


def _recorded_newton_sizes():
  """Each Newton solve call's batch size from here on, in this process
  (instrumentation of the call, not a launch count)."""
  sizes = []
  solve = newton_root.batched_inverse_pth_root

  def recorded(stats, *args, **kwargs):
    sizes.append(int(stats.shape[0]))
    return solve(stats, *args, **kwargs)
  newton_root.batched_inverse_pth_root = recorded
  return sizes


def _expected_split(exponents, world):
  """Members of each exponent group's solve on each rank: every group
  padded to a multiple of ``world`` and split into ``world`` slices."""
  counts = {}
  for p in exponents:
    counts[p] = counts.get(p, 0) + 1
  return [-(-counts[p] // world) for p in sorted(counts)]


def _runs_of(exponents):
  """Lengths of the runs of equal exponents (the sharded layout's groups
  within a rank's rows); a padding slot (exponent 1) joins the run before
  it, as it joins the last group."""
  runs, last = [], None
  for p in exponents:
    if runs and p in (last, 1):
      runs[-1] += 1
    else:
      runs.append(1)
      last = p
  return runs


def _worst(pairs):
  """Largest |a - b| over ``(a, b)`` tensor pairs (``a`` moved to ``b``'s
  device), and whether every entry is within ATOL + RTOL |b|."""
  worst, ok = 0.0, True
  for a, b in pairs:
    diff = (a.to(b.device) - b).abs()
    worst = max(worst, float(diff.max()))
    ok = ok and bool((diff <= ATOL + RTOL * b.abs()).all())
  return worst, ok


def _timed_dist_steps(label, opt, init, params, grads, after_step):
  """``DIST_STEPS`` updates from ``init() -> (state, expected Newton batch
  sizes a step)``, built here so that no caller holds the first state
  over the steps, with the kernels' counts set to 0 just before the
  first; host clock around each, ending in a synchronize.  Checks each
  step's Newton calls' batch sizes, its launches, finite updates;
  ``after_step(updates, state)`` and a barrier of the ranks run outside
  the clock and outside the peak, which is the largest of the updates'
  own peaks.  Returns a dict: step ms, launches, the expected sizes, the
  final state, the bytes held before the steps and the peak bytes."""
  state, expected = init()
  torch.cuda.synchronize()
  base = torch.cuda.memory_allocated()
  sizes = _recorded_newton_sizes()
  times, peak = [], 0
  newton_root.LAUNCHES = matmul_chain.LAUNCHES = 0
  for step in range(DIST_STEPS):
    g = grads()
    sizes.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    updates, state = opt.update(g, state, params)
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - start))
    peak = max(peak, torch.cuda.max_memory_allocated())
    check(sizes == expected, f"{label} step {step}: Newton batches {sizes}, "
          f"expected {expected}")
    check(newton_root.LAUNCHES == len(expected) * (step + 1),
          f"{label} step {step}: {newton_root.LAUNCHES} Newton launches")
    for n, u in updates.items():
      check(bool(torch.isfinite(u).all()),
            f"{label} step {step}: update of {n} is not finite")
    after_step(updates, state)
    # The ranks start each step together: a rank's clock must not hold the
    # wait for another's work outside its own clock.
    dist.barrier()
  check(matmul_chain.LAUNCHES == 0, f"{label}: the matmul chain ran")
  return dict(step_ms=times, launches=newton_root.LAUNCHES,
              members=expected, state=state, base_bytes=base,
              peak_bytes=peak)


def _to_host(updates, roots):
  """A step's updates and roots copied to the host, so that keeping them
  for the comparison adds nothing to the card's memory."""
  return ({n: u.cpu() for n, u in updates.items()}, [r.cpu() for r in roots])


def _single_run(opt, init, kept):
  """The comparison run on rank 0: ``DIST_STEPS`` updates of ``opt`` from
  ``init(params)`` on the same fixture, each step's updates and roots
  (``roots(state)``) against ``kept``.  Returns its step ms and the
  worst differences."""
  params, grads = bench_fixture(torch.device("cuda"))
  state, times, diffs = init(params), [], []
  for step in range(DIST_STEPS):
    g = grads()
    torch.cuda.synchronize()
    start = time.perf_counter()
    u, state = opt.update(g, state, params)
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - start))
    got_u, got_r = kept[step]
    diffs.append((_worst((got_u[n], u[n]) for n in u),
                  _worst(zip(got_r, _roots(state)))))
  return dict(single_step_ms=times,
              max_update_diff=max(d[0][0] for d in diffs),
              max_root_diff=max(d[1][0] for d in diffs),
              within_tolerance=all(d[0][1] and d[1][1] for d in diffs))


def _roots(state):
  """Every root of a state, in its order: the global rows of a sharded
  state, else each param's stacks."""
  if isinstance(state.stats, dict):
    return [r for ps in state.stats.values() for r in ps.preconditioners]
  return [state.stats.global_stats.preconditioners]


def _check_accepted(label, metrics):
  errors = torch.cat([m.error for m in metrics if m is not None])
  check(not bool(torch.isnan(errors).any()) and errors.max().item() < 0.1,
        f"{label}: the failure gate rejected roots (max error "
        f"{errors.max().item()})")


def dist_batch_axis_rank(rank, world):
  """(j1) on one rank: `distributed_shampoo(**HYPERS, batch_axis_name=
  "batch")` on the bench fixture, roots every step, each rank solving its
  slice of each exponent group.  Rank 0 then runs the one-process
  optimizer on the same fixture and holds every step's updates and roots
  to it."""
  device = torch.device("cuda")
  pth_root.require_true_f32()
  params, grads = bench_fixture(device)
  opt = shampoo.distributed_shampoo(**HYPERS, batch_axis_name="batch")

  def init():
    state = opt.init(params)
    exponents = [2 * len(ps.statistics) for ps in state.stats.values()
                 for s in ps.statistics for _ in range(s.shape[0])]
    return state, _expected_split(exponents, world)

  kept = []

  def keep(updates, state):
    _check_accepted("(j1)", [ps.training_metrics
                             for ps in state.stats.values()])
    if rank == 0:
      kept.append(_to_host(updates, _roots(state)))

  run = _timed_dist_steps(f"(j1) rank {rank}", opt, init, params, grads,
                          keep)
  state = run.pop("state")
  out = dict(run, rank=rank, world=world, backend=dist.get_backend())
  # The all-gather of this rank's half of the p = 4 roots alone.
  shards = mesh.process_group_shards(None)
  half = _roots(state)[-1].new_zeros((run["members"][-1],) + tuple(
      _roots(state)[-1].shape[1:]))
  del state
  gather_ms = []
  for _ in range(GATHER_REPS):
    torch.cuda.synchronize()
    start = time.perf_counter()
    mesh.all_gather_rows(half, shards)
    torch.cuda.synchronize()
    gather_ms.append(1e3 * (time.perf_counter() - start))
  out["gather_ms"] = gather_ms
  del half
  if rank == 0:
    single = shampoo.distributed_shampoo(**HYPERS)
    out.update(_single_run(single, single.init, kept))
  kept.clear()
  dist.barrier()
  return out


def dist_sharded_rank(rank, world):
  """(j2) on one rank: `shard_optimizer_states` with both specs over a
  mesh of the ranks and `num_devices_for_pjit=world`: the rank holds its
  rows of the global statistics and roots.  Rank 0 then runs a one-rank
  sharded run (no mesh: every row on one rank) and holds each step's
  updates and the gathered roots to it."""
  device = torch.device("cuda")
  pth_root.require_true_f32()
  spec = mesh.sharding(mesh.make_mesh((world,), ("d",)), "d")
  options = dict(HYPERS, shard_optimizer_states=True,
                 num_devices_for_pjit=world)
  opt = shampoo.distributed_shampoo(**options, statistics_partition_spec=spec,
                                    preconditioner_partition_spec=spec)
  shards = mesh.shard_group(spec)
  params, grads = bench_fixture(device)
  held = {}

  def init():
    state = opt.init(None).init_fn(params)
    g = state.stats.global_stats
    held.update(rows=state_bytes([g.statistics, g.preconditioners]),
                exponents=state_bytes(g.exponents),
                local=state_bytes(state.stats.local_stats))
    check(held["rows"] * world == JAX_SHARDED_ROOT_BYTES,
          f"(j2) rank {rank}: {held['rows']} B of statistics and roots, not "
          f"1/{world} of JAX's {JAX_SHARDED_ROOT_BYTES} B")
    check(held["rows"] * world + held["exponents"] + held["local"] + 4
          == JAX_SHARDED_STATE_BYTES,
          f"(j2) rank {rank}: {held} do not add up to JAX's "
          f"{JAX_SHARDED_STATE_BYTES} B")
    per = g.statistics.shape[0]
    return state, _runs_of(g.exponents[rank * per:(rank + 1) * per].tolist())

  kept = []

  def keep(updates, state):
    _check_accepted("(j2)", [ls.training_metrics
                             for ls in state.stats.local_stats.values()])
    full = mesh.all_gather_rows(state.stats.global_stats.preconditioners,
                                shards)
    if rank == 0:
      kept.append(_to_host(updates, [full]))

  run = _timed_dist_steps(f"(j2) rank {rank}", opt, init, params, grads,
                          keep)
  del run["state"]
  out = dict(run, rank=rank, world=world, state_bytes=held)
  if rank == 0:
    single = shampoo.distributed_shampoo(**options)
    out.update(_single_run(single, single.init(None).init_fn, kept))
  kept.clear()
  dist.barrier()
  return out


def _log_ranks(label, results):
  for r in results:
    log(f"  {label} rank {r['rank']} of {r['world']}: Newton launches "
        f"{r['launches']} of {r['members']} members a step; step times "
        f"{[round(t, 3) for t in r['step_ms']]} ms; peak memory of the "
        f"updates {r['peak_bytes'] / 2**30:.3f} GiB, of which "
        f"{r['base_bytes'] / 2**30:.3f} GiB were held before the steps"
        + (f"; state {r['state_bytes']} B" if "state_bytes" in r else ""))
  first = results[0]
  log(f"  {label} against one rank: largest root difference "
      f"{first['max_root_diff']:.3e}, largest update difference "
      f"{first['max_update_diff']:.3e} (rtol {RTOL}, atol {ATOL}); its "
      f"step times {[round(t, 3) for t in first['single_step_ms']]} ms")
  if "gather_ms" in first:
    log(f"  {label} one all-gather of a rank's p = 4 roots: "
        f"{[[round(t, 3) for t in r['gather_ms']] for r in results]} ms")
  check(first["within_tolerance"],
        f"{label}: the ranks' roots or updates differ from one rank's "
        f"beyond rtol {RTOL}, atol {ATOL}")


# Phase (k): the LM trained on the card, at the widths of bench.py's
# transformer-shaped tree (so its optimizer share compares with (c)'s).
LM_CONFIG = dict(vocab_size=8192, d_model=1024, n_heads=16, n_layers=4,
                 d_ff=4096, max_seq_len=1024)
LM_PARAMS = 68_166_656
# __graft_entry__.py's options but the learning rate: RMSProp grafting
# without bias correction first steps 31.6 lr an entry, against kernels of
# std 1/sqrt(1024).  On this batch the loss climbs at 3e-3 and bounces at
# 3e-5 and 1e-5; at 3e-6 it falls at every step (PERF.md §6).
LM_HYPERS = dict(learning_rate=3e-6, block_size=128,
                 start_preconditioning_step=0,
                 graft_type=shampoo.GraftingType.RMSPROP)
LM_BATCH = (8, 1025)
LM_STEPS = 6
# Newton members a launch, each step: the 9 norm scales' 72 statistics at
# p=2; the blocks' 6,144 and pos_embed's 128 at p=4 (the 8192-row
# embedding and unembedding are grafted only).
LM_CENSUS = (72, 6272)
# The H100 SXM's dense bf16 tensor-core rate (NVIDIA's data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
DECODE_POSITIONS = 8
# tests/test_torch_transformer.py's bf16 tolerance: 2e-2 of the largest
# logit.
BF16_ATOL = 2e-2
# The small LM held to the CPU path, at tests/test_torch_train_loop.py's
# options and train-step tolerances (f32 activations): losses rtol 1e-5,
# each step's parameter change rtol 1e-3, atol 1e-4 of its largest entry.
SMALL_LM = dict(vocab_size=512, d_model=128, n_heads=4, n_layers=2,
                d_ff=512, max_seq_len=64, dtype=torch.float32)
SMALL_LM_HYPERS = dict(learning_rate=3e-4, block_size=32,
                       start_preconditioning_step=0,
                       graft_type=shampoo.GraftingType.RMSPROP)
LOSS_RTOL, STEP_RTOL, STEP_ATOL = 1e-5, 1e-3, 1e-4


def lm_flops(cfg, tokens: int) -> float:
  """A training step's operations: 6 N T for the weights' products and 12
  L t d T for attention's (PaLM's appendix B count)."""
  n = sum(math.prod(s) for s in transformer.param_shapes(cfg).values())
  return (6 * n * tokens
          + 12 * cfg.n_layers * cfg.max_seq_len * cfg.d_model * tokens)


def _lm_batch(cfg, shape, seed, device):
  return {"tokens": torch.randint(
      0, cfg.vocab_size, shape,
      generator=torch.Generator().manual_seed(seed)).to(device)}


def _timed(tx, spans):
  """``tx`` whose update records a CUDA event before and after itself into
  ``spans``."""
  def update(grads, state, params):
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    out = tx.update(grads, state, params)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    spans.append((start, end))
    return out
  return shampoo.GradientTransformation(tx.init, update)


def lm_decode_check(params, cfg, batch):
  """`decode_step` over the first positions of two rows against
  `forward`'s logits there; returns the largest difference."""
  tokens = batch["tokens"][:2, :DECODE_POSITIONS]
  with torch.no_grad():
    full = transformer.forward(params, tokens, cfg)
  caches = transformer.init_cache(cfg, 2, max_len=DECODE_POSITIONS,
                                  device=tokens.device)
  worst = 0.0
  for pos in range(DECODE_POSITIONS):
    logits, caches = transformer.decode_step(params, caches, tokens[:, pos],
                                             pos, cfg)
    worst = max(worst, float((logits - full[:, pos]).abs().max()))
  bound = BF16_ATOL * float(full.abs().max())
  check(worst <= bound, f"(k) decode differs from forward by {worst} > "
        f"{bound}")
  return worst, bound


def lm_card_against_cpu(device):
  """3 train steps of the small LM on the card and on the CPU path from
  the same params and batches; returns the largest loss and step
  differences."""
  cfg = transformer.TransformerConfig(**SMALL_LM)
  start = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
  batches = [_lm_batch(cfg, (4, 65), 2 + i, "cpu") for i in range(3)]

  def run(dev):
    params = {k: v.to(dev, copy=True) for k, v in start.items()}
    tx = shampoo.distributed_shampoo(**SMALL_LM_HYPERS)
    state = tx.init(params)
    step = loop.make_train_step(
        lambda p, b: transformer.loss_fn(p, b, cfg), tx)
    out = []
    for b in batches:
      before = {k: v.clone() for k, v in params.items()}
      loss, params, state = step(params, state,
                                 {k: v.to(dev) for k, v in b.items()})
      out.append((float(loss), {k: (params[k] - before[k]).cpu()
                                for k in params}))
    return out

  loss_diff = step_diff = 0.0
  for (card_loss, card_step), (cpu_loss, cpu_step) in zip(run(device),
                                                         run("cpu")):
    loss_diff = max(loss_diff, abs(card_loss - cpu_loss) / abs(cpu_loss))
    check(abs(card_loss - cpu_loss) <= LOSS_RTOL * abs(cpu_loss),
          f"(k) small LM: card loss {card_loss} against CPU {cpu_loss}")
    for name, want in cpu_step.items():
      diff = (card_step[name] - want).abs()
      step_diff = max(step_diff, float(diff.max() / want.abs().max()))
      check(bool((diff <= STEP_ATOL * want.abs().max()
                  + STEP_RTOL * want.abs()).all()),
            f"(k) small LM: {name}'s step on the card differs from the CPU "
            f"path's by {float(diff.max())}")
  return loss_diff, step_diff


def lm_root_check(state):
  """The Newton kernel against its twin on the LM's own statistics after
  its last step: each exponent group stacked as the solve batched it (the
  params in the state's order, each param's statistics axis-major), with
  the max_evs that solve used (its metrics' ``max_eigenvalue``), through
  `compare` (RTOL, ATOL and the true residual).  Returns the largest
  |kernel - twin| of each group."""
  groups = {}
  for ps in state.stats.values():
    if ps.statistics:
      stats, evs = groups.setdefault(2 * len(ps.statistics), ([], []))
      stats.extend(ps.statistics)
      evs.append(ps.training_metrics.max_eigenvalue)
  sizes = tuple(sum(s.shape[0] for s in groups[p][0]) for p in sorted(groups))
  check(sizes == LM_CENSUS, f"(k) statistics groups of {sizes}, expected "
        f"{LM_CENSUS}")
  m = max(s.shape[-1] for stats, _ in groups.values() for s in stats)
  out = {}
  for p, (stats, evs) in sorted(groups.items()):
    batch = torch.cat([shape_utils.pad_square_stack(s, m) for s in stats])
    pads = torch.cat([torch.full((s.shape[0],), s.shape[-1],
                                 dtype=torch.int32, device=batch.device)
                      for s in stats])
    name = f"[{batch.shape[0]},{m},{m}] p={p}"
    out[name] = compare(f"(k) the LM's statistics {name}",
                        batch.contiguous(), p, pads=pads,
                        max_evs=torch.cat(evs).contiguous())[0]
  return out


def phase_lm(device):
  """(k): the 68.2M-parameter LM trained 6 steps on one fixed batch
  through `train.loop.make_train_step` and `distributed_shampoo`, roots
  every step.  Returns its record; the Newton launches are counted from
  0 over the 6 steps alone, and the kernel is then held to its twin on
  the last step's statistics."""
  log(f"(k) the LM trained on the card: {card_name_and_power()}")
  cfg = transformer.TransformerConfig(**LM_CONFIG)
  params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   device=device)
  n = sum(p.numel() for p in params.values())
  check(n == LM_PARAMS, f"(k) {n} parameters, not {LM_PARAMS}")
  batch = _lm_batch(cfg, LM_BATCH, 1, device)
  tokens = LM_BATCH[0] * (LM_BATCH[1] - 1)
  starts, spans = [], []

  def loss_fn(p, b):
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    starts.append(start)
    return transformer.loss_fn(p, b, cfg)

  tx = shampoo.distributed_shampoo(**LM_HYPERS)
  state = tx.init(params)
  step = loop.make_train_step(loss_fn, _timed(tx, spans))
  sizes = _recorded_newton_sizes()
  losses, step_ms, members = [], [], []
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  newton_root.LAUNCHES = matmul_chain.LAUNCHES = 0
  for i in range(LM_STEPS):
    sizes.clear()
    start = time.perf_counter()
    loss, params, state = step(params, state, batch)
    torch.cuda.synchronize()
    step_ms.append(1e3 * (time.perf_counter() - start))
    losses.append(float(loss))
    members.append(sorted(sizes))
    _check_accepted(f"(k) step {i}", [ps.training_metrics
                                      for ps in state.stats.values()])
  launches = newton_root.LAUNCHES
  peak = torch.cuda.max_memory_allocated()
  check(all(math.isfinite(x) for x in losses), f"(k) losses {losses}")
  check(losses[-1] < losses[0], f"(k) the loss did not fall: {losses}")
  check(all(m == sorted(LM_CENSUS) for m in members),
        f"(k) Newton batches {members}, expected {sorted(LM_CENSUS)} a step")
  check(launches == len(LM_CENSUS) * LM_STEPS,
        f"(k) {launches} Newton launches in {LM_STEPS} steps")
  check(matmul_chain.LAUNCHES == 0, "(k) the matmul chain ran")
  fwd_bwd_ms = [s.elapsed_time(e) for s, (e, _) in zip(starts, spans)]
  opt_ms = [s.elapsed_time(e) for s, e in spans]
  step_s = float(np.median(step_ms[1:])) / 1e3
  flops = lm_flops(cfg, tokens)
  out = dict(
      losses=losses, step_ms=step_ms, fwd_bwd_ms=fwd_bwd_ms, opt_ms=opt_ms,
      median_step_ms=1e3 * step_s,
      median_fwd_bwd_ms=float(np.median(fwd_bwd_ms[1:])),
      median_opt_ms=float(np.median(opt_ms[1:])), tokens_per_s=tokens / step_s,
      train_mfu=flops / (step_s * PEAK_BF16_FLOPS),
      mfu_formula="(6 N T + 12 L t d T) / (step_s * 989e12)",
      step_flops=flops, peak_bytes=peak, launches=launches,
      members_per_launch=members[-1])
  log(f"  losses {[round(x, 4) for x in losses]}")
  log(f"  medians of steps 2-{LM_STEPS}: step {out['median_step_ms']:.3f} "
      f"ms (host clock to a synchronize), forward+backward "
      f"{out['median_fwd_bwd_ms']:.3f} ms, optimizer update "
      f"{out['median_opt_ms']:.3f} ms (CUDA events); "
      f"{out['tokens_per_s']:.0f} tokens/s; train_mfu "
      f"{out['train_mfu']:.4f} = {out['mfu_formula']} with N={LM_PARAMS}, "
      f"T={tokens}, L={cfg.n_layers}, t={cfg.max_seq_len}, "
      f"d={cfg.d_model}; peak {peak / 2**30:.3f} GiB")
  log(f"  Newton launches {launches}: {members[-1]} members a step")
  out["root_max_diff"] = lm_root_check(state)
  # One more step under the profiler, after the counts were read.
  out["profiled_step"] = profile_call(lambda: step(params, state, batch))
  log(f"  profiled step: {out['profiled_step']}")
  out["decode_max_diff"], out["decode_bound"] = lm_decode_check(params, cfg,
                                                                batch)
  del params, state
  log(f"  decode_step against forward at {DECODE_POSITIONS} positions: "
      f"{out['decode_max_diff']:.3e} (bound {out['decode_bound']:.3e})")
  out["small_loss_diff"], out["small_step_diff"] = lm_card_against_cpu(device)
  log(f"  small LM, 3 steps, card against the CPU path: loss "
      f"{out['small_loss_diff']:.3e} relative, steps "
      f"{out['small_step_diff']:.3e} of the largest entry (rtol {STEP_RTOL}, "
      f"atol {STEP_ATOL})")
  return out


# Phase (k2): the data-parallel train step on the card at 2 layers (43.0M
# parameters), f32 activations, held to one process on the full batch in
# two parts, each at the small LM's tolerances: the ranks' all-reduced
# gradients against one process's, and the ranks' steps against the
# one-process optimizer fed the ranks' gradients.  The steps are not held
# end to end: ranks forward half the batch, which rounds otherwise than
# the whole, and RMSProp's first steps are sign-like (g / (sqrt(0.001 g^2)
# + 1e-10) is 31.6 wherever |g| >> 3e-9), so an entry whose gradient sums
# to about 0 takes its step of either sign.  The end-to-end differences
# beyond the tolerance are printed beside their gradients.
LM_DIST_LAYERS = 2
LM_DIST_STEPS = 2


def _lm_dist_modes(world, spec):
  return {"batch_axis": dict(batch_axis_name="batch"),
          "sharded": dict(shard_optimizer_states=True,
                          num_devices_for_pjit=world,
                          statistics_partition_spec=spec,
                          preconditioner_partition_spec=spec)}


def _recording(tx, record, feed=None):
  """``tx`` whose update appends the gradients it applies to ``record``:
  its own, or in their place the next of ``feed``."""
  def update(grads, state, params):
    if feed is not None:
      grads = feed[len(record)]
    record.append({k: g.detach().clone() for k, g in grads.items()})
    return tx.update(grads, state, params)
  return shampoo.GradientTransformation(tx.init, update)


def _lm_dist_config():
  return transformer.TransformerConfig(
      **dict(LM_CONFIG, n_layers=LM_DIST_LAYERS), dtype=torch.float32)


def _lm_one_process(mode, start, batch, feed=None):
  """(k2)'s optimizer on one process: LM_DIST_STEPS steps on the full
  batch from ``start`` (the sharded mode's state on one process for the
  sharded state), fed ``feed``'s gradients where given.  Returns the
  losses, each step's parameter changes on the host and the gradients
  applied."""
  cfg = _lm_dist_config()
  single = shampoo.distributed_shampoo(
      **LM_HYPERS, shard_optimizer_states=(mode == "sharded"))
  params = {k: v.clone() for k, v in start.items()}
  state = (single.init(None).init_fn(params) if mode == "sharded"
           else single.init(params))
  grads = []
  step = loop.make_train_step(lambda p, b: transformer.loss_fn(p, b, cfg),
                              _recording(single, grads, feed))
  losses, deltas = [], []
  for _ in range(LM_DIST_STEPS):
    before = {k: v.clone() for k, v in params.items()}
    loss, params, state = step(params, state, batch)
    losses.append(float(loss))
    deltas.append({k: (params[k] - before[k]).cpu() for k in params})
  return losses, deltas, grads


def _outside(got, want):
  """The entries of ``got`` beyond STEP_ATOL of ``want``'s largest entry
  plus STEP_RTOL of their own, and the largest difference as a fraction
  of that largest entry."""
  diff = (got - want).abs()
  top = float(want.abs().max())
  return (diff > STEP_ATOL * top + STEP_RTOL * want.abs(),
          float(diff.max()) / max(top, 1e-30))


def lm_against_one_process(mode, start, batch, losses, deltas, grads):
  """(k2)'s checks on rank 0: the ranks' losses, all-reduced gradients and
  steps (``grads``, ``deltas``) against one process's.  Returns the
  record's fields; ``beyond`` lists, for each step and param whose
  end-to-end step has entries beyond the tolerance, how many there are,
  the largest difference as a fraction of the param's largest step
  entry, and the largest summed gradient among them as a fraction of the
  param's largest."""
  one_losses, one_deltas, one_grads = _lm_one_process(mode, start, batch)
  _, fed_deltas, _ = _lm_one_process(mode, start, batch, feed=grads)
  loss_diff = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
  ok = loss_diff <= LOSS_RTOL
  grad_diff = step_diff = 0.0
  beyond = []
  for i in range(LM_DIST_STEPS):
    for name, got in deltas[i].items():
      summed = grads[i][name].cpu()
      bad, diff = _outside(summed, one_grads[i][name].cpu())
      ok, grad_diff = ok and not bool(bad.any()), max(grad_diff, diff)
      bad, diff = _outside(got, fed_deltas[i][name])
      ok, step_diff = ok and not bool(bad.any()), max(step_diff, diff)
      bad, diff = _outside(got, one_deltas[i][name])
      if bool(bad.any()):
        fraction = summed.abs() / summed.abs().max()
        beyond.append((i + 1, name, int(bad.sum()), diff,
                       float(fraction[bad].max())))
  return dict(loss_diff=loss_diff, grad_diff=grad_diff, step_diff=step_diff,
              beyond=beyond, within_tolerance=ok)


def lm_dist_rank(rank, world):
  """(k2) on one rank: both modes' train steps over a ``(world, 1)`` mesh
  on the global batch; rank 0 then holds them to one process
  (`lm_against_one_process`)."""
  device = torch.device("cuda")
  pth_root.require_true_f32()
  cfg = _lm_dist_config()
  start = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  device=device)
  batch = _lm_batch(cfg, LM_BATCH, 1, device)
  grid = mesh.make_mesh((world, 1), ("data", "model"),
                        device_type=device.type)
  modes = _lm_dist_modes(world, mesh.sharding(grid, ("data", "model")))
  out = dict(rank=rank, world=world, backend=dist.get_backend())
  for mode, options in modes.items():
    tx = shampoo.distributed_shampoo(**LM_HYPERS, **options)
    params = mesh.shard_params({k: v.clone() for k, v in start.items()},
                               grid, transformer.TP_RULES)
    state = (tx.init(None).init_fn(params) if mode == "sharded"
             else tx.init(params))
    grads = []
    step = loop.make_sharded_train_step(
        lambda p, b: transformer.loss_terms(p, b, cfg),
        _recording(tx, grads), grid, transformer.TP_RULES)
    newton_root.LAUNCHES = 0
    losses, times, deltas = [], [], []
    for _ in range(LM_DIST_STEPS):
      before = {k: v.clone() for k, v in params.items()}
      dist.barrier()
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      loss, params, state = step(params, state, batch)
      torch.cuda.synchronize()
      times.append(1e3 * (time.perf_counter() - t0))
      losses.append(float(loss))
      deltas.append({k: (params[k] - before[k]).cpu() for k in params})
    del params, state, before
    record = dict(losses=losses, step_ms=times, launches=newton_root.LAUNCHES)
    if rank == 0:
      record.update(lm_against_one_process(mode, start, batch, losses,
                                           deltas, grads))
    del grads
    out[mode] = record
    torch.cuda.empty_cache()
    dist.barrier()
  return out


def phase_lm_distribution():
  """(k2): 2 gloo ranks on the one card, then 1 NCCL rank.  Returns the
  Newton launches of the ranks' steps and their records."""
  log(f"(k2) the LM's data-parallel train step: {card_name_and_power()}")
  launches, out = 0, {}
  for label, world, backend in (("(k2)", DIST_RANKS, "gloo"),
                                ("(k2) NCCL", 1, "nccl")):
    results = local.run_local_ranks(lm_dist_rank, world, backend=backend,
                                    timeout=DIST_TIMEOUT_S,
                                    join_timeout=900.0)
    for mode in ("batch_axis", "sharded"):
      for r in results:
        rec = r[mode]
        log(f"  {label} {mode} rank {r['rank']} of {world}: losses "
            f"{[round(x, 5) for x in rec['losses']]}, step times "
            f"{[round(t, 3) for t in rec['step_ms']]} ms, Newton launches "
            f"{rec['launches']}")
        launches += rec["launches"]
      first = results[0][mode]
      log(f"  {label} {mode} against one process: loss "
          f"{first['loss_diff']:.3e} relative (rtol {LOSS_RTOL}) on the "
          f"full batch; all-reduced gradients {first['grad_diff']:.3e} of "
          f"the largest entry against its gradients, steps "
          f"{first['step_diff']:.3e} against its optimizer fed the ranks' "
          f"gradients (rtol {STEP_RTOL}, atol {STEP_ATOL}); end-to-end "
          "steps beyond that tolerance (step, param, entries, largest "
          "difference of the largest entry, largest summed gradient among "
          f"them of the largest): {first['beyond']}")
      check(first["within_tolerance"],
            f"{label} {mode}: the ranks' losses or steps differ from one "
            "process's beyond the tolerance")
      check(all(r[mode]["losses"] == first["losses"] for r in results),
            f"{label} {mode}: the ranks' losses differ")
    out[label] = results
  return launches, out


def card_name_and_power() -> str:
  """nvidia-smi's name and power limit of the card."""
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True,
      timeout=60).stdout.strip().splitlines()[0]


def phase_distribution():
  """(j): the batch axis over 2 gloo ranks and over 1 NCCL rank, and the
  memory-sharded state over 2 gloo ranks, on the one card.  Returns the
  Newton launches of their runs and the per-rank results."""
  log(f"(j) distribution on one card: {card_name_and_power()}")
  launches = 0
  out = {}
  for label, fn, world, backend in (
      ("(j1)", dist_batch_axis_rank, DIST_RANKS, "gloo"),
      ("(j1) NCCL", dist_batch_axis_rank, 1, "nccl"),
      ("(j2)", dist_sharded_rank, DIST_RANKS, "gloo")):
    results = local.run_local_ranks(fn, world, backend=backend,
                                    timeout=DIST_TIMEOUT_S,
                                    join_timeout=900.0)
    _log_ranks(label, results)
    launches += sum(r["launches"] for r in results)
    out[label] = results
  return launches, out


def main():
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA GPU: "
                     "torch.cuda.is_available() is False")
  device = torch.device("cuda", 0)
  pth_root.require_true_f32()
  clock = {}
  run_start = time.perf_counter()

  def phase(label, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds logged on a line of their own."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    clock[label] = time.perf_counter() - start
    log(f"phase {label} took {clock[label]:.1f} s")
    return out

  build_s = phase("(a)", phase_build)
  max_err, timings, chain, solvers = phase("(b)", phase_kernel, device)
  main_path, f32_updates = phase("(c)", phase_main_path, device)
  reduced = phase("(c2)", phase_memory_reduced, device, f32_updates,
                  main_path["state_bytes"])
  del f32_updates
  def phase_sketchy():
    log("(c3) Sketchy: frequent_directions with compression_rank=32 on the "
        "bench fixture")
    # An FD step's SVD takes seconds (PERF.md), so 2 steps, the second
    # reading the first's sketch.
    out = phase_compressed("(c3)", device, 2, frequent_directions=True)
    out["library_ms"] = linalg_timings(device)
    return out

  sketchy = phase("(c3)", phase_sketchy)
  log("(c4) low-rank roots: compression_rank=32 on the bench fixture")
  low_rank = phase("(c4)", phase_compressed, "(c4)", device, 2,
                   frequent_directions=False)
  sm3_run = phase("(g)", phase_sm3, device)
  tearfree_runs = phase("(h)", phase_tearfree, device)
  tearfree_runs["sketchy"] = phase("(i)", phase_tearfree_sketchy, device)
  phase("(d)", phase_trainer, device)
  probe_launches = phase("(e)", phase_probe)
  dist_launches, distribution = phase("(j)", phase_distribution)
  lm = phase("(k)", phase_lm, device)
  lm_dist_launches, lm_distribution = phase("(k2)", phase_lm_distribution)
  log("(f) card")
  tf32 = torch.backends.cuda.matmul.allow_tf32
  check(not tf32, "TF32 matmuls are on")
  log(f"  torch.backends.cuda.matmul.allow_tf32={tf32}; torch "
      f"{torch.__version__}, CUDA {torch.version.cuda}")
  smi = card_name_and_power()
  main = timings["[6144,128,128] p=4"]
  log(json.dumps({"main_path": {"build_s": build_s, **main_path},
                  "memory_reduced": reduced,
                  "sketchy_fd": sketchy, "low_rank": low_rank,
                  "sm3": sm3_run, "tearfree": tearfree_runs,
                  "distribution": distribution,
                  "lm_training": lm, "lm_distribution": lm_distribution,
                  "newton_root_timings": timings,
                  "per_matrix_solvers": solvers,
                  "matmul_chain_timing": chain,
                  "phase_seconds": clock,
                  "total_seconds": time.perf_counter() - run_start}))
  log(json.dumps({"kernels": [{
      "name": "newton_root", "route": "cuda", "source": SOURCES["newton_root"],
      "replaces": REPLACES["newton_root"],
      "launches": (main_path["launches"] + reduced["launches"]
                   + tearfree_runs["filtered"]["launches"]
                   + tearfree_runs["newton"]["launches"] + dist_launches
                   + lm["launches"] + lm_dist_launches),
      "max_abs_err": max(max_err, *lm["root_max_diff"].values()),
      "ms": main["ms"], "plain_ms": main["plain_ms"],
      "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
      # No single PyTorch call computes a batched inverse p-th root.
      "library_ms": None, "path": main["path"],
      "driven_by": "distributed_shampoo, 5 steps; the same with "
                   "best_effort_memory_usage_reduction, 5 steps; tearfree "
                   "filtered and newton, 5 steps each; (j) the batch axis "
                   "over 2 gloo ranks, 3 steps, and 1 NCCL rank, 3 steps, "
                   "and the memory-sharded state over 2 gloo ranks, 3 "
                   "steps; (k) the 68.2M LM trained through "
                   "train.loop.make_train_step, 6 steps; (k2) its 2-layer "
                   "data-parallel step over 2 gloo ranks and 1 NCCL rank, "
                   "the batch axis and the sharded state, 2 steps each"}, {
      "name": "matmul_chain", "route": "cuda",
      "source": SOURCES["matmul_chain"],
      "replaces": REPLACES["matmul_chain"],
      "launches": probe_launches["matmul_chain"],
      "max_abs_err": chain["max_abs_err"], "ms": chain["ms"],
      "plain_ms": chain["plain_ms"], "bound_ms": chain["bound_ms"],
      "bound_by": chain["bound_by"],
      # No single PyTorch call computes the renormalised chain.
      "library_ms": None, "path": chain["path"],
      "driven_by": "tile_breakdown.measure, [712|6144,128,128] p=4"}]}))
  log(smi)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
  sys.exit(main())
