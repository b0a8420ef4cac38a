"""The port's CUDA kernels against their plain-PyTorch twins, on a card.

Every test here needs a CUDA GPU and skips without one.  The file imports
torch alone, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: roots rtol 1e-3 / atol 1e-5 (the JAX package's own kernel
tolerance, `tests/test_pallas_kernels.py:59`; both sides are f32 with sums
in other orders), ladder rounds equal, iterations within 1.  The matmul
chain is held to its twin at the same rtol 1e-3 / atol 1e-5.  The Newton
tests above it also guard the resident product code that both kernels
share (`csrc/resident_gemm.cuh`).  The optimizer's options on the card
(ragged blocks, quantized state, eigh, the batched torch solver, detailed
metrics) are held to the same optimizer on the CPU: updates rtol 1e-3 /
atol 1e-4 * max|x|, 2 * max|x| / 127 in the quantized mode (an int8 code
may round the other way on one side).  Quantization on the card equals the
CPU's bit for bit.  The compressed solves on the card (cuSOLVER's SVD and
eigh) are held to LAPACK on the CPU, their packed roots as operators
(tolerances in the test).
"""

import pytest
import torch

from precondition_tpu_torch.ops import pth_root
from precondition_tpu_torch.ops.kernels import matmul_chain
from precondition_tpu_torch.ops.kernels import newton_root
from precondition_tpu_torch.optim import shampoo
from precondition_tpu_torch.utils.quantization import QuantizedValue

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def _psd(n, m, dev, seed=0):
  gen = torch.Generator(device=dev).manual_seed(seed)
  a = torch.randn(n, m, m, generator=gen, device=dev)
  return torch.bmm(a, a.transpose(1, 2)) / m + 0.1 * torch.eye(m, device=dev)


def _assert_matches_twin(stats, p, pads=None, **kw):
  before = newton_root.LAUNCHES
  r_k, m_k = newton_root.batched_inverse_pth_root_cuda(stats, p, pads, **kw)
  assert newton_root.LAUNCHES == before + 1
  r_p, m_p = newton_root.batched_inverse_pth_root_plain(stats, p, pads, **kw)
  torch.cuda.synchronize()
  torch.testing.assert_close(r_k, r_p, rtol=1e-3, atol=1e-5)
  assert torch.equal(m_k.retries, m_p.retries)
  assert (m_k.iterations - m_p.iterations).abs().max() <= 1
  torch.testing.assert_close(m_k.max_eigenvalue, m_p.max_eigenvalue)
  return r_k, m_k


@pytest.mark.parametrize("p", [1, 2, 3, 4, 6, 8])
def test_exponents(dev, p):
  # At m = 128 p = 6 takes the global path, the others the resident one.
  assert newton_root.kernel_path(128, p) == ("global" if p == 6 else
                                             "resident")
  _assert_matches_twin(_psd(64, 128, dev), p)


@pytest.mark.parametrize("m", [1, 8, 17, 96, 100, 127, 128, 129, 200, 1024])
def test_matrix_sizes(dev, m):
  assert newton_root.kernel_path(m, 4) == ("resident" if m <= 128 else
                                           "global")
  _assert_matches_twin(_psd(3, m, dev), 4)


def test_resident_path_has_no_workspace(dev):
  stats = _psd(264, 128, dev)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats(dev)
  base = torch.cuda.memory_allocated(dev)
  roots, _ = newton_root.batched_inverse_pth_root_cuda(
      stats, 4, max_evs=torch.ones(264, device=dev))
  torch.cuda.synchronize()
  # The roots and the [4, N] metrics; a workspace would add 7 x 64 KB per CTA.
  extra = torch.cuda.max_memory_allocated(dev) - base
  assert extra < roots.numel() * 4 + 2 ** 20


def test_mixed_padding(dev):
  n, m = 12, 128
  pads = torch.tensor([128, 96, 0, 17, 1, 128] * 2, dtype=torch.int32,
                      device=dev)
  idx = torch.arange(m, device=dev)
  mask = (idx[None, :] < pads[:, None]).float()
  stats = _psd(n, m, dev) * mask[:, :, None] * mask[:, None, :]
  roots, met = _assert_matches_twin(stats, 4, pads)
  assert bool((roots[2] == 0).all()) and met.error[2] == 0


@pytest.mark.parametrize("p", [2, 4])
def test_warm_start_and_garbage_prev(dev, p):
  n, m = 32, 128
  stats = _psd(n, m, dev)
  cold, _ = newton_root.batched_inverse_pth_root_plain(stats, p)
  drifted = 0.999 * stats + 0.001 * _psd(n, m, dev, seed=1)
  prevs = cold.clone()
  prevs[:4] = 100.0 * _psd(4, m, dev, seed=2)
  _, met = _assert_matches_twin(drifted, p, prevs=prevs)
  assert met.iterations[4:].max() <= 2


def test_retry_ladder(dev):
  n, m = 8, 128
  gen = torch.Generator(device=dev).manual_seed(3)
  q, _ = torch.linalg.qr(torch.randn(n, m, m, generator=gen, device=dev,
                                     dtype=torch.float64))
  spectrum = torch.zeros(n, m, dtype=torch.float64, device=dev)
  # Rank-16 Grams with eigenvalues 3e4 and an absolute ridge: the solve
  # fails while cond(A + rI) >= 3e7 and converges at 3e6, a factor 3 from
  # f32's edge near 1e7 on either side, so both sides take 5 rounds.
  spectrum[:, :16] = 3e4
  stats = ((q * spectrum[:, None, :]) @ q.transpose(1, 2)).float()
  r_k, m_k = newton_root.batched_inverse_pth_root_cuda(
      stats.contiguous(), 4, relative_matrix_epsilon=False)
  _, m_p = newton_root.batched_inverse_pth_root_plain(
      stats, 4, relative_matrix_epsilon=False)
  assert bool(torch.isfinite(r_k).all())
  assert bool((m_k.retries == 5).all()) and bool((m_k.error < 0.05).all())
  assert torch.equal(m_k.retries, m_p.retries)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
  stats = _psd(2, 16, dev)
  with pytest.raises(ValueError, match="contiguous"):
    newton_root.batched_inverse_pth_root_cuda(stats.transpose(1, 2), 4)
  with pytest.raises(TypeError, match="float32"):
    newton_root.batched_inverse_pth_root_cuda(stats.double(), 4)


def test_shampoo_update_on_the_card_matches_the_cpu_path(dev):
  shapes = {"w": (256, 384), "norm": (256,)}
  gen = torch.Generator().manual_seed(0)
  params = {n: 0.1 * torch.randn(s, generator=gen) for n, s in shapes.items()}
  grads = [{n: 0.1 * torch.randn(s, generator=gen) for n, s in shapes.items()}
           for _ in range(3)]
  results = {}
  for device in ("cpu", dev):
    opt = shampoo.distributed_shampoo(
        learning_rate=0.1, block_size=128, start_preconditioning_step=0,
        graft_type=shampoo.GraftingType.RMSPROP)
    p = {n: x.to(device) for n, x in params.items()}
    state = opt.init(p)
    before = newton_root.LAUNCHES
    for g in grads:
      upd, state = opt.update({n: x.to(device) for n, x in g.items()}, state,
                              p)
      p = {n: p[n] + upd[n] for n in p}
    results[str(device)] = (p, newton_root.LAUNCHES - before)
  assert results["cpu"][1] == 0 and results[str(dev)][1] == 6
  for n in shapes:
    ref = results["cpu"][0][n]
    torch.testing.assert_close(results[str(dev)][0][n].cpu(), ref, rtol=1e-3,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("n", [1, 133])
@pytest.mark.parametrize("m", [16, 96, 127, 128])
def test_matmul_chain_matches_twin(dev, m, n, p):
  # 133 members over 132 SMs: one CTA takes a second member.
  stats = _psd(n, m, dev)
  before = matmul_chain.LAUNCHES
  got = matmul_chain.matmul_chain_cuda(stats, p, 8)
  assert matmul_chain.LAUNCHES == before + 1
  want = matmul_chain.matmul_chain_plain(stats, p, 8)
  torch.cuda.synchronize()
  assert bool(torch.isfinite(got).all())
  torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)


def test_matmul_chain_wrapper_rejects_what_the_kernel_does_not_take(dev):
  with pytest.raises(ValueError, match="resident rule"):
    matmul_chain.matmul_chain_cuda(_psd(2, 129, dev), 4, 1)
  with pytest.raises(ValueError, match="resident rule"):
    matmul_chain.matmul_chain_cuda(_psd(2, 16, dev), 6, 1)
  with pytest.raises(ValueError, match="contiguous"):
    matmul_chain.matmul_chain_cuda(_psd(2, 16, dev).transpose(1, 2), 4, 1)
  with pytest.raises(TypeError, match="float32"):
    matmul_chain.matmul_chain_cuda(_psd(2, 16, dev).double(), 4, 1)


@pytest.mark.parametrize("dtype,extract_diagonal", [
    (torch.int8, False), (torch.int16, True)])
def test_quantization_on_the_card_equals_the_cpu(dev, dtype, extract_diagonal):
  stats = _psd(64, 128, dev)
  stats[3] = torch.eye(128, device=dev)  # scale 0 divides by 1
  got = QuantizedValue.from_float_value(stats, dtype, extract_diagonal,
                                        batch_dims=1)
  want = QuantizedValue.from_float_value(stats.cpu(), dtype,
                                         extract_diagonal, batch_dims=1)
  for a, b in zip(got.tensors(), want.tensors(), strict=True):
    assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("eigh", [False, True], ids=["newton", "eigh"])
def test_batched_solver_on_the_card_matches_the_cpu(dev, eigh):
  pads = torch.tensor([128, 96, 0, 17] * 4, dtype=torch.int32, device=dev)
  idx = torch.arange(128, device=dev)
  mask = (idx[None, :] < pads[:, None]).float()
  stats = _psd(16, 128, dev) * mask[:, :, None] * mask[:, None, :]
  got, met = pth_root.batched_inverse_pth_root(stats, 4, pads, eigh=eigh)
  want, met_c = pth_root.batched_inverse_pth_root(stats.cpu(), 4, pads.cpu(),
                                                  eigh=eigh)
  torch.testing.assert_close(got.cpu(), want, rtol=1e-3,
                             atol=1e-5 * float(want.abs().max()))
  assert torch.equal(met.retries.cpu(), met_c.retries)


_RAGGED = {"w": (256, 384), "r": (200, 130), "norm": (256,)}


@pytest.mark.parametrize("options", [
    dict(), dict(best_effort_memory_usage_reduction=True),
    dict(eigh=True), dict(solver_backend="xla"),
    dict(generate_detailed_metrics=True),
    dict(best_effort_memory_usage_reduction=True, reuse_preconditioner=True,
         generate_detailed_metrics=True),
], ids=["ragged", "quantized", "eigh", "xla", "detailed", "quantized-warm"])
def test_shampoo_options_on_the_card_match_the_cpu_path(dev, options):
  gen = torch.Generator().manual_seed(0)
  params = {n: 0.1 * torch.randn(s, generator=gen) for n, s in _RAGGED.items()}
  grads = [{n: 0.1 * torch.randn(s, generator=gen)
            for n, s in _RAGGED.items()} for _ in range(3)]
  results = {}
  for device in ("cpu", dev):
    opt = shampoo.distributed_shampoo(
        learning_rate=0.1, block_size=128, start_preconditioning_step=0,
        graft_type=shampoo.GraftingType.RMSPROP, **options)
    p = {n: x.to(device) for n, x in params.items()}
    state = opt.init(p)
    before = newton_root.LAUNCHES
    for g in grads:
      upd, state = opt.update({n: x.to(device) for n, x in g.items()}, state,
                              p)
      p = {n: p[n] + upd[n] for n in p}
    results[str(device)] = (p, newton_root.LAUNCHES - before, state)
  kernel = not options.get("eigh") and options.get("solver_backend") != "xla"
  assert results["cpu"][1] == 0
  assert results[str(dev)][1] == (6 if kernel else 0)
  quantized = options.get("best_effort_memory_usage_reduction", False)
  for n in _RAGGED:
    ref = results["cpu"][0][n]
    scale = float(ref.abs().max())
    torch.testing.assert_close(
        results[str(dev)][0][n].cpu(), ref, rtol=1e-3,
        atol=2 * scale / 127 if quantized else 1e-4 * scale)
  errors = torch.cat([ps.training_metrics.error
                      for ps in results[str(dev)][2].stats.values()])
  assert float(errors.max()) < 0.1


@pytest.mark.parametrize("fd", [False, True], ids=["low-rank", "fd"])
def test_compressed_roots_on_the_card_match_the_cpu(dev, fd):
  """`low_rank_root` and two `fd_update_root` steps on the card against
  the CPU, padded members among them: the packed operators ``U diag(inv)
  U^T + const (I - U U^T)`` and the scalar columns rtol 1e-3 / atol 1e-4
  of the largest entry."""
  from precondition_tpu_torch.ops import lowrank
  gen = torch.Generator().manual_seed(6)
  pads = torch.tensor([128, 100, 128, 64], dtype=torch.int32)
  mask = (torch.arange(128)[None] < pads[:, None]).float()
  rank = 8

  def operators(buf):
    u, inv, const, _ = lowrank.low_rank_unpack(buf, rank)
    return (torch.einsum("nik,nk,njk->nij", u, inv, u) + const[:, None, None]
            * (torch.eye(128) - u @ u.transpose(1, 2)))

  prev = {d: torch.zeros(4, 128, rank + 2, device=d) for d in ("cpu", "cuda")}
  for _ in range(2 if fd else 1):
    g = torch.randn(4, 128, 128, generator=gen) * mask[:, :, None]
    out = {}
    for d in ("cpu", "cuda"):
      if fd:
        factor = lowrank.frequent_directions_update(g.to(d), 0)
        out[d], _ = lowrank.fd_update_root(
            factor, 4, rank, prev[d], decay=0.9,
            padding_starts=pads.to(d))
        prev[d] = out[d]
      else:
        stats = g.to(d) @ g.to(d).transpose(1, 2) / 128
        out[d], _ = lowrank.low_rank_root(stats, 4, rank,
                                          padding_starts=pads.to(d))
    got, want = out["cuda"].cpu(), out["cpu"]
    for a, b in ((operators(got), operators(want)),
                 (got[:, :, rank:], want[:, :, rank:])):
      torch.testing.assert_close(a, b, rtol=1e-3,
                                 atol=1e-4 * b.abs().max().item())
