"""Parity of the port's batched `InversePthRootDiagnostics` with JAX's.

JAX's `create` runs under `vmap` over the same seeded ``[N, m, m]`` roots
and matrices, padded members among them.  The roots are not solved roots
but random symmetric matrices, so ``B^p A - I`` has entries of order one
and a relative tolerance means something: rtol 1e-5 (f32 products summed
in another order), atol 1e-6 for the entries that are zero by masking.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from precondition_tpu.utils import diagnostics as jax_diagnostics
from precondition_tpu_torch.utils import diagnostics

_FIELDS = ("max_diag_error", "avg_diag_error", "max_off_diag_error",
           "avg_off_diag_error", "p")


def _inputs(seed, n, m):
  rng = np.random.RandomState(seed)
  a = rng.randn(n, m, m).astype(np.float32)
  mats = (np.einsum("nij,nkj->nik", a, a) / m).astype(np.float32)
  b = rng.randn(n, m, m).astype(np.float32) / np.sqrt(m)
  roots = (0.5 * (b + b.transpose(0, 2, 1))
           + np.eye(m, dtype=np.float32)).astype(np.float32)
  return roots, mats


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_matches_vmapped_jax(p, padded):
  n, m = 6, 12
  roots, mats = _inputs(p, n, m)
  pads = np.asarray([12, 8, 0, 1, 12, 5] if padded else [m] * n, np.int32)
  for i, d in enumerate(pads):
    for x in (roots, mats):
      x[i, d:, :] = 0.0
      x[i, :, d:] = 0.0
  ref = jax.vmap(lambda r, a, d: jax_diagnostics.InversePthRootDiagnostics
                 .create(r, a, p, padding_start=d))(
                     jnp.asarray(roots), jnp.asarray(mats), jnp.asarray(pads))
  ours = diagnostics.InversePthRootDiagnostics.create(
      torch.from_numpy(roots), torch.from_numpy(mats), p,
      torch.from_numpy(pads) if padded else None)
  for f in _FIELDS:
    np.testing.assert_allclose(getattr(ours, f).numpy(),
                               np.asarray(getattr(ref, f)), rtol=1e-5,
                               atol=1e-6, err_msg=f)
