"""Quantized optimizer state: linear-bucket int8/int16 with per-column scales.

PyTorch counterpart of `precondition_tpu/utils/quantization.py`, with the
same codes, buckets and diagonals bit for bit:

* per-column scale ``max_abs / num_buckets`` with 127 buckets for int8 and
  32767 for int16 (the most-negative code is never produced), computed over
  axis 0 of each value;
* round half to even (`torch.round`, as `jnp.round`), dividing by the
  scale rather than multiplying by its reciprocal; a column whose scale is
  0 divides by 1;
* optional diagonal extraction for square matrices: the diagonal is kept in
  full precision and the off-diagonal residue is quantized;
* ``bfloat16`` and ``float32`` pass through unquantized.

A value may carry leading batch dimensions (``batch_dims``): a ``[B, d, d]``
stack is then quantized matrix by matrix and column by column in one call,
with the numbers of quantizing each matrix alone.  `unbind` splits such a
stack into its members, `stack` joins equal-shape members back into one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

_NUM_BUCKETS = {torch.int8: 127.0, torch.int16: 32767.0}


@dataclasses.dataclass
class QuantizedValue:
  """A tensor stored in quantized form plus what it takes to decode it.

  ``shape`` is the decoded shape, leading batch dimensions included.
  """

  quantized: torch.Tensor
  diagonal: Optional[torch.Tensor]     # full-precision diagonal, if extracted
  bucket_size: Optional[torch.Tensor]  # per-column scale (integer codes only)
  quantized_dtype: torch.dtype
  extract_diagonal: bool
  shape: Tuple[int, ...]
  batch_dims: int = 0

  @classmethod
  def from_float_value(cls, fvalue: torch.Tensor, quantized_dtype,
                       extract_diagonal: bool = False,
                       batch_dims: int = 0) -> "QuantizedValue":
    quantized, diagonal, bucket_size = cls.quantize(
        fvalue, quantized_dtype, extract_diagonal, batch_dims)
    return cls(quantized, diagonal, bucket_size, quantized_dtype,
               extract_diagonal, tuple(fvalue.shape), batch_dims)

  @staticmethod
  def quantize(fvalue: torch.Tensor, quantized_dtype,
               extract_diagonal: bool = False, batch_dims: int = 0):
    """Returns ``(codes, diagonal, bucket_size)``."""
    if quantized_dtype == torch.float32:
      return fvalue, None, None
    if quantized_dtype == torch.bfloat16:
      return fvalue.to(torch.bfloat16), None, None
    if quantized_dtype not in _NUM_BUCKETS:
      raise ValueError(f"Quantized dtype {quantized_dtype} not supported.")
    ndim = fvalue.dim() - batch_dims
    if extract_diagonal and ndim != 2:
      raise ValueError("extract_diagonal requires a 2-D (square) input.")
    if ndim < 1:
      raise ValueError("Cannot quantize a 0-D value.")
    diagonal = None
    if extract_diagonal:
      diagonal = torch.diagonal(fvalue, dim1=-2, dim2=-1)
      fvalue = fvalue - torch.diag_embed(diagonal)
      diagonal = diagonal.clone()
    num_buckets = torch.tensor(_NUM_BUCKETS[quantized_dtype],
                               dtype=fvalue.dtype, device=fvalue.device)
    max_abs = fvalue.abs().amax(dim=batch_dims)
    bucket_size = max_abs / num_buckets
    scale = bucket_size.unsqueeze(batch_dims)
    safe_scale = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    codes = torch.round(fvalue / safe_scale)
    return codes.to(quantized_dtype), diagonal, bucket_size

  def to_float(self) -> torch.Tensor:
    """Decode back to floating point."""
    if self.quantized_dtype == torch.float32:
      return self.quantized
    if self.quantized_dtype == torch.bfloat16:
      return self.quantized.to(torch.float32)
    val = (self.quantized.to(self.bucket_size.dtype)
           * self.bucket_size.unsqueeze(self.batch_dims))
    if self.extract_diagonal:
      val = val + torch.diag_embed(self.diagonal)
    return val

  def tensors(self) -> List[torch.Tensor]:
    """The tensors this value stores."""
    return [t for t in (self.quantized, self.diagonal, self.bucket_size)
            if t is not None]

  def unbind(self) -> List["QuantizedValue"]:
    """The members of a value with one batch dimension, as views."""
    if self.batch_dims != 1:
      raise ValueError("unbind needs exactly one batch dimension")
    parts = [t.unbind(0) if t is not None else [None] * self.shape[0]
             for t in (self.quantized, self.diagonal, self.bucket_size)]
    return [QuantizedValue(q, d, b, self.quantized_dtype,
                           self.extract_diagonal, self.shape[1:])
            for q, d, b in zip(*parts)]

  @staticmethod
  def stack(values: Sequence["QuantizedValue"]) -> "QuantizedValue":
    """Members of one dtype, layout and shape as one batched value."""
    first = values[0]
    if first.batch_dims:
      raise ValueError("stack takes unbatched members")
    cat = lambda ts: None if ts[0] is None else torch.stack(ts)
    return QuantizedValue(
        cat([v.quantized for v in values]), cat([v.diagonal for v in values]),
        cat([v.bucket_size for v in values]), first.quantized_dtype,
        first.extract_diagonal, (len(values),) + tuple(first.shape), 1)
