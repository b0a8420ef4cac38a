"""Decoder-only transformer LM, in PyTorch.

Port of `precondition_tpu/models/transformer.py`: the same parameters, the
same arithmetic in the same dtypes, so that the JAX package's weights run
here (`utils.convert.params_from_numpy`) and give its logits.  Parameters
are a flat dict of ``"/"``-joined names in JAX's flattening order (sorted
keys, blocks by index: ``blocks/0/attn/out``, ``blocks/0/attn/qkv``, ...,
``unembed/kernel``); the one-process solve batches and metrics of the
optimizers follow that order.  `Transformer` is an `nn.Module` over the
same tree whose ``named_parameters()`` are those names with ``.`` for
``/``, so `DistributedShampoo` takes ``model.parameters()`` and the
functional `distributed_shampoo` takes ``model.params()``.

Numerics carried over from JAX, each a place a plain port would drift:
activations in ``cfg.dtype`` (bfloat16) with f32 master weights cast at
each product; GELU in its tanh form (`jax.nn.gelu`'s default); the RMS
norm's variance in f32 and its ``rsqrt`` cast to the activation dtype
before the multiplies; attention logits as a product in the activation
dtype divided by ``sqrt(head_dim)`` after it, masked with ``-1e9``, the
softmax in f32 (plain products: JAX computes attention with einsums, and
`scaled_dot_product_attention` masks and accumulates otherwise);
embeddings gathered in f32 and cast; the logits a true f32 product (TF32
stays off, `ops.pth_root.require_true_f32`).  ``cfg.remat`` recomputes
each block in the backward pass (`torch.utils.checkpoint`, JAX's
`jax.checkpoint`), with the same gradients.

Tensor-parallel rules (`TP_RULES`, for `parallel.mesh.shard_params`) are
JAX's: qkv and mlp-in shard their output axis on ``model``, out-proj and
mlp-out their input axis, the embeddings their vocab axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
  vocab_size: int = 32000
  d_model: int = 512
  n_heads: int = 8
  n_layers: int = 4
  d_ff: int = 2048
  max_seq_len: int = 1024
  dtype: torch.dtype = torch.bfloat16
  remat: bool = True

  @property
  def head_dim(self) -> int:
    return self.d_model // self.n_heads


# Parameter sharding rules: (name regex, partition spec).
TP_RULES = (
    (r"embed/table", ("model", None)),
    (r"attn/qkv", (None, "model")),
    (r"attn/out", ("model", None)),
    (r"mlp/in_proj", (None, "model")),
    (r"mlp/out_proj", ("model", None)),
    (r"unembed/kernel", (None, "model")),
)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
  """Every parameter's shape, by name, in JAX's flattening order."""
  d = cfg.d_model
  block = {"attn/out": (d, d), "attn/qkv": (d, 3 * d),
           "attn_norm/scale": (d,), "mlp/in_proj": (d, cfg.d_ff),
           "mlp/out_proj": (cfg.d_ff, d), "mlp_norm/scale": (d,)}
  shapes = {f"blocks/{i}/{name}": shape for i in range(cfg.n_layers)
            for name, shape in block.items()}
  shapes.update({"embed/table": (cfg.vocab_size, d), "final_norm/scale": (d,),
                 "pos_embed/table": (cfg.max_seq_len, d),
                 "unembed/kernel": (d, cfg.vocab_size)})
  return shapes


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda") -> Params:
  """f32 parameters with JAX's distributions: embeddings N(0, 0.02^2),
  kernels N(0, 1/d_in), norm scales 1.  Drawn from ``generator`` on its
  own device, then moved to ``device``."""
  out = {}
  for name, shape in param_shapes(cfg).items():
    if name.endswith("/scale"):
      value = torch.ones(shape)
    else:
      scale = 0.02 if name.endswith("/table") else 1.0 / math.sqrt(shape[0])
      value = torch.randn(shape, generator=generator,
                          device=generator.device) * scale
    out[name] = value.to(device)
  return out


def _rms_norm(x, scale):
  var = x.float().square().mean(-1, keepdim=True)
  return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale.to(x.dtype)


def _mask_value(x):
  return torch.tensor(-1e9, dtype=x.dtype, device=x.device)


def _scale(x, cfg: TransformerConfig):
  """``sqrt(head_dim)`` in the activation dtype: the logits' divisor."""
  return torch.tensor(math.sqrt(cfg.head_dim), dtype=x.dtype, device=x.device)


def _attention(params: Params, prefix: str, x, cfg: TransformerConfig):
  b, t, d = x.shape
  qkv = torch.einsum("btd,de->bte", x, params[prefix + "qkv"].to(x.dtype))
  qkv = qkv.reshape(b, t, 3, cfg.n_heads, cfg.head_dim)
  q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
  logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / _scale(x, cfg)
  mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
  logits = torch.where(mask, logits, _mask_value(x))
  probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
  ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
  return torch.einsum("btd,de->bte", ctx, params[prefix + "out"].to(x.dtype))


def _mlp(params: Params, prefix: str, x):
  h = torch.einsum("...d,df->...f", x,
                   params[prefix + "in_proj"].to(x.dtype))
  h = F.gelu(h, approximate="tanh")
  return torch.einsum("...f,fd->...d", h,
                      params[prefix + "out_proj"].to(x.dtype))


def _block(params: Params, prefix: str, x, cfg: TransformerConfig):
  x = x + _attention(params, prefix + "attn/",
                     _rms_norm(x, params[prefix + "attn_norm/scale"]), cfg)
  return x + _mlp(params, prefix + "mlp/",
                  _rms_norm(x, params[prefix + "mlp_norm/scale"]))


def _logits(params: Params, x):
  """Final norm, then the true f32 product with the unembedding."""
  x = _rms_norm(x, params["final_norm/scale"])
  return torch.einsum("...d,dv->...v", x.float(), params["unembed/kernel"])


def forward(params: Params, tokens, cfg: TransformerConfig):
  """``tokens [b, t] -> logits [b, t, vocab]`` (logits in f32)."""
  t = tokens.shape[1]
  x = params["embed/table"][tokens].to(cfg.dtype)
  x = x + params["pos_embed/table"][:t].to(cfg.dtype)
  for i in range(cfg.n_layers):
    if cfg.remat:
      x = checkpoint.checkpoint(_block, params, f"blocks/{i}/", x, cfg,
                                use_reentrant=False)
    else:
      x = _block(params, f"blocks/{i}/", x, cfg)
  return _logits(params, x)


def loss_terms(params: Params, batch, cfg: TransformerConfig):
  """Next-token cross entropy as ``(numerator, weight)``: the sum of the
  masked, weighted NLL and the sum of the weights.  The loss is
  ``numerator / max(weight, 1)``; a data-parallel step sums both terms
  over its ranks first, as JAX's jit does over the whole batch."""
  tokens = batch["tokens"]
  logits = forward(params, tokens[:, :-1], cfg)
  targets = tokens[:, 1:].long()
  logp = F.log_softmax(logits, dim=-1)
  nll = -logp.gather(-1, targets[..., None])[..., 0]
  mask = batch.get("target_mask")
  if mask is not None:
    mask = mask[:, 1:].to(nll.dtype)
  else:
    mask = torch.ones_like(nll)
  factors = batch.get("factors")
  if factors is not None:
    mask = mask * factors[:, None].to(nll.dtype)
  return (nll * mask).sum(), mask.sum()


def loss_fn(params: Params, batch, cfg: TransformerConfig):
  """Next-token cross entropy; ``batch = {'tokens': [b, t]}``.

  Optional batch keys: ``target_mask [b, t]`` restricts the loss to masked
  positions; ``factors [b]`` weights each example.
  """
  numerator, weight = loss_terms(params, batch, cfg)
  return numerator / weight.clamp(min=1.0)


# ------------------------------------------------------------- decoding --
def init_cache(cfg: TransformerConfig, batch_size: int,
               max_len: Optional[int] = None,
               device="cuda") -> List[Dict[str, torch.Tensor]]:
  """Per-layer KV cache ``[b, max_len, heads, head_dim]``."""
  shape = (batch_size, max_len or cfg.max_seq_len, cfg.n_heads, cfg.head_dim)
  return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
           "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
          for _ in range(cfg.n_layers)]


def _attention_decode(params: Params, prefix: str, x, cache, pos,
                      cfg: TransformerConfig):
  """Single-position attention against the KV cache, which it writes at
  ``pos`` in place; returns (out, cache)."""
  b = x.shape[0]
  qkv = torch.einsum("bd,de->be", x, params[prefix + "qkv"].to(x.dtype))
  qkv = qkv.reshape(b, 3, cfg.n_heads, cfg.head_dim)
  q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
  cache["k"][:, pos] = k
  cache["v"][:, pos] = v
  logits = torch.einsum("bhd,bkhd->bhk", q, cache["k"]) / _scale(x, cfg)
  t = cache["k"].shape[1]
  mask = torch.arange(t, device=x.device)[None, None, :] <= pos
  logits = torch.where(mask, logits, _mask_value(x))
  probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
  ctx = torch.einsum("bhk,bkhd->bhd", probs, cache["v"]).reshape(b, -1)
  out = torch.einsum("bd,de->be", ctx, params[prefix + "out"].to(x.dtype))
  return out, cache


@torch.no_grad()
def decode_step(params: Params, caches, tokens, pos, cfg: TransformerConfig):
  """One autoregressive step: ``tokens [b]`` at position ``pos``.

  Returns ``(logits [b, vocab], caches)``.  The caches are written in
  place (JAX's donated buffers) and returned; keep using the returned
  ones.
  """
  x = params["embed/table"][tokens].to(cfg.dtype)
  x = x + params["pos_embed/table"][pos].to(cfg.dtype)
  new_caches = []
  for i, cache in enumerate(caches):
    prefix = f"blocks/{i}/"
    attn_out, cache = _attention_decode(
        params, prefix + "attn/",
        _rms_norm(x, params[prefix + "attn_norm/scale"]), cache, pos, cfg)
    x = x + attn_out
    x = x + _mlp(params, prefix + "mlp/",
                 _rms_norm(x, params[prefix + "mlp_norm/scale"]))
    new_caches.append(cache)
  return _logits(params, x), new_caches


class Transformer(nn.Module):
  """The LM as an `nn.Module` whose submodules mirror the parameter tree
  (``blocks.0.attn.qkv`` for ``blocks/0/attn/qkv``), registered in JAX's
  flattening order.  ``params`` (a flat dict, e.g. from
  `utils.convert.params_from_numpy`) are taken as they are; without them
  `init_params` draws new ones from ``generator``."""

  def __init__(self, cfg: TransformerConfig,
               generator: Optional[torch.Generator] = None,
               device="cuda", params: Optional[Params] = None):
    super().__init__()
    self.cfg = cfg
    if params is None:
      params = init_params(cfg, generator or torch.Generator(), device)
    for name, value in params.items():
      module = self
      *parents, leaf = name.split("/")
      for key in parents:
        if key not in module._modules:
          module.add_module(key, nn.Module())
        module = module._modules[key]
      module.register_parameter(leaf, nn.Parameter(value))

  def params(self) -> Params:
    """The parameters as the functional form's flat dict."""
    return {n.replace(".", "/"): p for n, p in self.named_parameters()}

  def forward(self, tokens):
    return forward(self.params(), tokens, self.cfg)
