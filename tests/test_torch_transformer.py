"""The port's transformer against the JAX package's, on the same weights.

The JAX model's parameters (drawn by `precondition_tpu.models.transformer.
init_params`) travel into the port through `utils.convert`, whose tree
walk takes the model's ``blocks`` list; the same seeded numpy tokens,
masks and factors go through both.  Configs are small (2 layers, width 32).

Tolerances and why:
* the converter's round trip of the params and of their Shampoo state:
  bit for bit (numpy copies, no arithmetic);
* float32 activations: logits and loss rtol 1e-5 with atol 1e-5 of the
  largest logit, gradients atol 1e-5 of each leaf's largest entry
  (measured 1.9e-6 and 9.6e-7: the same f32 products summed in other
  orders);
* bfloat16 activations: logits and decode logits atol 2e-2 of the largest
  logit, the loss rtol 1e-3 (measured 0.8% and 1.4e-4): XLA's CPU
  backend keeps some elementwise chains (the tanh GELU, the residual
  adds) in f32 between bf16 roundings where torch rounds after each op,
  so single bf16 ulps (0.4%) differ and carry through two layers;
* remat against no remat: bit for bit (the recomputed forward is the
  same arithmetic);
* decode against the port's own forward: atol 1e-5 of the largest logit
  in f32, bit for bit in bf16 (measured: the same ops on one position);
* init: names, shapes, dtypes and order equal; each leaf's standard
  deviation within 5% of JAX's and of its nominal value (0.02 for the
  embeddings, 1/sqrt(d_in) for kernels), norm scales exactly 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from precondition_tpu.models import transformer as jax_transformer
from precondition_tpu.optim import shampoo as jax_shampoo
from precondition_tpu_torch.models import transformer
from precondition_tpu_torch.utils import convert

torch.set_num_threads(1)

_DTYPES = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}
_SIZES = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq_len=16)


def _configs(dtype="float32", remat=False, **sizes):
  sizes = {**_SIZES, **sizes}
  torch_dtype, jax_dtype = _DTYPES[dtype]
  return (transformer.TransformerConfig(**sizes, dtype=torch_dtype,
                                        remat=remat),
          jax_transformer.TransformerConfig(**sizes, dtype=jax_dtype,
                                            remat=remat))


def _params(jax_cfg, seed=0):
  """JAX's parameters as numpy, and the same as the port's flat dict."""
  tree = jax.tree.map(np.asarray,
                      jax_transformer.init_params(jax.random.PRNGKey(seed),
                                                  jax_cfg))
  return tree, convert.params_from_numpy(tree, device="cpu")


def _batch(seed=0, b=3, t=13, vocab=64):
  rng = np.random.RandomState(seed)
  return {"tokens": rng.randint(0, vocab, (b, t)).astype(np.int32),
          "target_mask": (rng.rand(b, t) > 0.3).astype(np.float32),
          "factors": rng.rand(b).astype(np.float32)}


def _torch_batch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _tolerance(dtype, ref):
  return (1e-5 if dtype == "float32" else 2e-2) * np.abs(ref).max()


def test_converter_round_trip_of_the_list_bearing_tree():
  """The model's tree keeps its layers in a list; converting it used to
  raise ``TypeError: can't convert np.ndarray of type numpy.object_``.
  Its params and its Shampoo state travel both ways."""
  _, jax_cfg = _configs()
  tree, params = _params(jax_cfg)
  assert list(params)[:6] == [
      "blocks/0/attn/out", "blocks/0/attn/qkv", "blocks/0/attn_norm/scale",
      "blocks/0/mlp/in_proj", "blocks/0/mlp/out_proj",
      "blocks/0/mlp_norm/scale"]
  paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
           for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
  assert list(params) == paths
  back = convert.params_to_numpy(params)
  assert jax.tree.structure(back) == jax.tree.structure(tree)
  for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
  # And the model's Shampoo state, whose stats keep the blocks list.
  state = jax.tree.map(np.asarray, jax_shampoo.distributed_shampoo(
      learning_rate=0.1, block_size=16).init(jax.tree.map(jnp.asarray,
                                                           tree)))
  port = convert.state_from_numpy(state, device="cpu")
  assert list(port.stats) == list(params)
  back = convert.state_to_numpy(port, state)
  assert jax.tree.structure(back) == jax.tree.structure(state)
  for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_jax(dtype):
  cfg, jax_cfg = _configs(dtype)
  tree, params = _params(jax_cfg)
  batch = _batch()
  jax_params = jax.tree.map(jnp.asarray, tree)
  want = np.asarray(jax_transformer.forward(
      jax_params, jnp.asarray(batch["tokens"]), jax_cfg))
  got = transformer.forward(params, torch.from_numpy(batch["tokens"]), cfg)
  assert got.dtype == torch.float32 and got.shape == want.shape
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                             atol=_tolerance(dtype, want))
  for keys in (("tokens",), ("tokens", "target_mask"),
               ("tokens", "target_mask", "factors")):
    sub = {k: batch[k] for k in keys}
    want = float(jax_transformer.loss_fn(
        jax_params, jax.tree.map(jnp.asarray, sub), jax_cfg))
    got = float(transformer.loss_fn(params, _torch_batch(sub), cfg))
    np.testing.assert_allclose(got, want,
                               rtol=1e-5 if dtype == "float32" else 1e-3,
                               err_msg=str(keys))


def _torch_grads(params, batch, cfg):
  leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
  loss = transformer.loss_fn(leaves, _torch_batch(batch), cfg)
  return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def test_gradients_match_jax_grad():
  cfg, jax_cfg = _configs()
  tree, params = _params(jax_cfg)
  batch = _batch(1)
  want = jax.grad(jax_transformer.loss_fn)(
      jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch),
      jax_cfg)
  got = _torch_grads(params, batch, cfg)
  for path, g in convert._flatten(jax.tree.map(np.asarray, want)):
    np.testing.assert_allclose(got[path].numpy(), g, rtol=1e-5,
                               atol=1e-5 * np.abs(g).max(), err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gradients_equal_plain_ones(dtype):
  cfg, jax_cfg = _configs(dtype)
  remat_cfg, _ = _configs(dtype, remat=True)
  _, params = _params(jax_cfg)
  batch = _batch(2)
  plain = _torch_grads(params, batch, cfg)
  remat = _torch_grads(params, batch, remat_cfg)
  for path in plain:
    torch.testing.assert_close(remat[path], plain[path], rtol=0, atol=0,
                               msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax_and_forward(dtype):
  cfg, jax_cfg = _configs(dtype)
  tree, params = _params(jax_cfg)
  tokens = _batch(3, t=8)["tokens"]
  full = transformer.forward(params, torch.from_numpy(tokens), cfg).numpy()
  caches = transformer.init_cache(cfg, 3, max_len=10, device="cpu")
  jax_params = jax.tree.map(jnp.asarray, tree)
  jax_caches = jax_transformer.init_cache(jax_cfg, 3, max_len=10)
  assert [{k: (v.shape, str(v.dtype).split(".")[-1]) for k, v in c.items()}
          for c in caches] == [
              {k: (v.shape, str(v.dtype)) for k, v in c.items()}
              for c in jax_caches]
  for pos in range(tokens.shape[1]):
    logits, caches = transformer.decode_step(
        params, caches, torch.from_numpy(tokens[:, pos]), pos, cfg)
    want, jax_caches = jax_transformer.decode_step(
        jax_params, jax_caches, jnp.asarray(tokens[:, pos]), pos, jax_cfg)
    want = np.asarray(want)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5,
                               atol=_tolerance(dtype, want),
                               err_msg=f"pos {pos}")
    np.testing.assert_allclose(
        logits.numpy(), full[:, pos], rtol=0,
        atol=1e-5 * np.abs(full).max() if dtype == "float32" else 0,
        err_msg=f"pos {pos}")
  for got, want in zip(caches, jax_caches):
    for k in ("k", "v"):
      np.testing.assert_allclose(got[k].float().numpy(),
                                 np.asarray(want[k], np.float32), rtol=1e-5,
                                 atol=_tolerance(dtype, np.asarray(
                                     want[k], np.float32)))


def test_init_params_matches_jax_layout_and_distributions():
  sizes = dict(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=256,
               max_seq_len=64)
  cfg, jax_cfg = _configs(**sizes)
  got = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
  want = dict(convert._flatten(jax.tree.map(
      np.asarray, jax_transformer.init_params(jax.random.PRNGKey(0),
                                              jax_cfg))))
  assert list(got) == list(want)
  for name, value in got.items():
    ref = want[name]
    assert tuple(value.shape) == ref.shape and value.dtype == torch.float32
    if name.endswith("/scale"):
      np.testing.assert_array_equal(value.numpy(), ref)
      continue
    nominal = 0.02 if name.endswith("/table") else 1 / np.sqrt(ref.shape[0])
    std = float(value.std())
    assert abs(std / ref.std() - 1) < 0.05, (name, std, ref.std())
    assert abs(std / nominal - 1) < 0.05, (name, std, nominal)
    assert abs(float(value.mean())) < 0.05 * nominal, name


def test_module_parameters_carry_the_jax_names_in_order():
  cfg, jax_cfg = _configs()
  _, params = _params(jax_cfg)
  model = transformer.Transformer(cfg, params=params)
  assert [n.replace(".", "/") for n, _ in model.named_parameters()] == list(
      params)
  assert all(a is b for a, b in zip(model.params().values(),
                                    model.parameters()))
  tokens = torch.from_numpy(_batch()["tokens"])
  torch.testing.assert_close(model(tokens),
                             transformer.forward(params, tokens, cfg),
                             rtol=0, atol=0)
  drawn = transformer.Transformer(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
  assert list(drawn.params()) == list(params)
