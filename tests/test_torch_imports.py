"""The port imports nothing of JAX and nothing of the JAX package.

A fresh interpreter imports every module of `precondition_tpu_torch`,
`chip_smoke.py`, which runs on a machine without JAX, and
`tests/torch_ranks.py`, the body of the distribution tests' spawned ranks;
then none of jax, jaxlib, optax, flax, chex or `precondition_tpu` may be
loaded.  The distribution modules, the model, the train loop, the
examples and the entry point are among those imported.
"""

import pathlib
import subprocess
import sys

import precondition_tpu_torch

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "chex", "precondition_tpu")
_DISTRIBUTION = ("precondition_tpu_torch.parallel.mesh",
                 "precondition_tpu_torch.parallel.local",
                 "precondition_tpu_torch.optim.sharded_shampoo")
_TRAINING = ("precondition_tpu_torch.models.transformer",
             "precondition_tpu_torch.train.loop",
             "precondition_tpu_torch.examples.quickstart",
             "precondition_tpu_torch.examples.spmd_transformer",
             "precondition_tpu_torch.examples.tearfree_sketchy",
             "precondition_tpu_torch.entry")

_SCRIPT = """
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
sys.path.insert(0, str(root / "tests"))
package = root / "precondition_tpu_torch"
names = ["chip_smoke", "torch_ranks"] + sorted(
    ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in package.rglob("*.py"))
for name in names:
  importlib.import_module(name)
forbidden = set(sys.argv[2:])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(len(names), ",".join(names), loaded)
"""


def test_port_imports_no_jax():
  out = subprocess.run(
      [sys.executable, "-c", _SCRIPT, str(_ROOT), *_FORBIDDEN],
      capture_output=True, text=True, check=True, timeout=300,
      cwd=_ROOT).stdout.split(None, 2)
  count, names, loaded = int(out[0]), out[1].split(","), out[2].strip()
  modules = list((_ROOT / "precondition_tpu_torch").rglob("*.py"))
  assert count == len(modules) + 2
  assert set(_DISTRIBUTION) <= set(names)
  assert set(_TRAINING) <= set(names)
  assert loaded == "[]"
  assert precondition_tpu_torch.__name__ == "precondition_tpu_torch"
