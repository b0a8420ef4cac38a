"""The port imports nothing of JAX and nothing of the JAX package.

A fresh interpreter imports every module of `precondition_tpu_torch`, and
`chip_smoke.py`, which runs on a machine without JAX; then none of jax,
jaxlib, optax, flax, chex or `precondition_tpu` may be loaded.
"""

import pathlib
import subprocess
import sys

import precondition_tpu_torch

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "chex", "precondition_tpu")

_SCRIPT = """
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
package = root / "precondition_tpu_torch"
names = ["chip_smoke"] + sorted(
    ".".join(p.relative_to(root).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in package.rglob("*.py"))
for name in names:
  importlib.import_module(name)
forbidden = set(sys.argv[2:])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(len(names), loaded)
"""


def test_port_imports_no_jax():
  out = subprocess.run(
      [sys.executable, "-c", _SCRIPT, str(_ROOT), *_FORBIDDEN],
      capture_output=True, text=True, check=True, timeout=300,
      cwd=_ROOT).stdout.split(None, 1)
  count, loaded = int(out[0]), out[1].strip()
  modules = list((_ROOT / "precondition_tpu_torch").rglob("*.py"))
  assert count == len(modules) + 1
  assert loaded == "[]"
  assert precondition_tpu_torch.__name__ == "precondition_tpu_torch"
