"""Builds the port's CUDA kernels from the package's own sources at first use.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.  It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``precondition_tpu_torch/_build/<hash>/`` (keyed by a hash of the sources
and flags, so an edit rebuilds) and loaded with `ctypes`.  Nothing here
runs at import time; a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
  path: Path       # the shared library
  seconds: float   # nvcc wall time (0.0 when the library was already built)
  log: str         # nvcc's output, including ptxas' register and spill report


def _nvcc() -> str:
  for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
    if home and (Path(home) / "bin" / "nvcc").is_file():
      return str(Path(home) / "bin" / "nvcc")
  found = shutil.which("nvcc")
  if found is None:
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")
  return found


@functools.lru_cache(maxsize=None)
def build(name: str) -> Built:
  """Compiles ``csrc/<name>.cu`` unless a library of the same hash exists."""
  sources = [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh"))
  digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for src in sources:
    digest.update(src.read_bytes())
  out_dir = BUILD_DIR / digest.hexdigest()[:16]
  lib = out_dir / f"lib{name}.so"
  log_path = out_dir / f"{name}.log"
  if lib.is_file():
    return Built(lib, 0.0, log_path.read_text() if log_path.is_file() else "")
  out_dir.mkdir(parents=True, exist_ok=True)
  # Build into a temporary name and rename, so a concurrent build never
  # loads a half-written library.
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
  os.close(fd)
  cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(sources[0])]
  start = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  seconds = time.perf_counter() - start
  log = proc.stdout + proc.stderr
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                       f"{' '.join(cmd)}\n{log}")
  log_path.write_text(log)
  os.replace(tmp, lib)
  return Built(lib, seconds, log)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
  """The built library for ``csrc/<name>.cu``, loaded once per process."""
  return ctypes.CDLL(str(build(name).path))
