"""Runs a function on a few local processes joined by a process group.

`run_local_ranks(fn, world_size)` starts ``world_size`` processes with the
``spawn`` method, joins them in one `torch.distributed` process group over
``tcp://127.0.0.1`` on a free port, calls ``fn(rank, world_size, *args)``
in each and returns the ranks' results in rank order.  The tests drive the
distributed optimizer on CPU ranks with it (gloo), and `chip_smoke.py`
drives it on one GPU.  A multi-host job starts its ranks with ``torchrun``
instead and needs none of this.

``fn`` must be importable by module path (spawned processes start from a
fresh import), and its arguments and result picklable.  The group's
``timeout`` bounds every collective, and the parent gives up after
``join_timeout`` seconds, so a hung collective fails the call instead of
hanging it.
"""

from __future__ import annotations

import datetime
import queue as queue_lib
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
  """A TCP port of 127.0.0.1 that was free a moment ago."""
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def _rank_main(rank, world_size, port, backend, timeout, fn, args, results):
  try:
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
    try:
      out = fn(rank, world_size, *args)
    finally:
      dist.destroy_process_group()
    results.put((rank, True, out))
  except Exception:  # reported to the parent, which raises it
    results.put((rank, False, traceback.format_exc()))


def run_local_ranks(fn, world_size: int, args=(), backend: str = "gloo",
                    timeout: float = 60.0, join_timeout: float = 600.0):
  """``[fn(r, world_size, *args) for r in ranks]``, each in its own process.

  Raises `RuntimeError` with the rank's traceback if any rank fails, and
  if the ranks have not all returned within ``join_timeout`` seconds;
  every process is stopped before it returns or raises.
  """
  ctx = mp.get_context("spawn")
  results = ctx.Queue()
  port = free_port()
  procs = [ctx.Process(target=_rank_main, daemon=True,
                       args=(r, world_size, port, backend, timeout, fn, args,
                             results))
           for r in range(world_size)]
  for p in procs:
    p.start()
  deadline = time.monotonic() + join_timeout
  out = {}
  try:
    while len(out) < world_size:
      try:
        rank, ok, value = results.get(timeout=1.0)
      except queue_lib.Empty:
        missing = sorted(set(range(world_size)) - set(out))
        # A rank that died before it could report (a crash, a failed start).
        dead = {r: procs[r].exitcode for r in missing
                if procs[r].exitcode is not None}
        if dead or time.monotonic() > deadline:
          raise RuntimeError(
              f"ranks {missing} did not return within {join_timeout} s"
              if not dead else f"ranks exited without a result: {dead}"
          ) from None
        continue
      if not ok:
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
      out[rank] = value
  finally:
    for p in procs:
      p.join(timeout=10)
      if p.is_alive():
        p.kill()
        p.join(timeout=10)
  return [out[r] for r in range(world_size)]


def backend_for(device: str, world_size: int) -> str:
  """NCCL where each of ``world_size`` ranks gets a card of its own, else
  gloo (whose collectives also take CUDA tensors, through the host)."""
  if device == "cuda" and torch.cuda.device_count() >= world_size:
    return "nccl"
  return "gloo"
