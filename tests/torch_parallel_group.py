"""One gloo process group per test file for the port's parallel layer.

``run_group(checks, world, payload, tmp_path)`` spawns ``world`` processes
(the spawn start method) that join one gloo group through a ``file://``
store under ``tmp_path`` (no port to race for), with a timeout on the group,
pin one thread each and call ``checks(rank, world, payload)``, a function of
:mod:`torch_parallel_checks` by name. Each rank's returned dict comes back
to the parent, which waits at most ``deadline`` seconds and then stops every
child: a check that hangs fails the test, it does not hang it. The children
import torch and the port only, never JAX.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.multiprocessing as mp


def _entry(rank: int, world: int, store: str, out_dir: str, checks: str, payload):
    import torch.distributed as dist

    import torch_parallel_checks

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        result = getattr(torch_parallel_checks, checks)(rank, world, payload)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_group(checks: str, world: int, payload, tmp_path, deadline: float = 300.0) -> list:
    """Every rank's result of ``torch_parallel_checks.<checks>``, in rank order."""
    out_dir = str(tmp_path)
    ctx = mp.start_processes(_entry, args=(world, os.path.join(out_dir, "store"), out_dir, checks, payload),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
            if time.monotonic() >= end:
                raise TimeoutError(f"the {world}-rank group did not finish within {deadline} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(10)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]
