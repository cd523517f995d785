"""Start a world of ranks on the CPU and collect what each returns.

    results = run_world("pkg.module:function", 4, workdir, args=(...))

Each rank is a process started with the ``spawn`` method; it joins a gloo
world through a ``FileStore`` under ``workdir`` (no TCP port, so worlds
started side by side do not collide), calls ``function(*args)`` and
writes the return value to ``workdir/rank<r>.pt``; ``run_world`` returns
the list of values, rank 0 first, and raises if a rank failed or the
world outlived ``timeout``.  The target is named by its import path and
the parent's ``sys.path`` is handed to the children, so a target may live
beside the caller's tests.  Each rank runs one intra-op thread.

This is how the sharded runtimes (``psrun``, ``pods``) run as worlds of
more than one rank on the CPU; on the card a world is one NCCL rank per
GPU, started by the caller.
"""
from __future__ import annotations

import importlib
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, target, world_size, workdir, args, sys_path):
    sys.path[:0] = [p for p in sys_path if p not in sys.path]
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world_size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size)
    try:
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(*args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(target: str, world_size: int, workdir, args=(),
              timeout: float = 600.0) -> list:
    """Run ``target`` (``"module:function"``) on every rank of a fresh
    gloo world of ``world_size`` processes; returns each rank's value."""
    workdir = os.fspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(_rank_main,
                             args=(target, world_size, workdir, tuple(args),
                                   list(sys.path)),
                             nprocs=world_size, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{target}: the world of {world_size} "
                                   f"ranks outlived {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world_size)]
