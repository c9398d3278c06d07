"""Start a world of ranks on this host and collect what each returns.

    results = spawn.run(fn, 2, args, backend="gloo")

starts ``world_size`` processes with the ``spawn`` start method. Rank r
joins the process group (``init_process_group(backend,
tcp://localhost:<a free port>, rank=r)``), with CUDA device
r % device_count current when it has a card, runs ``fn(r, world_size,
*args)`` and sends its return value back, pickled. ``fn`` must be a
module-level function (the ranks import it by name); what it returns must
hold no CUDA tensor (move results to the CPU first). The parent gets the
values in rank order.

A rank that raises exits non-zero with its traceback on stderr, nothing
catches it, and ``run`` raises RuntimeError naming the rank and stops the
others. The backend is the caller's: NCCL for one rank a card, gloo for
the CPU or for several ranks on one card (NCCL refuses two ranks on one
device). Ranks of a torchrun job need none of this: they call
``init_process_group`` themselves.

Kernels should be built before the ranks start (``_build.build()``): each
rank loads the built libraries and builds none.
"""

from __future__ import annotations

import datetime
import multiprocessing
import pickle
import queue
import socket
import time

import torch
import torch.distributed as dist

WAIT_S = 600.0  # the longest a collective, or the whole run, may wait


def free_port() -> int:
    """A TCP port that was free on localhost just now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world_size: int, port: int, backend: str,
               wait_s: float, out, args) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=wait_s))
    try:
        result = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    out.put((rank, pickle.dumps(result)))


def run(fn, world_size: int, args=(), backend: str = "nccl",
        wait_s: float = WAIT_S) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks:
    their return values in rank order. Raises RuntimeError when a rank
    fails or the run takes longer than ``wait_s``; every rank is stopped
    before it returns. ``wait_s`` also bounds each collective."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, port, backend, wait_s,
                               out, args))
             for r in range(world_size)]
    results = {}
    deadline = time.monotonic() + wait_s
    try:
        for p in procs:
            p.start()
        while len(results) < world_size:
            try:
                rank, blob = out.get(timeout=1.0)
                results[rank] = pickle.loads(blob)
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in results]
            if dead:
                raise RuntimeError(
                    f"rank {dead[0]} failed (exit code "
                    f"{procs[dead[0]].exitcode}); its traceback is above")
            if time.monotonic() > deadline:
                raise RuntimeError(f"ranks still running after {wait_s} s")
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world_size)]
