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

A rank that raises exits non-zero with its traceback on stderr and sends
its exception's last line to the parent; ``run`` then waits up to
``GRACE_S`` for the other ranks to fail or finish, stops them, and raises
RuntimeError naming every failed rank, the likely cause first: a rank
killed by a signal (a negative exit code, no report), then a rank's own
error, then a peer's lost connection, which only follows another rank's
end. The backend is the caller's: NCCL for one rank a card, gloo for
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
import signal
import socket
import time
import traceback

import torch
import torch.distributed as dist

WAIT_S = 600.0  # the longest a collective, or the whole run, may wait
GRACE_S = 10.0  # after a rank fails, the wait for the others' reports


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
    except BaseException as e:
        last = traceback.format_exception_only(e)[-1].strip()
        out.put((rank, "error", f"{last[:2000]}{_card_memory()}"))
        raise
    finally:
        dist.destroy_process_group()
    out.put((rank, "ok", pickle.dumps(result)))


def _card_memory() -> str:
    """The card's free and total memory, as a note on a rank's failure."""
    if not torch.cuda.is_available():
        return ""
    try:
        free, total = torch.cuda.mem_get_info()
    except Exception:  # a broken context: the report stands without it
        return ""
    return f" [card: {free >> 20} of {total >> 20} MiB free]"


def _exit(code) -> str:
    if code is not None and code < 0:
        try:
            return f"killed by {signal.Signals(-code).name}"
        except ValueError:
            return f"killed by signal {-code}"
    return f"exit code {code}"


def _failures(failed: dict, procs) -> list:
    """One line a failed rank: killed ranks first, then the ranks' own
    errors, then lost connections to a peer."""
    def cause(item):
        what = item[1]
        return (0 if what is None else
                2 if "closed by peer" in what or "reset by peer" in what
                else 1)
    return [f"rank {r}: " + (what or f"{_exit(procs[r].exitcode)}, no "
                             "exception reported")
            for r, what in sorted(failed.items(), key=cause)]


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
    results, failed = {}, {}  # failed: rank -> its report, or None
    deadline = time.monotonic() + wait_s
    try:
        for p in procs:
            p.start()
        grace = None
        while len(results) + len(failed) < world_size:
            try:
                rank, status, blob = out.get(timeout=1.0)
                if status == "ok":
                    results[rank] = pickle.loads(blob)
                else:
                    failed[rank] = blob
            except queue.Empty:
                pass
            for r, p in enumerate(procs):
                if p.exitcode not in (None, 0):
                    failed.setdefault(r, None)  # its report may follow
            if failed and grace is None:
                grace = time.monotonic() + GRACE_S
            if grace is not None and time.monotonic() > grace:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"ranks still running after {wait_s} s")
        while failed:  # reports still in the queue
            try:
                rank, status, blob = out.get(timeout=0.5)
            except queue.Empty:
                break
            if status != "ok":
                failed[rank] = blob
        if failed:
            raise RuntimeError("ranks failed, the likely cause first; "
                               "tracebacks are above\n  " + "\n  ".join(
                                   _failures(failed, procs)))
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world_size)]
