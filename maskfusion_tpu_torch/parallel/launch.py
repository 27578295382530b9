"""Start one process per rank and collect what each returns.

The JAX package has no counterpart: its mesh is one controller driving
every device.  PyTorch's collectives run between processes, so a sharded
train step runs as ``world`` ranks, each in a process of its own.

`run_ranks` spawns them with ``torch.multiprocessing``'s ``spawn`` context
(``fork`` is unsafe in a process with threads, and CUDA refuses it), joins
them into one process group through a file store in a temporary directory
(no TCP port, so concurrent runs cannot collide), and returns each rank's
result.  Every wait is bounded: the process group's own timeout, and a
deadline on collecting the results, after which stragglers are killed.  A
rank that raises makes the call raise with that rank's traceback.

A spawned child imports the module of the function it runs, so rank
functions live in the package (``parallel.train``, ``parallel.dryrun``),
never in a test module, which would import JAX into every rank.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as _queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank raised, hung past the deadline or died without a result."""


def _rank_main(job_path: str, rank: int, world: int, backend: str,
               init_method: str, timeout_s: float, results) -> None:
    """One rank: load ``(fn, args)`` from ``job_path``, join the group, run
    ``fn(rank, world, *args)``, report.  A CPU rank computes on one thread,
    so ``world`` ranks share the host's cores without oversubscribing them;
    a NCCL rank takes card ``rank``."""
    try:
        with open(job_path, "rb") as f:
            fn, args = pickle.load(f)
        kwargs = {}
        if backend == "nccl":
            torch.cuda.set_device(rank)
            kwargs["device_id"] = torch.device("cuda", rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:               # reported to the parent, then exit
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, backend: str = "gloo",
              args: Sequence = (), timeout_s: float = 120.0) -> List[Any]:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks joined in one
    ``backend`` process group; returns the results in rank order.  ``fn``
    and ``args`` must pickle (a module-level function of the package).
    Raises RankError with the first failing rank's traceback, or when the
    ranks have not all reported within ``timeout_s`` seconds (they are then
    killed).  ``nccl`` needs ``world`` cards; there is no fallback to
    another backend."""
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RankError(f"nccl with {world} ranks needs {world} cards; "
                        f"{torch.cuda.device_count()} found")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        # the job travels in a file: a child reads its Process arguments
        # only after importing, so arguments beyond a pipe's buffer would
        # make each start wait for the previous child's imports
        job_path = os.path.join(tmp, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            job_path, rank, world, backend, init_method, timeout_s,
            results)) for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got: dict = {}
        failure = None
        try:
            # drain the queue before joining (a child blocks on exit until
            # its queued result is read)
            while len(got) < world and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = (f"ranks {sorted(set(range(world)) - set(got))}"
                               f" did not finish within {timeout_s} s")
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except _queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive()
                            and p.exitcode not in (0, None)]
                    if dead:
                        # give a dying rank's report a moment to land
                        try:
                            rank, ok, out = results.get(timeout=2.0)
                        except _queue.Empty:
                            failure = (f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       "result")
                            break
                    else:
                        continue
                if ok:
                    got[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
        finally:
            for p in procs:
                p.join(timeout=5.0 if failure is None else 0.5)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
            results.close()
    if failure is not None:
        raise RankError(failure)
    return [got[r] for r in range(world)]
