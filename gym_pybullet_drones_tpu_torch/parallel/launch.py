"""Run a function on R ranks of one machine, each its own process.

`run_ranks(fn, R, backend)` starts R processes with the `spawn` method
(a parent that has touched CUDA cannot fork), forms their group through a
`file://` rendezvous in a fresh directory, gives each rank `fn(mesh,
*args)` and returns the R results in rank order.  A rank that raises
fails the whole run with its traceback; a run past `timeout_s` fails
too; either way every process it started is stopped.  `fn` must be a
module-level function, and its arguments and result picklable as numpy
arrays, numbers and containers of them: no tensor, which torch would
send through memory that dies with the rank.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch.distributed as dist

from gym_pybullet_drones_tpu_torch.parallel.distributed import initialize
from gym_pybullet_drones_tpu_torch.parallel.mesh import make_mesh


def _rank_main(fn, rank, num_ranks, backend, device, init, args, results):
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        initialize(init, num_ranks, rank, backend)
        results.put((rank, True, fn(make_mesh(backend, device), *args)))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, num_ranks: int, backend: str = "nccl", args=(),
              device=None, timeout_s: float | None = None,
              rendezvous_dir: str | None = None) -> list:
    """[fn(mesh, *args) of rank 0, ..., of rank R - 1], each rank in its
    own process (`make_mesh(backend, device)`; `device` None = its card),
    within `timeout_s` (None: no limit).
    The rendezvous file lives in a fresh directory under `rendezvous_dir`
    (None: the system's temporary directory), removed at the end."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gpdt_ranks_", dir=rendezvous_dir)
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, rank, num_ranks, backend, device, init, args, results))
        for rank in range(num_ranks)]
    out = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    left = lambda: None if deadline is None \
        else max(deadline - time.monotonic(), 0.0)
    try:
        for p in procs:
            p.start()
        while len(out) < num_ranks:
            try:
                rank, ok, value = results.get(timeout=min(
                    1.0, left() if deadline is not None else 1.0))
            except queue.Empty:
                # a rank that died without reporting (killed, or its
                # function could not be unpickled) fails the run now
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"ranks exited without a result (rank, exit "
                        f"code): {dead}") from None
                if deadline is not None and left() == 0.0:
                    raise TimeoutError(
                        f"{num_ranks} ranks did not finish in {timeout_s} "
                        f"s (finished: {sorted(out)})") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {num_ranks} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(None if deadline is None else max(left(), 1.0))
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[rank] for rank in range(num_ranks)]
