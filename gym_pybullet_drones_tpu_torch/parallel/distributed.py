"""Process groups and the env batch across ranks.

Counterpart of the JAX package's `parallel/distributed.py`.  There, one
process a host joins `jax.distributed` and a global array is assembled
from each host's shard.  Here one process is one rank of a
`torch.distributed` process group, each rank holds its own columns of the
global env batch on its own device, and the global batch exists only
where it is gathered (a checkpoint, a report).

`initialize` forms the group.  `local_env_batch` keeps a rank's columns
of a global batch; `global_env_batch` gathers the ranks' columns back.
The gather is an `all_reduce` (sum) of a zero-filled buffer into which
each rank writes its columns, taken on the tensors' integer views so that
every bit arrives as it was sent (-0.0 and NaN payloads included): gloo
runs only `all_reduce` and `broadcast` on CUDA tensors.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# the integer type of each width, for the bit-exact gather
_BITS = {1: torch.uint8, 4: torch.int32, 8: torch.int64}


def _env_int(name: str):
    value = os.environ.get(name)
    return None if value is None else int(value)


def check_backend(backend: str, num_processes: int | None) -> None:
    """Refuse an unknown backend, and NCCL with fewer visible cards than
    ranks on this host: NCCL takes one card a rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend != "nccl":
        return
    local = _env_int("LOCAL_WORLD_SIZE") or num_processes or 1
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < local:
        raise RuntimeError(
            f"NCCL takes one card a rank: {local} ranks on this host, "
            f"{cards} cards visible; pass backend='gloo' (--backend gloo) "
            "to share a card")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> int:
    """Join this process to the group; returns its rank.

    `coordinator_address` is the rendezvous: "host:port" (TCP, rank 0
    listens), or a URL `tcp://host:port` or `file:///path` (a file that
    every rank can reach).  With no arguments, torchrun's environment
    (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`) gives them.

    `num_processes=1` forms no group and returns rank 0: a single process
    needs none, and every collective of a one-rank `Mesh` is skipped.
    Otherwise a group that cannot be formed raises; there is no fallback
    to a single process.  `backend`: "nccl" (the default; one card a
    rank, refused with fewer visible cards than ranks on this host) or
    "gloo" (ranks may share a card; the CPU tests use it).
    """
    backend = backend or "nccl"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    check_backend(backend, num_processes)
    if num_processes == 1:
        return 0
    if num_processes is None or process_id is None:
        raise ValueError("a group of more than one process needs "
                         "num_processes and process_id (or torchrun's "
                         "WORLD_SIZE and RANK)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not a rank of "
                         f"{num_processes} processes")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def local_env_batch(mesh, x: torch.Tensor, env_axis: int = 0):
    """The rank's columns of a global batch `x` along `env_axis` (0 for
    EnvState leaves and actions, 1 for the fused (rows, envs) carry), as
    a dense copy on the mesh's device with `x`'s order of strides: a view
    that the env hands out transposed (the fused path's obs) stays
    transposed, as the rank's env hands it out, and a product of the
    policy rounds on it as it does on the env's."""
    lo, hi = mesh.env_range(x.shape[env_axis])
    return x.narrow(env_axis, lo, hi - lo).to(mesh.device).clone()


def global_env_batch(mesh, x: torch.Tensor, env_axis: int = 0):
    """The global batch whose rank-r columns along `env_axis` are rank r's
    `x`, bit for bit, on every rank (one `all_reduce`), dense with `x`'s
    order of strides (as `local_env_batch` keeps it)."""
    if mesh.size == 1:
        return x
    shape = list(x.shape)
    per = shape[env_axis]
    shape[env_axis] = per * mesh.size
    bits = _BITS[x.element_size()]
    # the buffer contiguous in x's order of strides, outermost first
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    buf = torch.zeros([shape[d] for d in order], dtype=bits,
                      device=x.device)
    out = buf.permute([order.index(d) for d in range(x.dim())])
    out.narrow(env_axis, mesh.rank * per, per).copy_(x.view(bits))
    mesh.all_reduce(buf)
    return out.view(x.dtype)
