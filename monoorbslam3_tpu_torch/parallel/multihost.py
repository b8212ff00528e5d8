"""Multi-process runtime and the global device mesh (counterpart of
`monoorbslam3_tpu/parallel/multihost.py`).

The reference is one process with mutexes (SURVEY.md §2.3); the JAX
package scales out over a device mesh that one controller drives. A
`torch.distributed` mesh is driven the other way: one process per rank,
each with its own device, joined by a process group (NCCL between cards,
gloo between CPU processes). `initialize` brings the group up and
`global_mesh` lays a `DeviceMesh` over its ranks:

    from monoorbslam3_tpu_torch.parallel import multihost
    multihost.initialize(coordinator="10.0.0.1:8476", num_processes=4,
                         process_id=rank)
    mesh = multihost.global_mesh(("dp",))
    system = System(..., mesh=mesh)   # every rank: window BAs across ranks

Every rank then runs the same program on the same inputs (see
`parallel/sharded_ba.py` for what is split between them). Nothing here
reads a cluster's environment: the caller names the coordinator, the
process count and its rank.
"""

from __future__ import annotations

import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import CARD, resolve


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, local_device_ids=None,
               device_type: str = CARD.type) -> bool:
    """Join the process group: NCCL for `device_type` "cuda" (the card, the
    default), gloo for "cpu". `coordinator` is "host:port" (TCP) or an
    init-method URL ("tcp://...", "file://..."). On CUDA the process takes
    `local_device_ids[0]` (by default its rank modulo the host's cards) as
    its current device.

    Returns True when a group was started, False when the call is a
    single-process no-op (no coordinator and num_processes in (None, 1)),
    so callers can initialize unconditionally. A "cuda" group on a host
    without a card raises, as every entry point of the port does."""
    if coordinator is None and (num_processes is None or num_processes == 1):
        return False
    resolve(device_type)
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize: a group needs the coordinator, num_processes and "
                         "process_id")
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if device_type == "cuda":
        local = (local_device_ids[0] if local_device_ids
                 else process_id % torch.cuda.device_count())
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return True


def global_mesh(axis_names=("dp",), shape=None, device_type: str = CARD.type):
    """A DeviceMesh of `device_type` over every rank of the process group.

    `shape`: the axis sizes (by default all ranks on the first axis); their
    product must be the group's size. Ranks are laid out host-major, as
    `init_device_mesh` lays them (row-major over the rank order, which
    numbers a host's processes contiguously): the fastest-varying axis
    stays within a host, and only the slowest crosses hosts."""
    from torch.distributed.device_mesh import init_device_mesh

    resolve(device_type)
    if not dist.is_initialized():
        raise RuntimeError("global_mesh: no process group; call initialize first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n != world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} processes, the group has {world}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def process_info() -> dict:
    """Rank, size and device census for logging and sharding decisions (one
    device per rank)."""
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": world,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 1,
        "global_devices": world,
    }


def mesh_axis(mesh, axis: str = "dp"):
    """(process group, this rank's index, size) of the mesh's `axis`."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(list(mesh.mesh_dim_names).index(axis)))


def run_ranks(fn, n: int, device_type: str = CARD.type, args=(), timeout: float = 900.0,
              independent: bool = False) -> list:
    """Run `fn(*args)` once on each rank of a fresh group of `n` processes
    and return the ranks' results in rank order. With `independent`, each
    of the n processes joins a one-rank group of its own instead (process r
    on card r): n replicas of a one-rank program side by side.

    The process model of a torch mesh in one call: the ranks are spawned
    (`torch.multiprocessing`, the spawn method), each joins the group
    through `initialize` (a file store in a temporary directory; NCCL on
    "cuda", one card a rank; gloo on "cpu", one thread a rank), runs `fn`
    and leaves the group. `fn` must be a module-level function and its
    result picklable. A rank that raises sends its traceback, and the call
    raises with it once every rank has answered or the first has failed
    (the others are then stopped); a rank that dies without an answer, or
    no answer within `timeout` seconds, raises too. More ranks than the
    host's cards raises before any process starts: the ranks never run on
    the CPU in place of cards."""
    resolve(device_type)
    if device_type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"run_ranks: {n} ranks need {n} cards, this host has "
                           f"{torch.cuda.device_count()} (NCCL takes one card a rank)")
    ctx = torch.multiprocessing.get_context("spawn")
    answers = ctx.Queue()
    results, failures = {}, []
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        coord = f"file://{tmp}/store"
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, coord, device_type, args, answers, independent))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while len(results) + len(failures) < n and not failures:
                try:
                    rank, ok, payload = answers.get(timeout=1.0)
                except queue.Empty:
                    failures += [f"rank {r} exited with code {p.exitcode} without an answer"
                                 for r, p in enumerate(procs)
                                 if p.exitcode not in (None, 0) and r not in results]
                    if not failures and time.monotonic() > deadline:
                        failures.append(f"no answer from every rank within {timeout} s")
                    continue
                if ok:
                    results[rank] = payload
                else:
                    failures.append(f"rank {rank} failed:\n{payload}")
        finally:
            for p in procs:
                if failures:
                    p.kill()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failures:
        raise RuntimeError("run_ranks: " + "\n".join(failures))
    return [results[r] for r in range(n)]


def _rank_main(fn, rank, n, coordinator, device_type, args, answers, independent):
    """One spawned rank of `run_ranks`."""
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        if independent:
            initialize(coordinator=f"{coordinator}{rank}", num_processes=1, process_id=0,
                       local_device_ids=[rank], device_type=device_type)
        else:
            initialize(coordinator=coordinator, num_processes=n, process_id=rank,
                       device_type=device_type)
        answers.put((rank, True, fn(*args)))
    except BaseException:
        answers.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
