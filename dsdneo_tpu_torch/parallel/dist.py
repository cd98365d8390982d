"""The mesh of the sharded steps: one process per GPU, over
``torch.distributed``.

Counterpart of what ``dsdneo_tpu/parallel/mesh.py`` takes from JAX: the
``Mesh`` of devices (``mesh.py:34``), the ``NamedSharding`` that lays the
channel axis over it, and ``shard_map`` (``mesh.py:182-187``), which runs
one program on every device's shard.  Here every rank is a process of its
own with one device:

  - :class:`Mesh` holds the process group, the world size, the rank and
    the rank's device;
  - a step takes the rank's local shard (:func:`shard_rows` cuts it from
    a global host array) and :func:`gather_rows` joins the ranks'
    outputs in rank order;
  - the only collectives are the fleet metrics, as in the JAX design
    (no cross-channel collective in the hot path): :func:`all_mean` for
    ``pmean`` and :func:`all_sum` for ``psum``.

Rank r runs on ``cuda:{LOCAL_RANK}`` under NCCL.  A CUDA device runs
gloo only when the caller names ``backend="gloo"`` (several ranks that
share one card); the CPU (``device="cpu"``) runs gloo.  Nothing falls
back: no card and no ``device="cpu"`` raises, and so does NCCL missing.
Under NCCL a collective runs on a tensor on the rank's device, under
gloo on a CPU tensor.

:func:`spawn` starts ``world`` ranks on one host (``tcp://127.0.0.1``
and a free port) and returns each rank's result; a rank that fails
fails the whole run.  Under ``torchrun --nproc-per-node N``,
:func:`mesh_from_env` reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``.
"""

from __future__ import annotations

import datetime
import inspect
import os
import socket
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from dsdneo_tpu_torch.device import require_cuda


@dataclass
class Mesh:
    """One rank's view of the mesh: the process group, its world size,
    this process's rank and device, and the backend."""
    group: object
    world: int
    rank: int
    device: torch.device
    backend: str

    def local_count(self, n: int, what: str = "channel") -> int:
        """The rows a rank holds of ``n``; raises where the world size
        does not divide ``n`` (the JAX steps assert it)."""
        if n % self.world:
            raise ValueError(f"{what} count {n} must divide the mesh "
                             f"({self.world} ranks)")
        return n // self.world

    def rows(self, n: int, what: str = "channel") -> slice:
        """This rank's slice of ``n`` global rows."""
        k = self.local_count(n, what)
        return slice(self.rank * k, (self.rank + 1) * k)


def _resolve(device, backend, local_rank: int):
    """(device, backend) of a rank: the rank's card and NCCL unless the
    caller names another; raises rather than fall back."""
    if device is None:
        device = require_cuda(local_rank)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = require_cuda(local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL runs on CUDA devices only; the CPU "
                             "runs gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL backend (gloo on "
                               "a card only when backend='gloo' is named)")
    return dev, backend


def init_mesh(rank: int, world: int, init_method: str, device=None,
              backend: str | None = None, timeout_s: float = 600.0,
              local_rank: int | None = None) -> Mesh:
    """Join the process group as ``rank`` of ``world`` at
    ``init_method`` (``tcp://host:port`` or ``env://``) on ``device``:
    the card ``LOCAL_RANK`` when none is given."""
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev, backend = _resolve(device, backend, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if backend == "nccl" and "device_id" in inspect.signature(
            dist.init_process_group).parameters:
        kw["device_id"] = dev           # bind the communicator to the card
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return Mesh(dist.group.WORLD, world, rank, dev, backend)


def mesh_from_env(device=None, backend: str | None = None) -> Mesh:
    """The mesh of a process that ``torchrun`` started."""
    return init_mesh(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                     "env://", device, backend,
                     local_rank=int(os.environ.get("LOCAL_RANK", 0)))


def cpu_mesh(mesh: Mesh) -> Mesh:
    """The same ranks on the CPU: a gloo group beside ``mesh``'s, for the
    port's CPU path next to the card's (every rank calls it)."""
    group = dist.new_group(backend="gloo")
    return Mesh(group, mesh.world, mesh.rank, torch.device("cpu"), "gloo")


def close_mesh(mesh: Mesh) -> None:
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


# -- shards -------------------------------------------------------------------
def shard_rows(mesh: Mesh, x, what: str = "channel") -> torch.Tensor:
    """The rank's rows of a global host array (or tensor) ``x``, whose
    first axis the ranks split in order, as a tensor on the rank's
    device."""
    n = int(x.shape[0])
    part = x[mesh.rows(n, what)]
    if isinstance(part, np.ndarray):
        # a read-only (memory-mapped) array is copied, not aliased
        part = torch.from_numpy(np.ascontiguousarray(part)
                                if part.flags.writeable else np.array(part))
    return part.to(mesh.device)


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A tensor where the backend's collectives run."""
    return t.to(mesh.device) if mesh.backend == "nccl" else t.cpu()


def gather_rows(mesh: Mesh, local) -> np.ndarray:
    """Every rank's ``local`` rows (one shape on all ranks) joined in rank
    order along the first axis, on the host of every rank."""
    t = torch.as_tensor(local)
    was_bool = t.dtype == torch.bool
    t = _wire(mesh, t.to(torch.uint8) if was_bool else t).contiguous()
    if mesh.world == 1:
        out = t.clone()                 # never a view of the caller's array
    else:
        parts = [torch.empty_like(t) for _ in range(mesh.world)]
        dist.all_gather(parts, t, group=mesh.group)
        out = torch.cat(parts)
    out = out.cpu().numpy()
    return out.astype(bool) if was_bool else out


def gather_objects(mesh: Mesh, obj) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    if mesh.world == 1:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


# -- the fleet collectives ----------------------------------------------------
def all_mean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``pmean``: the mean of a float32 scalar over the ranks (a SUM
    all-reduce divided by the world size), on the rank's device."""
    t = _wire(mesh, x.to(torch.float32).reshape(()).clone())
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return (t / mesh.world).to(mesh.device)


def all_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``psum``: the integer sum of a scalar over the ranks, on the
    rank's device."""
    t = _wire(mesh, x.to(torch.int64).reshape(()).clone())
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t.to(mesh.device)


# -- ranks on one host --------------------------------------------------------
def free_port() -> int:
    """A free TCP port on the loopback address."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def _rank_main(fn, rank: int, world: int, init_method: str, device,
               backend, args, kwargs, queue) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        if device is not None and torch.device(device).type == "cpu":
            # the ranks share the host's cores with each other and with
            # the process that spawned them
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // (2 * world)))
        mesh = init_mesh(rank, world, init_method, device, backend)
        try:
            out = fn(mesh, *args, **kwargs)
        finally:
            close_mesh(mesh)
        queue.put((rank, True, out))
    except Exception:                # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, *args, device=None, backend: str | None = None,
          timeout_s: float = 900.0, **kwargs) -> list:
    """Run ``fn(mesh, *args, **kwargs)`` on ``world`` ranks of this host,
    each a fresh process, and return their results in rank order.
    ``device=None``: rank r on ``cuda:r`` under NCCL (raises with fewer
    than ``world`` cards); ``device="cpu"``: every rank on the CPU under
    gloo; a named CUDA device: every rank on it (``backend="gloo"`` for
    more than one rank).  ``fn`` must be importable by name.  A rank that
    raises, or dies, fails the run: the others are stopped and the
    rank's traceback raised here."""
    import multiprocessing as mp
    import queue as queue_mod

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: torch.cuda.is_available() "
                               "is False (pass device='cpu' for the CPU)")
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} ranks need {world} cards, PyTorch "
                               f"sees {torch.cuda.device_count()}")
    else:
        _resolve(device, backend, 0)          # refuse a bad pair up front
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, device, backend, args,
                               kwargs, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        import time
        deadline = time.monotonic() + timeout_s
        while len(results) + len(errors) < world:
            try:
                rank, ok, out = q.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks did not finish in "
                                       f"{timeout_s:.0f} s") from None
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                if dead and q.empty():
                    errors.update((r, f"rank {r} exited with code "
                                   f"{procs[r].exitcode}") for r in dead)
                continue
            (results if ok else errors)[rank] = out
            if errors:
                break
    finally:
        for p in procs:
            if errors:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        q.close()
    if errors:
        r = min(errors)
        raise RuntimeError(f"rank {r} of {world} failed:\n{errors[r]}")
    return [results[r] for r in range(world)]
