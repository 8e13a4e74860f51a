"""Multi-GPU meshes on ``torch.distributed``: the counterpart of the JAX
package's ``parallel/mesh.py`` (``make_mesh``, ``shard_batch``,
``shard_points``, ``replicate``).

JAX has one controller: the host holds the whole batch and ``shard_map``
splits it over the devices. The port runs one process per rank, and every
rank executes the same program (SPMD): each builds the same host-side
batch, from the same seeds, and takes its own rows of it
(:meth:`Mesh.shard`). The sharded paths need three small collectives and a
broadcast, all on :class:`Mesh`: an all-gather of fixed-shape tensors (the
per-rank partial points of an MSM, the provers' byte rows), an all-reduce
sum of an int32 count, and a broadcast of a byte buffer.

Backend: NCCL when every rank has a card of its own, gloo on the CPU and
for ranks that share a card (NCCL refuses two ranks on one GPU). For gloo
the mesh stages its tensors through the host; they are tiny (a 4 x 10
int32 point, a count, a few hundred bytes of proof a lane). Gloo is never
taken because NCCL failed: ``backend=`` overrides the choice, nothing else.

:func:`launch` starts the ranks of one program on this host, each a
``spawn`` process, and returns their results.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

#: how long a collective waits for the other ranks before it raises
GROUP_TIMEOUT_S = 120
#: how long a rank that has reported may take to leave its group and exit
EXIT_GRACE_S = 60
#: the bytes of an error message that :meth:`Mesh.first_error` shares
ERROR_BYTES = 512


def _choose_backend(device: torch.device, ranks_on_host: int) -> str:
    """NCCL when each of this host's ranks has a card of its own, else gloo."""
    if device.type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


class Mesh:
    """The ranks of one process group, and this rank's device.

    ``rank`` and ``size`` are this process's place in the group; ``device``
    is the torch device its share of a batch runs on. ``backend`` is the
    group's ("nccl" or "gloo")."""

    def __init__(self, group, device: torch.device, backend: str):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = device
        self.backend = backend

    # -- sharding ------------------------------------------------------------

    def local_slice(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n``; raises ValueError
        unless the ranks divide ``n``."""
        if n % self.size:
            raise ValueError(f"batch {n} not divisible by {self.size} devices")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard(self, x):
        """This rank's rows of ``x``'s leading axis (``shard_batch`` and
        ``shard_points``): a tensor, moved to the mesh's device; a named
        tuple such as a point or a commitment, each field likewise; a numpy
        array or a sequence, sliced."""
        if hasattr(type(x), "_fields"):
            return type(x)(*(self.shard(c) for c in x))
        if isinstance(x, torch.Tensor):
            return x[self.local_slice(x.shape[0])].to(self.device)
        return x[self.local_slice(len(x))]

    def replicate(self, x):
        """``x`` whole on the mesh's device (a tensor or a named tuple of
        them)."""
        if hasattr(type(x), "_fields"):
            return type(x)(*(self.replicate(c) for c in x))
        return x.to(self.device)

    # -- collectives -----------------------------------------------------------

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """Where the backend's collectives read: the host for gloo, the
        mesh's device for NCCL."""
        return t.contiguous().cpu() if self.backend == "gloo" else t.contiguous().to(self.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all ranks), stacked in rank
        order on a new leading axis, on ``t``'s device."""
        src = self._stage(t)
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return torch.stack(out).to(t.device)

    def gather_rows(self, rows: np.ndarray) -> np.ndarray:
        """Every rank's rows (one shape on all ranks), concatenated along
        the leading axis in rank order: the counterpart of fetching a
        lane-sharded output."""
        out = self.all_gather(torch.from_numpy(np.ascontiguousarray(rows)))
        return out.reshape((-1,) + rows.shape[1:]).numpy()

    def all_reduce_sum(self, count: int) -> int:
        """The sum over the ranks of an int32 count."""
        t = self._stage(torch.tensor([count], dtype=torch.int32))
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return int(t.item())

    def broadcast_bytes(self, data: bytes, src: int = 0) -> bytes:
        """Rank ``src``'s byte buffer, on every rank."""
        n = self._stage(torch.tensor([len(data)], dtype=torch.int64))
        dist.broadcast(n, src, group=self.group)
        if not int(n.item()):
            return b""
        buf = torch.zeros(int(n.item()), dtype=torch.uint8)
        if self.rank == src:
            buf = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        buf = self._stage(buf)
        dist.broadcast(buf, src, group=self.group)
        return buf.cpu().numpy().tobytes()

    def first_error(self, message: str) -> str:
        """The message of the lowest rank that has one ("" where none has).
        A rank that meets a bad input reports it here instead of raising,
        so that no rank is left waiting in a later collective, and every
        rank raises the same error, as the single-device call would."""
        row = np.zeros(ERROR_BYTES, np.uint8)
        enc = message.encode()[:ERROR_BYTES]
        row[:len(enc)] = np.frombuffer(enc, np.uint8)
        for r in self.gather_rows(row[None]):
            if r.any():
                return r.tobytes().rstrip(b"\0").decode(errors="replace")
        return ""


def make_mesh(n_devices: Optional[int] = None, device="cuda", backend: Optional[str] = None,
              init_method: Optional[str] = None) -> Mesh:
    """The mesh of this process's group.

    Joins the default group where one is initialized; else starts one from
    the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, or
    ``init_method``), or, where there is none, a group of this process
    alone. A CUDA rank runs on ``cuda:{LOCAL_RANK % device_count}``.
    ``device="cuda"``, the default, raises without a GPU. ``n_devices``,
    where given, must be the world size."""
    dev = resolve_device(device)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ.get("RANK", "0"))
        world = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices asked for; the world has {world} ranks")
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return Mesh(dist.group.WORLD, dev, dist.get_backend())
    backend = backend or _choose_backend(dev, local_world)
    group_args = dict(rank=rank, world_size=world, device_id=dev if backend == "nccl" else None,
                      timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world != 1:
            raise RuntimeError(f"WORLD_SIZE={world} but no MASTER_ADDR and no init_method")
        dist.init_process_group(backend, store=dist.HashStore(), **group_args)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", **group_args)
    return Mesh(dist.group.WORLD, dev, backend)


# ---------------------------------------------------------------------------
# launching the ranks of one program on this host
# ---------------------------------------------------------------------------

def _resolve_target(target: str):
    module, _, name = target.partition(":")
    if not module.startswith("quisquis_tpu_torch.") or not name:
        raise ValueError(f"target {target!r}: expected 'quisquis_tpu_torch.<module>:<function>'")
    return getattr(importlib.import_module(module), name)


def _rank_main(target, rank, world, device, backend, init_method, args, results):
    """One rank: join the group, run ``target(mesh, *args)``, report."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    try:
        mesh = make_mesh(world, device, backend, init_method)
        try:
            out = ("ok", _resolve_target(target)(mesh, *args))
        finally:
            dist.destroy_process_group()
    except Exception:  # the rank's boundary: the parent raises it
        out = ("error", traceback.format_exc())
    results.put((rank, out))


def launch(target: str, world: int, device="cuda", backend: Optional[str] = None,
           timeout_s: float = 600, args=()) -> list:
    """Run ``target(mesh, *args)`` on ``world`` ranks of this host and
    return the ranks' results in rank order.

    ``target`` is ``"quisquis_tpu_torch.<module>:<function>"``: each rank
    is a fresh ``spawn`` process (never ``fork``: the caller may hold a
    CUDA context or JAX's threads) that imports the target's module only.
    ``args`` and the results are pickled. On CUDA the parent builds the
    kernels first, so that no rank runs nvcc. Raises RuntimeError, after
    killing every rank still running, if a rank failed or the ranks were
    not all done within ``timeout_s``."""
    dev = resolve_device(device)
    _resolve_target(target)
    if dev.type == "cuda":
        from ..ops.cuda_build import load_library

        load_library()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="qq-mesh-")
    init_method = "file://" + os.path.join(store, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, world, str(device), backend, init_method, args,
                               results))
             for r in range(world)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline, exited = time.monotonic() + timeout_s, set()
        while len(out) < world:
            try:
                rank, res = results.get(timeout=1.0)
            except _queue.Empty:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{target}: ranks {sorted(set(range(world)) - set(out))} "
                                       f"not done within {timeout_s} s") from None
                # a rank's result is in the pipe before it exits: one that
                # has exited through a whole wait without one never sent it
                lost = exited - set(out)
                if lost:
                    r = min(lost)
                    raise RuntimeError(f"{target}: rank {r} exited with code "
                                       f"{procs[r].exitcode} and no result") from None
                exited = {r for r, p in enumerate(procs) if p.exitcode is not None}
                continue
            if res[0] == "error":
                raise RuntimeError(f"{target}: rank {rank} failed:\n{res[1]}")
            out[rank] = res[1]
        for r, p in enumerate(procs):
            p.join(EXIT_GRACE_S)
            if p.exitcode is None:
                raise RuntimeError(f"{target}: rank {r} did not exit after reporting")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    return [out[r] for r in range(world)]
