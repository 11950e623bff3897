"""Rank meshes and process groups (counterpart of ``repro.launch.mesh``).

The reference builds a device mesh over ``("data", "model")`` or
``("pod", "data", "model")``: GSPMD cuts the batch and the FSDP shards
over the first axes, and the TP collectives run over ``model``.  Here each
device is a process: :class:`RankMesh` lays the global ranks out as
``jax.make_mesh`` lays out host devices (row-major) and makes one process
group for each line along each axis (:meth:`RankMesh.groups`);
:func:`make_host_mesh` and :func:`make_production_mesh` are the
reference's shapes.  :func:`init_group` joins the default group, and
:func:`spawn` starts ``world`` ranks and returns what each one's function
returned.  NCCL runs on the card (rank ``r`` on ``cuda:r``); gloo runs
only where the caller asks for the CPU.  A group wider than the card
count raises: there is no gloo or CPU fallback.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue as queue_mod
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600

#: the reference's mesh axes, outermost first
AXES = ("pod", "data", "model")
#: ``make_production_mesh``'s shapes: one pod of 16 x 16, or two
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """Global ranks laid out on named axes: rank ``r`` sits at
    ``np.unravel_index(r, shape)``, the row-major order in which
    ``jax.make_mesh`` places host devices.  ``axes`` is a subsequence of
    :data:`AXES` (``model`` innermost); an axis left out has span 1."""
    shape: tuple
    axes: tuple

    def __post_init__(self):
        shape, axes = tuple(self.shape), tuple(self.axes)
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axes", axes)
        if len(shape) != len(axes) or any(n < 1 for n in shape):
            raise ValueError(f"mesh shape {shape} for axes {axes}")
        if list(axes) != [a for a in AXES if a in axes]:
            raise ValueError(f"mesh axes {axes}: a subsequence of {AXES}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def pairs(self) -> tuple:
        """``((axis, span), ...)``: the form the plan builder keys on."""
        return tuple(zip(self.axes, self.shape))

    def span(self, axis: str) -> int:
        return dict(self.pairs).get(axis, 1)

    def devices(self) -> np.ndarray:
        """The global rank at each mesh position."""
        return np.arange(self.size).reshape(self.shape)

    def coords(self, rank: int) -> dict:
        """``{axis: index}`` of global ``rank``, every axis of
        :data:`AXES` (0 on one the mesh leaves out)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        at = dict(zip(self.axes, np.unravel_index(rank, self.shape)))
        return {a: int(at.get(a, 0)) for a in AXES}

    def lines(self, axis: str) -> list:
        """Every line of global ranks along ``axis``, in row-major order of
        the other axes' positions (each rank alone along an axis the mesh
        leaves out)."""
        ranks = self.devices()
        if axis not in self.axes:
            return [[int(r)] for r in ranks.reshape(-1)]
        moved = np.moveaxis(ranks, self.axes.index(axis), -1)
        return [[int(r) for r in line]
                for line in moved.reshape(-1, self.span(axis))]

    def groups(self, rank: int) -> dict:
        """``{axis: group}`` for ``pod``, ``data`` and ``model``: the
        process group of the line through global ``rank`` along each axis,
        ``None`` where the axis has span 1.  Every rank of the default
        group calls it alike: it makes one ``dist.new_group`` for each
        line of each axis wider than one rank, in one order, keeping the
        ones ``rank`` is in.  A line that is the whole world is the
        default group itself."""
        out = {a: None for a in AXES}
        for axis in self.axes:
            if self.span(axis) == 1:
                continue
            for line in self.lines(axis):
                pg = dist.group.WORLD if len(line) == self.size \
                    else dist.new_group(line)
                if rank in line:
                    out[axis] = pg
        return out


def make_host_mesh(ranks: int, model_parallel: int = 1) -> RankMesh:
    """``(ranks // mp, mp)`` over ``("data", "model")``, ``mp`` the model
    span clipped to ``[1, ranks]``: the reference's ``make_host_mesh``
    over ``ranks`` devices.  ``ranks`` must be a multiple of ``mp``."""
    mp = max(1, min(model_parallel, ranks))
    if ranks % mp:
        raise ValueError(f"{ranks} ranks do not divide into a model axis of "
                         f"{mp}")
    return RankMesh((ranks // mp, mp), ("data", "model"))


def make_production_mesh(multi_pod: bool = False) -> RankMesh:
    """The reference's production mesh: 16 x 16 over ``("data",
    "model")``, or 2 x 16 x 16 over ``("pod", "data", "model")``."""
    return RankMesh(*PRODUCTION[multi_pod])


def init_group(world: int, rank: int, device, store_path: str,
               timeout_s: float = TIMEOUT_S):
    """Join the default process group as ``rank`` of ``world``.

    ``device="cpu"`` takes gloo; a CUDA device takes NCCL on ``cuda:rank``
    and raises when ``world`` exceeds the card count.  Rendezvous is a
    ``FileStore`` at ``store_path`` (a fresh path for each group), not a
    TCP port, so groups that run side by side never collide.  Returns the
    group, with this rank's device beside it.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        backend = "gloo"
    elif dev.type == "cuda":
        count = torch.cuda.device_count()
        if world > count:
            raise RuntimeError(
                f"a group of {world} ranks needs {world} CUDA devices; "
                f"{count} present (no gloo or CPU fallback on the card)")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        raise ValueError(f"no process group backend for device {device!r}")
    store = dist.FileStore(store_path, world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return dist.group.WORLD, dev


def _worker(rank, world, device, store_path, fn, args, results):
    try:
        if device == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        group, dev = init_group(world, rank, device, store_path)
        try:
            out = fn(rank, world, group, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def spawn(fn, world: int, device, args: tuple = (),
          timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(rank, world, group, device, *args)`` on ``world`` spawned
    ranks of one fresh group; return each rank's result, in rank order.

    ``fn`` and its results cross process boundaries by pickling: ``fn`` is
    a module-level function, and a result holds no tensor (numpy arrays,
    numbers and lists pickle by value; a tensor would be shared through
    memory the exiting rank releases).  A rank that
    raises fails the call with its traceback; every process is joined or
    killed before this returns.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_group_") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker,
                             args=(r, world, str(device), store_path, fn,
                                   args, results), daemon=True)
                 for r in range(world)]
        for proc in procs:
            proc.start()
        out, errors = {}, []
        try:
            while len(out) + len(errors) < world:
                try:
                    rank, err, value = results.get(timeout=timeout_s)
                except queue_mod.Empty:
                    raise TimeoutError(
                        f"{world - len(out) - len(errors)} of {world} ranks "
                        f"returned nothing in {timeout_s} s") from None
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                    break               # the others may wait on it forever
                out[rank] = value
        finally:
            for proc in procs:
                proc.join(timeout=30 if not errors else 1)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [out[r] for r in range(world)]
