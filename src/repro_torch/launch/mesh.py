"""Process groups for tensor parallelism (counterpart of
``repro.launch.mesh``).

The reference builds a device mesh whose ``model`` axis the TP collectives
run over.  Here each rank of that axis is a process: :func:`init_group`
joins one, and :func:`spawn` starts ``world`` of them and returns what each
one's function returned.  NCCL runs on the card (rank ``r`` on
``cuda:r``); gloo runs only where the caller asks for the CPU.  A group
wider than the card count raises: there is no gloo or CPU fallback.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600


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
