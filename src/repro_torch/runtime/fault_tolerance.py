"""Fault-tolerant training runtime: preemption-safe loop, step retry,
straggler watch (counterpart of ``repro.runtime.fault_tolerance``).

The mechanisms are the reference's: a checkpoint cadence that bounds lost
work to ``ckpt_every`` steps, resume from the newest checkpoint, a retry
of a step that fails transiently, a force-save before giving up, and a
watch that reports a step slower than ``timeout_factor`` times the
trailing median.  The data pipeline is a pure function of the step, so a
resumed or replacement host needs no data state.

The transient error retried is :data:`TRANSIENT`,
``torch.cuda.OutOfMemoryError`` (the reference retries
``jax.errors.JaxRuntimeError``).  An out-of-memory error in the forward
or backward leaves the state as it was, so the step runs again; any other
error ends the loop at once.

Training on more than one rank keeps the reference's elastic checkpoints:
the checkpoint holds the full logical train state, gathered from the
ranks' shards and written by rank 0 (:class:`ShardedCheckpointManager`),
so a job resumes at another rank mesh (:func:`elastic_restore`), and a
stop that one rank is asked for is agreed by all before the step ends.
The ranks are a tensor-parallel group, or the rank mesh's default group
with the shards' ``world = (D, M)``: rank ``r`` holds flat shard ``r %
(D * M)`` (``pod`` outermost, its planes copies of one another).
"""
from __future__ import annotations

import signal
import statistics
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_pytree)
from repro_torch.core.collectives import axis_index, axis_size
from repro_torch.exec.timing import Stopwatch
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel import sharding

TRANSIENT = torch.cuda.OutOfMemoryError


@dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    max_step_retries: int = 2
    timeout_factor: float = 3.0


class PreemptionGuard:
    """SIGTERM/SIGINT -> finish the current step, checkpoint, exit cleanly.

    The first signal only sets ``requested`` (the loop drains the current
    step, then checkpoints).  It also restores the original handlers, so
    a second signal is not swallowed: SIGINT raises KeyboardInterrupt at
    once (``run_training`` force-saves on that path) and SIGTERM gets its
    disposition from before the guard."""

    def __init__(self):
        self.requested = False
        self._orig = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._orig[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True
        self._restore()

    def _restore(self):
        for sig, orig in self._orig.items():
            signal.signal(sig, orig)
        self._orig = {}

    def __exit__(self, *exc):
        self._restore()
        return False


@dataclass
class StragglerWatch:
    factor: float = 3.0
    history: list = field(default_factory=list)
    events: list = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step was a straggler."""
        is_straggler = False
        if len(self.history) >= 5:
            median = float(statistics.median(self.history[-20:]))
            if seconds > self.factor * median:
                self.events.append((step, seconds, median))
                is_straggler = True
        self.history.append(seconds)
        return is_straggler


def run_training(step_fn: Callable, state, batch_fn: Callable, *,
                 ft: FTConfig, num_steps: int,
                 on_metrics: Optional[Callable] = None,
                 on_straggler: Optional[Callable] = None,
                 mgr: Optional[CheckpointManager] = None) -> tuple:
    """Preemption-safe training loop.

    ``step_fn(state, batch) -> (state, metrics)``; ``state`` is a tree of
    tensors (nested dicts, tuples, ``AdamWState``).  Resumes from the
    newest checkpoint under ``ft.ckpt_dir`` if there is one, each leaf on
    the device of ``state``'s.  ``mgr`` replaces the checkpoint manager
    (a :class:`ShardedCheckpointManager` for a rank of a tensor-parallel
    job).  Returns (state, last_step, straggler_events)."""
    mgr = mgr or CheckpointManager(ft.ckpt_dir, keep=ft.keep,
                                   every=ft.ckpt_every)
    start = 0
    restored = mgr.restore_or_none(state)
    if restored is not None:
        state, start = restored
        start += 1

    watch = StragglerWatch(factor=ft.timeout_factor)
    with PreemptionGuard() as guard:
        step = start
        try:
            while step < num_steps:
                batch = batch_fn(step)
                sw = Stopwatch()
                for attempt in range(ft.max_step_retries + 1):
                    try:
                        state, metrics = step_fn(state, batch)
                        break
                    except TRANSIENT:
                        if attempt == ft.max_step_retries:
                            mgr.maybe_save(state, step, force=True)
                            raise
                dt = sw.seconds
                if watch.observe(step, dt) and on_straggler:
                    on_straggler(step, dt)
                if on_metrics:
                    on_metrics(step, metrics, dt)
                mgr.maybe_save(state, step)
                if mgr.agree(guard.requested):
                    mgr.maybe_save(state, step, force=True)
                    break
                step += 1
        except KeyboardInterrupt:
            # Second Ctrl-C (the guard restored the default handler):
            # checkpoint the last completed state and leave at once.
            mgr.maybe_save(state, step, force=True)
            raise
    return state, step, watch.events


# --------------------------------------------------------------------------- #
# elastic checkpoints of a tensor-parallel state
# --------------------------------------------------------------------------- #
def elastic_restore(tree_like, ckpt_dir: str, cfg, rank, world,
                    step: Optional[int] = None, device=None):
    """(``rank``'s shard of ``world`` of the checkpointed train state, its
    step): the counterpart of the reference's ``elastic_restore``.

    The checkpoint stores the full logical arrays, so a job restarted at
    another rank mesh reshards as it restores: the full tree is read in
    ``tree_like``'s structure (its leaves give the logical shapes; they
    may lie on the ``meta`` device) onto ``device`` (default: where
    ``tree_like``'s leaves lie, the CPU for ``meta``), and cut by
    :func:`~repro_torch.parallel.sharding.shard_state` (``rank`` and
    ``world`` as it takes them: the model axis's, or ``(data, model)``
    pairs), the port's ``fit_specs`` plus ``NamedSharding``.  At one rank
    the full tree is returned."""
    if device is None:
        device = _first_leaf(tree_like).device
        device = "cpu" if device.type == "meta" else device
    full, step = restore_pytree(tree_like, ckpt_dir, step, device=device)
    return sharding.shard_state(full, cfg, rank, world), step


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (dict, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def _meta(tree):
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def _plane(group, world) -> tuple:
    """(this rank's flat shard index, the shards' world ``(D, M)``)."""
    world = world if world is not None else (1, axis_size(group))
    return axis_index(group) % (world[0] * world[1]), tuple(world)


def gather_state(state, cfg, group, world=None):
    """The full logical train state on rank 0 of ``group``, on the CPU,
    and ``None`` on the other ranks: each leaf not held whole gathered to
    rank 0 (``dist.gather``, one leaf at a time) and the shards of ranks
    ``0 .. D*M - 1`` rebuilt by :func:`~repro_torch.parallel.sharding.
    unshard_params`; a leaf every rank holds whole is rank 0's.  ``group``
    holds every rank, ``world`` is the shards' ``(D, M)`` (default: the
    model axis, the whole group).  Every rank of ``group`` calls it."""
    rank = axis_index(group)
    flat, world = _plane(group, world)
    shards = world[0] * world[1]
    dst = dist.get_global_rank(group, 0)

    def gather(tree, _):
        pieces = [[] for _ in range(shards)]
        for leaf, kind in zip(tree_leaves(tree), tree_leaves(
                sharding.leaf_holding(tree, cfg, flat, world))):
            if kind == "whole":
                got = [leaf.cpu()] * shards if rank == 0 else None
            else:
                got = [torch.empty_like(leaf)
                       for _ in range(axis_size(group))] \
                    if rank == 0 else None
                dist.gather(leaf.contiguous(), got, dst=dst, group=group)
            if rank == 0:
                for r in range(shards):
                    pieces[r].append(got[r].cpu())
        if rank != 0:
            return None
        trees = [tree_map(lambda _, it=iter(p): next(it), tree)
                 for p in pieces]
        return sharding.unshard_params(trees, cfg, world)
    full = sharding.map_state(gather, state)
    return full if rank == 0 else None


class ShardedCheckpointManager(CheckpointManager):
    """keep-k checkpoints of a rank's shard of a train state on several
    ranks, held as the full logical tree, the format both packages read:
    a save gathers it to rank 0 (:func:`gather_state`), which writes it,
    and every rank waits at a barrier; a restore reads it whole and cuts
    this rank's shard (:func:`elastic_restore`), whatever rank mesh wrote
    it.  ``group`` holds every rank and ``world`` is the shards' ``(D,
    M)``, as :func:`gather_state` takes them; ``device`` is where the
    ranks' agreement on a stop runs (the group's: the card under NCCL)."""

    def __init__(self, directory: str, cfg, group, device, keep: int = 3,
                 every: int = 100, world=None):
        super().__init__(directory, keep=keep, every=every)
        self.cfg, self.group, self.device = cfg, group, device
        self.world = world

    def maybe_save(self, tree, step: int, force: bool = False) -> bool:
        if not force and (step == 0 or step % self.every != 0):
            return False
        full = gather_state(tree, self.cfg, self.group, self.world)
        if full is not None:
            super().maybe_save(full, step, force=True)
        dist.barrier(group=self.group)
        return True

    def restore_or_none(self, tree_like):
        if latest_step(self.directory) is None:
            return None
        flat, world = _plane(self.group, self.world)
        logical = sharding.unshard_state([sharding.map_state(
            lambda t, _: _meta(t), tree_like)] * (world[0] * world[1]),
            self.cfg, world)
        return elastic_restore(logical, self.directory, self.cfg, flat,
                               world, device=_first_leaf(tree_like).device)

    def agree(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())
