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
error ends the loop at once.  Restoring onto a different number of ranks
(the reference's ``elastic_restore``) waits for tensor-parallel training
(ROADMAP.md).
"""
from __future__ import annotations

import signal
import statistics
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.exec.timing import Stopwatch

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
                 on_straggler: Optional[Callable] = None) -> tuple:
    """Preemption-safe training loop.

    ``step_fn(state, batch) -> (state, metrics)``; ``state`` is a tree of
    tensors (nested dicts, tuples, ``AdamWState``).  Resumes from the
    newest checkpoint under ``ft.ckpt_dir`` if there is one, each leaf on
    the device of ``state``'s.  Returns (state, last_step,
    straggler_events)."""
    mgr = CheckpointManager(ft.ckpt_dir, keep=ft.keep, every=ft.ckpt_every)
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
                if guard.requested:
                    mgr.maybe_save(state, step, force=True)
                    break
                step += 1
        except KeyboardInterrupt:
            # Second Ctrl-C (the guard restored the default handler):
            # checkpoint the last completed state and leave at once.
            mgr.maybe_save(state, step, force=True)
            raise
    return state, step, watch.events
