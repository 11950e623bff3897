"""Request queue + continuous-batching scheduler (a copy of
``repro.serve.batching``, kept in the port so that it imports nothing of the
JAX package).

Continuous batching: requests join and leave the running batch at token
boundaries only.  Admission happens at the top of an iteration when (a) a
cache slot is free and (b) the paged-KV block allocator can reserve the
request's worst-case footprint (prompt + max_new, see
:mod:`repro_torch.serve.kvcache`).  Policies: ``fcfs`` (arrival order) or
``priority`` (lower value first, arrival-stable).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

POLICIES = ("fcfs", "priority")


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.

    ``prompt`` carries real token ids when the request targets the
    execution engine; the cluster simulator only needs ``prompt_len``.
    """

    rid: str
    prompt_len: int
    max_new: int
    arrival: float = 0.0
    priority: int = 0
    prompt: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        if self.prompt_len <= 0 or self.max_new <= 0:
            raise ValueError(f"{self.rid}: prompt_len and max_new must be "
                             "positive")
        if self.prompt is not None and len(self.prompt) != self.prompt_len:
            raise ValueError(f"{self.rid}: prompt/prompt_len mismatch")

    @property
    def total_positions(self) -> int:
        """Worst-case cache footprint (block reservation unit)."""
        return self.prompt_len + self.max_new


@dataclasses.dataclass
class RequestState:
    """Mutable per-request serving state (engine and simulator)."""

    req: Request
    slot: int
    admit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    generated: list = dataclasses.field(default_factory=list)

    @property
    def pos(self) -> int:
        """Next cache position to write = prompt + tokens generated."""
        return self.req.prompt_len + len(self.generated)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.req.max_new


class RequestQueue:
    """Deterministic admission queue (fcfs | priority)."""

    def __init__(self, policy: str = "fcfs") -> None:
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.policy = policy
        self._heap: list = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, req: Request) -> None:
        key = (req.priority, req.arrival, self._seq) \
            if self.policy == "priority" else (req.arrival, self._seq)
        heapq.heappush(self._heap, (key, self._seq, req))
        self._seq += 1

    def peek(self) -> Optional[Request]:
        return self._heap[0][2] if self._heap else None

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]


class Scheduler:
    """Slot + block admission control for continuous batching.

    Owns the free-slot set and consults the cache's
    :class:`~repro_torch.serve.kvcache.BlockAllocator` before seating a request.
    Head-of-line semantics: admission stops at the first request that does
    not fit, preserving the policy order (no starvation by smaller
    latecomers).
    """

    def __init__(self, slots: int, kv, policy: str = "fcfs") -> None:
        self.slots = slots
        self.kv = kv                       # PagedKVCache (or stand-in)
        self.queue = RequestQueue(policy)
        self.active: dict[int, RequestState] = {}
        self._free_slots = list(range(slots - 1, -1, -1))   # pop -> lowest

    # ------------------------------------------------------------------ #
    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def has_work(self) -> bool:
        return bool(self.active) or len(self.queue) > 0

    def submit(self, req: Request) -> None:
        self.queue.push(req)

    def admit(self, now: float = 0.0) -> list[RequestState]:
        """Seat queued requests (policy order) while a slot and blocks are
        available; returns the newly admitted states."""
        admitted = []
        while self._free_slots:
            req = self.queue.peek()
            if req is None or req.arrival > now:
                break
            if not self.kv.can_admit(req.total_positions):
                break                      # head-of-line blocks the rest
            self.queue.pop()
            slot = self._free_slots.pop()
            self.kv.admit(req.rid, req.total_positions)
            st = RequestState(req=req, slot=slot, admit_time=now)
            self.active[slot] = st
            admitted.append(st)
        return admitted

    def finish(self, slot: int, now: float = 0.0) -> RequestState:
        """Evict a completed request: release its blocks, free the slot."""
        st = self.active.pop(slot)
        st.finish_time = now
        self.kv.release(st.req.rid)
        self._free_slots.append(slot)
        self._free_slots.sort(reverse=True)
        return st

    def next_arrival(self) -> Optional[float]:
        req = self.queue.peek()
        return None if req is None else req.arrival
