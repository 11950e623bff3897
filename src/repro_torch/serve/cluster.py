"""Request-level cluster simulator: fleets of serving instances on a
shared NoC cost model (a copy of ``repro.serve.cluster``).

Answers the capacity question ("how many 8x8 meshes serve this traffic at
p99 X ms?") by replaying a seeded workload through N simulated instances.
Each instance reuses the engine's *actual* admission machinery — a
:class:`~repro_torch.serve.batching.Scheduler` over a block-accounting stand-in
with the same free-list arithmetic as the paged KV cache — and advances in
continuous-batching iterations whose latencies come from a
:class:`~repro_torch.serve.costs.PlanCostModel` (per-phase ExecutionPlans, NoC
psum cycles) or a synthetic model in tests.

Iteration semantics mirror :class:`~repro_torch.serve.engine.ServingEngine`
exactly: an iteration admits, chunk-prefills the admissions (first token),
then runs one decode step over every slot still needing tokens.  The event
loop is a plain heap with an insertion-order tiebreak, all arithmetic is
python floats, and no wall-clock enters any record — same seed, same
bytes.

Degradation (DESIGN.md S15): a seeded replica-failure trace
(:func:`replica_failure_trace`, or explicit ``(t, instance, kind)``
events) takes instances down and up mid-run.  Going down evicts the
instance's in-flight requests — their progress is lost, and each re-enters
the cluster after a capped exponential backoff, keeping its *original*
arrival so e2e/TTFT absorb every retry — and re-dispatches its queued
(never-started) requests immediately.  A request evicted more than
``max_retries`` times fails; completed/submitted is the run's goodput.
In-flight iteration completions from before the failure are dropped by an
epoch counter.  An empty trace leaves every code path and record
byte-identical to the fault-free simulator.
"""
from __future__ import annotations

import heapq
import math
import random

from repro_torch.serve.batching import Request, Scheduler
from repro_torch.serve.kvcache import BlockAllocator
from repro_torch.serve.metrics import summarize


class SimKV:
    """Block accounting only — the scheduler-facing surface of
    :class:`~repro_torch.serve.kvcache.PagedKVCache` without the pools."""

    def __init__(self, block_size: int, num_blocks: int) -> None:
        self.block_size = block_size
        self.allocator = BlockAllocator(num_blocks)

    def blocks_for(self, positions: int) -> int:
        return math.ceil(positions / self.block_size)

    def can_admit(self, positions: int) -> bool:
        return self.allocator.can_alloc(self.blocks_for(positions))

    def admit(self, rid, positions: int) -> None:
        self.allocator.alloc(rid, self.blocks_for(positions))

    def release(self, rid) -> int:
        return self.allocator.free(rid)


class _Instance:
    def __init__(self, idx: int, slots: int, block_size: int,
                 num_blocks: int, policy: str) -> None:
        self.idx = idx
        self.kv = SimKV(block_size, num_blocks)
        self.sched = Scheduler(slots, self.kv, policy)
        self.busy = False
        self.down = False          # replica failed (dispatch skips it)
        self.epoch = 0             # bumped per failure; stale iters drop
        self.work = 0              # outstanding work units (dispatch key)
        self.iterations = 0
        self._grants: list = []    # (slot, tokens, is_first) for this iter


def replica_failure_trace(fleet: int, horizon_s: float, *,
                          mtbf_s: float, mttr_s: float,
                          seed: int = 0) -> list[tuple]:
    """Seeded alternating down/up events, ``(t, instance, kind)`` sorted.

    Per instance, time-to-failure and time-to-repair are exponential draws
    (``mtbf_s`` / ``mttr_s`` means) from one ``random.Random(seed)``
    stream in fixed instance order — the trace is a pure function of its
    arguments.  Events past ``horizon_s`` are dropped; an instance down at
    the horizon simply stays down."""
    rng = random.Random(seed)
    events: list[tuple] = []
    for idx in range(fleet):
        t = rng.expovariate(1.0 / mtbf_s)
        while t < horizon_s:
            events.append((round(t, 9), idx, "down"))
            t += rng.expovariate(1.0 / mttr_s)
            if t >= horizon_s:
                break
            events.append((round(t, 9), idx, "up"))
            t += rng.expovariate(1.0 / mtbf_s)
    events.sort()
    return events


class ClusterSimulator:
    def __init__(self, fleet: int, *, slots: int = 8, block_size: int = 16,
                 num_blocks: int | None = None, max_seq: int = 1024,
                 prefill_chunk: int = 64, cost=None, policy: str = "fcfs",
                 failures: "list[tuple] | None" = None,
                 max_retries: int = 3, retry_backoff_s: float = 0.5,
                 retry_backoff_cap_s: float = 8.0) -> None:
        if fleet <= 0:
            raise ValueError("fleet must be positive")
        if cost is None:
            raise ValueError("ClusterSimulator needs a cost model "
                             "(PlanCostModel or SyntheticCostModel)")
        if num_blocks is None:
            num_blocks = slots * math.ceil(max_seq / block_size)
        self.cost = cost
        self.prefill_chunk = prefill_chunk
        self.instances = [_Instance(i, slots, block_size, num_blocks, policy)
                          for i in range(fleet)]
        self.failures = list(failures or ())
        for t, idx, kind in self.failures:
            if kind not in ("down", "up") or not 0 <= idx < fleet:
                raise ValueError(f"bad failure event {(t, idx, kind)!r}")
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        self.records: list[dict] = []
        self.events = 0
        self.retries = 0
        self.downtime_events = 0
        self.failed_requests: list = []
        self._attempts: dict = {}       # rid -> eviction count
        self._pending: list = []        # arrivals while every replica down

    # ------------------------------------------------------------------ #
    def _work_units(self, req: Request) -> int:
        return req.max_new + math.ceil(req.prompt_len / self.prefill_chunk)

    def _dispatch(self, req: Request) -> "_Instance | None":
        """Least-outstanding-work *up* instance, lowest index on ties;
        ``None`` when the whole fleet is down (caller parks the request
        until the next ``up`` event)."""
        up = [inst for inst in self.instances if not inst.down]
        if not up:
            return None
        return min(up, key=lambda inst: (inst.work, inst.idx))

    def _start_iteration(self, inst: _Instance, t: float, push) -> None:
        admitted = inst.sched.admit(now=t)
        active = inst.sched.active
        if not active:
            if len(inst.sched.queue):
                head = inst.sched.queue.peek()
                raise RuntimeError(
                    f"request {head.rid!r} can never be admitted on "
                    f"instance {inst.idx} (prompt+max_new "
                    f"{head.total_positions} exceeds capacity)")
            inst.busy = False
            return
        admitted_slots = {st.slot for st in admitted}
        dt = sum(math.ceil(st.req.prompt_len / self.prefill_chunk)
                 * self.cost.prefill_chunk_seconds() for st in admitted)
        grants = []
        participants = 0
        for slot, st in active.items():
            gained = 0
            if slot in admitted_slots:
                gained += 1                       # prefill emits token #1
            if len(st.generated) + gained < st.req.max_new \
                    or slot not in admitted_slots:
                gained += 1                       # decode step token
                participants += 1
            grants.append((slot, gained, slot in admitted_slots))
        if participants:
            dt += self.cost.decode_iter_seconds(participants)
        inst._grants = grants
        inst.busy = True
        inst.iterations += 1
        push(t + dt, "iter", (inst, inst.epoch))

    def _end_iteration(self, inst: _Instance, t: float, push) -> None:
        for slot, gained, is_first in inst._grants:
            st = inst.sched.active[slot]
            if is_first:
                st.first_token_time = t
            st.generated.extend([0] * min(
                gained, st.req.max_new - len(st.generated)))
        for slot in sorted(inst.sched.active):
            st = inst.sched.active[slot]
            if not st.done:
                continue
            inst.sched.finish(slot, now=t)
            inst.work -= self._work_units(st.req)
            self.records.append({
                "rid": st.req.rid, "instance": inst.idx,
                "arrival": st.req.arrival, "admit": st.admit_time,
                "first_token": st.first_token_time, "finish": t,
                "prompt_len": st.req.prompt_len,
                "max_new": st.req.max_new,
            })
        self._start_iteration(inst, t, push)

    def _fail_instance(self, inst: _Instance, t: float, push) -> None:
        """Take a replica down: in-flight requests lose their progress and
        retry with capped exponential backoff (or fail past the retry
        budget); queued-but-unstarted requests re-dispatch at once."""
        if inst.down:
            return
        inst.down = True
        inst.epoch += 1          # any in-flight iter completion is stale
        inst.busy = False
        inst._grants = []
        self.downtime_events += 1
        for slot in sorted(inst.sched.active):
            st = inst.sched.finish(slot, now=t)
            req = st.req
            k = self._attempts[req.rid] = self._attempts.get(req.rid, 0) + 1
            if k > self.max_retries:
                self.failed_requests.append(req.rid)
                continue
            self.retries += 1
            backoff = min(self.retry_backoff_cap_s,
                          self.retry_backoff_s * 2 ** (k - 1))
            push(t + backoff, "arrival", req)
        while len(inst.sched.queue):
            push(t, "arrival", inst.sched.queue.pop())
        inst.work = 0

    # ------------------------------------------------------------------ #
    def run(self, requests: list[Request],
            max_events: int = 5_000_000) -> dict:
        heap: list = []
        seq = 0

        def push(t: float, kind: str, payload) -> None:
            nonlocal seq
            heapq.heappush(heap, (t, seq, kind, payload))
            seq += 1

        for ev in sorted(self.failures):
            push(ev[0], ev[2], ev[1])
        for req in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            push(req.arrival, "arrival", req)

        while heap:
            if self.events >= max_events:
                raise RuntimeError(f"simulation exceeded {max_events} events")
            t, _, kind, payload = heapq.heappop(heap)
            self.events += 1
            if kind == "arrival":
                inst = self._dispatch(payload)
                if inst is None:
                    self._pending.append(payload)
                    continue
                inst.work += self._work_units(payload)
                inst.sched.submit(payload)
                if not inst.busy:
                    self._start_iteration(inst, t, push)
            elif kind == "iter":
                inst, epoch = payload
                if epoch != inst.epoch:
                    continue         # completed on a replica that failed
                self._end_iteration(inst, t, push)
            elif kind == "down":
                self._fail_instance(self.instances[payload], t, push)
            else:                    # "up"
                self.instances[payload].down = False
                parked, self._pending = self._pending, []
                for req in parked:
                    push(t, "arrival", req)

        metrics = summarize(self.records)
        metrics["fleet"] = len(self.instances)
        metrics["iterations"] = sum(i.iterations for i in self.instances)
        metrics["events"] = self.events
        metrics["per_instance_requests"] = [
            sum(1 for r in self.records if r["instance"] == i.idx)
            for i in self.instances]
        metrics["goodput"] = len(self.records) / max(1, len(requests))
        metrics["retries"] = self.retries
        metrics["failed_requests"] = len(self.failed_requests)
        metrics["downtime_events"] = self.downtime_events
        return metrics


def search_fleet(requests: list[Request], slo_s: float,
                 metric: str = "e2e_s", max_fleet: int = 16,
                 cost_by_chips: "dict[int, object] | None" = None,
                 **sim_kwargs) -> dict:
    """Smallest fleet whose p99 ``metric`` meets ``slo_s``.

    Returns ``{"fleet": n | None, "slo_s", "metric", "searched": [...]}``
    where ``searched`` records every fleet size tried with its p99 —
    capacity is monotone in fleet size for this workload model, so the
    first size that meets the SLO is the answer.

    ``cost_by_chips`` (DESIGN.md S14) maps chips-per-replica to a cost
    model (e.g. multi-chip :class:`~repro_torch.serve.costs.PlanCostModel`s) and
    turns the search two-dimensional: every chip option runs its own fleet
    sweep, ``searched`` rows gain ``chips_per_replica``/``total_chips``,
    and the answer minimizes **total chips** (replicas x chips each; fewer
    chips per replica breaks ties — bigger replicas must earn their
    silicon).  The flat call (``cost_by_chips=None``) is byte-identical to
    the pre-hierarchy behaviour.
    """
    if cost_by_chips is not None:
        searched: list[dict] = []
        best = None                       # (total_chips, chips, answer)
        for chips in sorted(cost_by_chips):
            kwargs = dict(sim_kwargs, cost=cost_by_chips[chips])
            ans = search_fleet(requests, slo_s, metric=metric,
                               max_fleet=max_fleet, **kwargs)
            for row in ans["searched"]:
                row["chips_per_replica"] = chips
                row["total_chips"] = chips * row["fleet"]
            searched.extend(ans["searched"])
            if ans["fleet"] is not None:
                key = (chips * ans["fleet"], chips)
                if best is None or key < best[0]:
                    best = (key, chips, ans)
        if best is None:
            return {"fleet": None, "chips_per_replica": None,
                    "total_chips": None, "slo_s": slo_s, "metric": metric,
                    "searched": searched, "metrics": None}
        _, chips, ans = best
        return {"fleet": ans["fleet"], "chips_per_replica": chips,
                "total_chips": chips * ans["fleet"], "slo_s": slo_s,
                "metric": metric, "searched": searched,
                "metrics": ans["metrics"]}

    searched = []
    chosen = None
    chosen_metrics = None
    for n in range(1, max_fleet + 1):
        sim = ClusterSimulator(n, **sim_kwargs)
        metrics = sim.run(requests)
        p99 = metrics[metric]["p99"]
        searched.append({"fleet": n, "p99_s": p99,
                         "throughput_rps": metrics["throughput_rps"]})
        if p99 <= slo_s:
            chosen, chosen_metrics = n, metrics
            break
    return {"fleet": chosen, "slo_s": slo_s, "metric": metric,
            "searched": searched, "metrics": chosen_metrics}
