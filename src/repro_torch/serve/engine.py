"""ServingEngine: continuous batching + paged KV (counterpart of
``repro.serve.engine``).

Per iteration it

1. admits queued requests into free cache slots (token boundary only),
2. prefills each admitted prompt (chunked batched prefill through
   :func:`~repro_torch.parallel.steps.build_prefill_step`, or a per-token
   decode loop for a family without a batched prefill: ssm, moe, mla_moe,
   hybrid),
   writing the prompt's cache into the paged pool and emitting the first
   token,
3. runs one per-slot-position decode step over the whole slot batch,
   appends one token per active request, and pages out the newly written
   cache column,
4. retires finished requests, releasing their blocks and slot.

Each slot computes what the request would compute running alone (every
row of the decode step has its own position and mask, an MoE layer routes
each row as its own group, and the matmul kernel sums each row in the
same order whatever the batch), so joining or leaving the batch cannot
change a request's tokens.

The encdec and vlm families take media inputs that no request carries,
so the engine refuses them, as the reference's does; they serve through
``launch/serve.py``'s legacy loop.

The engine takes ``params`` (or a ``param_seed`` for a seeded
``torch.Generator``) and a ``device``; the reference builds its own
weights from a JAX key.

Prefill and decode are disaggregated: each phase carries its own
``ParallelCtx`` and, under ``--psum-mode auto``, its own
:class:`~repro_torch.plan.ExecutionPlan` (``prefill_plan``,
``decode_plan``; see ``launch/serve.py``).  The per-token prompt loop of a
family without a batched prefill runs under the prefill plan, as the
reference's does.

With a ``group`` of several ranks (tensor parallelism) every rank runs an
engine on the same requests: it cuts the full ``params`` to its shard
(:func:`repro_torch.parallel.sharding.shard_params`), pools its own cache
(its KV heads; the whole MLA latent; its RWKV6 or Mamba2 heads' states),
and runs the same deterministic schedule, so every rank calls each
collective at the same point.  The logits are gathered whole on every rank,
so every rank picks the same tokens; ``check`` asserts that at each retire.

On the rank mesh (``data_group``, ``pod_group``: the reference's engine
serves on ``make_host_mesh(model_parallel)``, every device the model axis
does not take on ``data``) data rank ``h`` of the ``H`` hosts (pod x data)
holds slots ``[h S/H, (h+1) S/H)`` of the working cache, the reference's
``cache_specs`` cut of its batch axis, and writes and reads the pooled
rows of the requests seated there.  Every rank runs the one scheduler on
every slot: a decode step computes the rank's slot rows, and their next
tokens are all-gathered over ``data`` and ``pod``, so every rank admits,
seats and retires alike.  The steps' ``ParallelCtx`` carries no data or
pod group: an MoE layer routes each slot of the paged step as its own
group (the reference's is a ``vmap`` of a B=1 decode), so no host's rows
meet another's.  A prompt's prefill (B 1) runs on every rank,
whose per-layer gathers every rank must join; only the slot's owner keeps
the rows it wrote.  Slots the hosts do not divide are replicated over
them (the reference's ``fit_specs`` drops the ``data`` axis of such a
batch): every host holds and computes every slot, and nothing is
gathered.  The rank holds its FSDP pieces of the weights and
gathers each layer's whole as a step takes it
(:mod:`repro_torch.parallel.fsdp`), or, under
``serve_replicated_params``, the whole model shard gathered once here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import _device
from repro_torch.configs.base import ModelConfig
from repro_torch.exec.timing import Stopwatch
from repro_torch.models.api import MEDIA_FAMILIES, cache_leaves, get_model
from repro_torch.parallel import fsdp
from repro_torch.parallel.fsdp import serving_params
from repro_torch.parallel.steps import (build_paged_serve_step,
                                        build_prefill_step, build_serve_step)
from repro_torch.parallel.tp import Hosts, ParallelCtx
from repro_torch.serve.batching import Request, RequestState, Scheduler
from repro_torch.serve.kvcache import PagedKVCache


@dataclasses.dataclass
class EngineReport:
    """What one :meth:`ServingEngine.run` did."""

    requests: list                 # per-request dicts, finish order
    iterations: int
    prefill_chunks: int
    decode_steps: int
    checks: int                    # paged==monolithic verifications passed
    prefill_ms: float              # host clock, each phase ends on a sync
    decode_ms: float

    def tokens(self) -> dict:
        return {r["rid"]: r["tokens"] for r in self.requests}


class ServingEngine:
    def __init__(self, cfg: ModelConfig, *, params: Optional[dict] = None,
                 param_seed: int = 0, device="cuda", slots: int = 4,
                 max_seq: Optional[int] = None, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 8,
                 psum_mode: str = "ina", prefill_plan=None,
                 decode_plan=None, batched_prefill: bool = True,
                 policy: str = "fcfs", check: bool = False,
                 group=None, data_group=None, pod_group=None,
                 serve_replicated_params: bool = False) -> None:
        if cfg.family in MEDIA_FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} needs per-request media plumbing; "
                "use launch/serve.py --legacy-loop")
        pctx = ParallelCtx(group=group, psum_mode=psum_mode,
                           serve_replicated_params=serve_replicated_params)
        self.pctx = pctx
        self.hosts = hosts = Hosts(data_group, pod_group)
        # this rank's slots: its cut of them, or all where the hosts do
        # not divide them (replicated rows)
        self.replicated = slots % hosts.count != 0
        self.local = slots if self.replicated else slots // hosts.count
        self.lo = 0 if self.replicated else hosts.index * self.local
        self.device = _device.resolve(device)
        self.cfg = cfg
        self.model = get_model(cfg)
        self.slots = slots
        self.max_seq = max_seq or cfg.max_seq
        self.prefill_chunk = prefill_chunk
        self.check = check
        if num_blocks is None:
            # enough for every slot to hold a full-length request
            num_blocks = slots * math.ceil(self.max_seq / block_size)
        self.kv = PagedKVCache(cfg, self.max_seq, block_size, num_blocks,
                               device=self.device, world=pctx.world,
                               rank=pctx.rank)
        self.sched = Scheduler(slots, self.kv, policy)

        self.step = build_paged_serve_step(self.model, pctx, plan=decode_plan)
        self.baxis = self.step.cache_batch_axes
        self.prefill_step = None
        if batched_prefill and self.model.has_prefill:
            self.prefill_step = build_prefill_step(self.model, prefill_chunk,
                                                   pctx, plan=prefill_plan)
            # room for the padded tail of the last chunk
            plen = math.ceil(self.max_seq / prefill_chunk) * prefill_chunk
            self._pcache = self._cache(1, plen)
        else:
            # per-token fallback: a B=1 decode loop doubles as prefill
            self._loop_step = build_serve_step(self.model, pctx,
                                               plan=prefill_plan)

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(param_seed)
            params = self.model.init(gen, device=self.device)
        self.params, self.dims = serving_params(params, cfg, pctx,
                                                data_group)
        self.working = self._cache(self.local, self.max_seq)

    def _cache(self, batch: int, max_seq: int) -> dict:
        return self.model.init_cache(batch, max_seq, device=self.device,
                                     world=self.pctx.world,
                                     rank=self.pctx.rank)

    # ------------------------------------------------------------------ #
    def _row(self, cache: dict, slot: int) -> dict:
        """One slot's cache row by leaf path: views, batch axis removed."""
        return {name: leaf.select(self.baxis[name], slot)
                for name, leaf in cache_leaves(cache).items()}

    def _owns(self, slot: int) -> bool:
        """Whether ``slot`` is one of this rank's working-cache rows."""
        return self.lo <= slot < self.lo + self.local

    def _run(self, step, batch: dict, cache: dict):
        """``step.fn`` on this rank's weights: under FSDP pieces the
        leaves outside the layers gathered for the step, each layer's as
        the step takes it."""
        with fsdp.serving(self.params, self.dims,
                          self.hosts.data_group) as params:
            return step.fn(params, batch, cache)

    def _seat(self, st: RequestState) -> None:
        """Copy the request's pooled row into its working-cache slot (on
        the slot's owner): paged leaves with zeros past its length (masked
        by decode attention), unpaged leaves (recurrent state) whole."""
        if not self._owns(st.slot):
            return
        row = self.kv.gather_row(st.req.rid, st.req.prompt_len)
        for name, dst in self._row(self.working,
                                   st.slot - self.lo).items():
            dst.copy_(row[name])

    def _prefill(self, st: RequestState):
        """Run the prompt, write its K/V into the pool; return (first
        generated token, chunk/step count, first-token logits)."""
        req = st.req
        prompt = torch.tensor(req.prompt, dtype=torch.long)
        plen = req.prompt_len
        steps = 0
        if self.prefill_step is not None:
            chunk = self.prefill_chunk
            for c0 in range(0, plen, chunk):
                part = prompt[c0:c0 + chunk]
                toks = torch.zeros((1, chunk), dtype=torch.long)
                toks[0, :len(part)] = part     # pad tail: causally masked
                logits, self._pcache = self._run(
                    self.prefill_step,
                    {"tokens": toks.to(self.device), "pos0": c0},
                    self._pcache)
                steps += 1
            last = logits[0, (plen - 1) % chunk]
            row = self._row(self._pcache, 0)
        else:
            cache = self._cache(1, self.max_seq)
            for pos in range(plen):
                _, cache, lg = self._run(
                    self._loop_step,
                    {"tokens": prompt[None, pos:pos + 1].to(self.device),
                     "pos": pos}, cache)
                steps += 1
            last = lg[0]
            row = self._row(cache, 0)
        if self._owns(st.slot):
            self.kv.write_range(req.rid, 0, row, plen)
        return int(torch.argmax(last)), steps, last

    # ------------------------------------------------------------------ #
    def run(self, requests: list[Request], max_iters: int = 100_000,
            ) -> EngineReport:
        for req in requests:
            if req.prompt is None:
                raise ValueError(f"{req.rid}: engine requests need tokens")
            if req.total_positions > self.max_seq:
                raise ValueError(f"{req.rid}: prompt+max_new "
                                 f"{req.total_positions} > max_seq "
                                 f"{self.max_seq}")
            self.sched.submit(req)

        finished, it, pf_chunks, dsteps, checks = [], 0, 0, 0, 0
        prefill_s = decode_s = 0.0
        first_logits = {}
        while self.sched.has_work:
            if it >= max_iters:
                raise RuntimeError(f"engine exceeded {max_iters} iterations")
            admitted = self.sched.admit(now=it)
            for st in admitted:
                watch = Stopwatch()
                first, steps, first_logits[st.req.rid] = self._prefill(st)
                self._seat(st)
                prefill_s += watch.seconds
                pf_chunks += steps
                st.generated.append(first)
                st.first_token_time = it
            if not self.sched.active:
                if len(self.sched.queue):
                    head = self.sched.queue.peek()
                    raise RuntimeError(
                        f"request {head.rid!r} can never be admitted "
                        f"(needs {self.kv.blocks_for(head.total_positions)} "
                        f"blocks of {self.kv.allocator.num_blocks})")
                break
            checks += self._retire(it, finished, first_logits)
            if not self.sched.active:
                it += 1
                continue

            watch = Stopwatch()
            toks = torch.zeros((self.slots, 1), dtype=torch.long)
            pos = torch.zeros((self.slots,), dtype=torch.long)
            for slot, st in self.sched.active.items():
                toks[slot, 0] = st.generated[-1]
                pos[slot] = st.pos - 1           # feed token at its position
            mine = slice(self.lo, self.lo + self.local)
            nxt, self.working = self._run(
                self.step, {"tokens": toks[mine].to(self.device),
                            "pos": pos[mine].to(self.device)}, self.working)
            if not self.replicated:
                nxt = self.hosts.all_gather(nxt)
            nxt = nxt.tolist()
            dsteps += 1
            for slot, st in list(self.sched.active.items()):
                if self._owns(slot):
                    self.kv.write_range(
                        st.req.rid, st.pos - 1,
                        self._row(self.working, slot - self.lo), 1)
                st.generated.append(nxt[slot])
            decode_s += watch.seconds
            it += 1
            checks += self._retire(it, finished, first_logits)
        self.kv.check()
        return EngineReport(requests=finished, iterations=it,
                            prefill_chunks=pf_chunks, decode_steps=dsteps,
                            checks=checks, prefill_ms=prefill_s * 1e3,
                            decode_ms=decode_s * 1e3)

    def _assert_ranks_agree(self, st: RequestState) -> None:
        """Every rank of the group generated the same tokens."""
        if not self.pctx.manual:
            return
        mine = torch.tensor(st.generated, dtype=torch.long, device=self.device)
        every = [torch.empty_like(mine) for _ in range(self.pctx.world)]
        dist.all_gather(every, mine, group=self.pctx.group)
        for rank, theirs in enumerate(every):
            if not torch.equal(theirs, mine):
                raise AssertionError(
                    f"{st.req.rid}: rank {self.pctx.rank} generated "
                    f"{mine.tolist()}, rank {rank} {theirs.tolist()}")

    def _retire(self, it: int, finished: list, first_logits: dict) -> int:
        checks = 0
        for slot in sorted(self.sched.active):
            st = self.sched.active[slot]
            if not st.done:
                continue
            if self.check:
                # every position actually fed is pooled bit-identically
                covered = st.req.prompt_len + len(st.generated) - 1
                if self._owns(slot):
                    self.kv.assert_matches(
                        st.req.rid, self._row(self.working, slot - self.lo),
                        min(covered, self.max_seq))
                self.kv.check()
                self._assert_ranks_agree(st)
                checks += 1
            self.sched.finish(slot, now=it)
            finished.append({
                "rid": st.req.rid, "slot": slot,
                "prompt_len": st.req.prompt_len,
                "tokens": list(st.generated),
                "first_logits": first_logits.pop(st.req.rid),
                "admit_iter": int(st.admit_time),
                "first_token_iter": int(st.first_token_time),
                "finish_iter": it,
            })
        return checks
