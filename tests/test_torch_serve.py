"""The port's serving engine, paged KV cache and scheduler.

The engine is held against a greedy loop over the JAX package's
``Model.decode_step`` (``pctx=None``) on the same weights, token for token,
for qwen2-1.5b (paged K/V, batched prefill) and rwkv6-7b (unpaged recurrent
state, per-token prompt seating), both reduced.
It is not held against the JAX ``ServingEngine``, which cannot be built on
the installed jax (ROADMAP.md, Queue 3).  Everything runs on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.batching import Request, Scheduler
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.kvcache import BlockAllocator, PagedKVCache

ARCH = ARCHS["qwen2-1.5b"].reduced()
RWKV = ARCHS["rwkv6-7b"].reduced()
PROMPT_LEN, GEN, BATCH = 6, 5, 3
MAX_SEQ = PROMPT_LEN + GEN + 1      # engine feeds one token past the prompt


def _reference(name: str):
    """JAX params, prompts, and the greedy tokens [B, GEN+1] of a one-batch
    per-token loop over the reference's decode_step."""
    cfg = ARCHS[name].reduced()
    jm = jget_model(JARCHS[name].reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(7).integers(
        3, cfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
    cache = jm.init_cache(BATCH, MAX_SEQ)
    for pos in range(PROMPT_LEN):
        logits, cache = jm.decode_step(
            jp, {"tokens": jnp.asarray(prompts[:, pos:pos + 1]),
                 "pos": jnp.asarray(pos, jnp.int32)}, cache)
    nxt = jnp.argmax(logits[:, -1], axis=-1)
    out = [np.asarray(nxt)]
    for i in range(GEN):
        logits, cache = jm.decode_step(
            jp, {"tokens": nxt[:, None],
                 "pos": jnp.asarray(PROMPT_LEN + i, jnp.int32)}, cache)
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        out.append(np.asarray(nxt))
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return params, prompts, np.stack(out, axis=1)


@pytest.fixture(scope="module")
def reference():
    return _reference("qwen2-1.5b")


def _requests(prompts):
    return [Request(rid=f"r{i}", prompt_len=PROMPT_LEN, max_new=GEN + 1,
                    prompt=tuple(int(t) for t in prompts[i]))
            for i in range(BATCH)]


def _engine(params, cfg=ARCH, **kw):
    kw = {"slots": 2, "max_seq": MAX_SEQ, "block_size": 4,
          "prefill_chunk": 4, "check": True, **kw}
    return ServingEngine(cfg, params=params, device="cpu", **kw)


@pytest.fixture(scope="module")
def engine_report(reference):
    params, prompts, _ = reference
    return _engine(params).run(_requests(prompts))


# --------------------------------------------------------------------------- #
# Engine == reference greedy loop
# --------------------------------------------------------------------------- #
def test_engine_matches_reference_loop(reference, engine_report):
    """Continuous batching on 2 slots (< 3 requests) reproduces the JAX
    one-batch loop token for token."""
    _, _, ref = reference
    tokens = engine_report.tokens()
    assert set(tokens) == {f"r{i}" for i in range(BATCH)}
    for i in range(BATCH):
        assert tokens[f"r{i}"] == ref[i].tolist(), f"r{i} diverged"


def test_engine_report_shape(engine_report):
    rep = engine_report
    assert rep.checks == BATCH               # every retire verified paged KV
    assert rep.decode_steps >= GEN           # slots < requests => extra iters
    assert rep.prefill_chunks == BATCH * 2   # 6-token prompts, 4-token chunks
    assert {r["slot"] for r in rep.requests} <= {0, 1}
    admits = sorted(r["admit_iter"] for r in rep.requests)
    assert admits[0] == admits[1] == 0 and admits[2] > 0
    for r in rep.requests:
        assert r["first_logits"].shape == (ARCH.vocab,)
        assert int(torch.argmax(r["first_logits"])) == r["tokens"][0]


@pytest.mark.parametrize("slots", [1, 3])
def test_loop_prefill_matches_batched(reference, slots):
    """batched_prefill=False (per-token decode loop) produces the same
    tokens as the chunked batched prefill path."""
    params, prompts, ref = reference
    rep = _engine(params, slots=slots, batched_prefill=False).run(
        _requests(prompts))
    for i in range(BATCH):
        assert rep.tokens()[f"r{i}"] == ref[i].tolist()


def test_engine_rejects_promptless_and_oversized(reference):
    eng = _engine(reference[0], slots=1)
    with pytest.raises(ValueError, match="need tokens"):
        eng.run([Request(rid="x", prompt_len=4, max_new=2)])
    with pytest.raises(ValueError, match="max_seq"):
        eng.run([Request(rid="y", prompt_len=MAX_SEQ, max_new=2,
                         prompt=tuple(range(3, 3 + MAX_SEQ)))])


def test_launcher_engine_matches_legacy_loop():
    """launch/serve.py: the engine path and --legacy-loop serve the same
    tokens from the same seeded weights and prompts."""
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
            "--batch", "3", "--slots", "2", "--prompt-len", "6", "--gen", "4",
            "--prefill-chunk", "4", "--block-size", "4", "--check"]
    args = launch_serve.build_parser().parse_args(argv)
    params = launch_serve._params(args, ARCH, None)
    report = launch_serve.run_engine(args, ARCH, params)
    legacy = launch_serve.run_legacy(args, ARCH, params)
    for r in report.requests:
        i = int(r["rid"][3:])
        assert r["tokens"] == legacy["tokens"][i].tolist()
        torch.testing.assert_close(r["first_logits"],
                                   legacy["first_logits"][i],
                                   rtol=1e-4, atol=1e-4)
    assert legacy["margins"].shape == (3, 5)
    assert bool((legacy["margins"] >= 0).all())


def test_rwkv_engine_matches_reference_loop():
    """rwkv6-7b reduced: 3 requests on 2 slots, prompts seated token by
    token (no batched prefill), the recurrent state stored whole per
    request and checked bitwise on every retire; tokens equal the JAX
    loop's and the port's legacy loop's."""
    cfg = RWKV
    params, prompts, ref = _reference("rwkv6-7b")
    rep = _engine(params, cfg).run(_requests(prompts))
    assert rep.checks == BATCH
    assert rep.prefill_chunks == BATCH * PROMPT_LEN      # per-token steps
    args = launch_serve.build_parser().parse_args(
        ["--arch", "rwkv6-7b", "--reduced", "--device", "cpu", "--batch",
         str(BATCH), "--prompt-len", str(PROMPT_LEN), "--gen", str(GEN)])
    legacy = launch_serve.run_legacy(args, cfg, params)
    for i in range(BATCH):
        assert rep.tokens()[f"r{i}"] == ref[i].tolist(), f"r{i} diverged"
    # the launcher's seeded prompts differ from the fixture's: hold the
    # legacy loop against the engine on its own prompts
    engine = launch_serve.run_engine(args, cfg, params)
    for r in engine.requests:
        assert r["tokens"] == legacy["tokens"][int(r["rid"][3:])].tolist()


@pytest.fixture
def plan_dirs(tmp_path, monkeypatch):
    """Plans and the sim store an ``auto`` launch persists go under
    ``tmp_path``, and the process's sim store is left as it was."""
    from repro_torch.core.noc.simcache import SIM_CACHE
    monkeypatch.setenv("REPRO_TORCH_PLAN_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("REPRO_TORCH_SIMCACHE_DIR", str(tmp_path / "sims"))
    monkeypatch.setattr(SIM_CACHE, "_persist_dir", None)
    return tmp_path


@pytest.mark.parametrize("mode",
                         ["xla_spmd", "ina_ring", "eject_inject", "auto"])
def test_multi_rank_psum_modes_raise(mode, plan_dirs):
    """Every psum mode parses in the launcher and, through a gloo group of
    one rank, serves the same tokens as 'ina'.  (Until the port had
    collectives, these modes raised; the name is kept.)  At one rank every
    collective returns its input, so the modes cannot differ."""
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
            "--batch", "2", "--slots", "2", "--prompt-len", "6", "--gen", "3",
            "--prefill-chunk", "4", "--block-size", "4", "--check"]
    parse = launch_serve.build_parser().parse_args
    args, ina = parse(argv + ["--psum-mode", mode]), parse(argv)
    assert args.psum_mode == mode and ina.psum_mode == "ina"
    params = launch_serve._params(args, ARCH, None)
    group, _ = mesh.init_group(1, 0, "cpu", str(plan_dirs / "store"))
    try:
        got = launch_serve.run_engine(args, ARCH, params, group=group)
        want = launch_serve.run_engine(ina, ARCH, params, group=group)
    finally:
        dist.destroy_process_group()
    assert got.tokens() == want.tokens()
    assert launch_serve.main(argv + ["--psum-mode", mode]) == \
        [want.tokens()[f"req{i}"] for i in range(2)]


# --------------------------------------------------------------------------- #
# BlockAllocator
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(6))
def test_allocator_never_aliases_or_leaks(seed):
    """Random alloc/extend/free interleavings: every block is free or
    owned by exactly one request, and free + live == total, always."""
    rng = np.random.default_rng(seed)
    alloc = BlockAllocator(12)
    owned: dict[int, int] = {}
    for _ in range(60):
        op = ["alloc", "extend", "free"][int(rng.integers(3))]
        rid, n = int(rng.integers(6)), int(rng.integers(5))
        try:
            if op == "alloc":
                assert len(alloc.alloc(rid, n)) == n
                owned[rid] = n
            elif op == "extend":
                alloc.extend(rid, n)
                owned[rid] += n
            else:
                assert alloc.free(rid) == owned.pop(rid)
        except (KeyError, MemoryError):
            pass                              # rejected ops must not mutate
        alloc.check()
        assert alloc.live_blocks == sum(owned.values())
        assert alloc.free_blocks == 12 - alloc.live_blocks
    for rid in list(owned):
        alloc.free(rid)
    assert alloc.free_blocks == 12


def test_allocator_deterministic_order():
    a = BlockAllocator(6)
    assert a.alloc("a", 2) == [0, 1]
    assert a.alloc("b", 2) == [2, 3]
    a.free("a")
    assert a.alloc("c", 3) == [0, 1, 4]       # reuses lowest ids first


def test_allocator_check_finds_corruption():
    a = BlockAllocator(4)
    a.alloc("a", 2)
    a.tables["b"] = [1]                       # aliased block
    with pytest.raises(AssertionError, match="aliased"):
        a.check()
    a.tables.pop("b")
    a._free.append(0)                         # both free and mapped
    with pytest.raises(AssertionError, match="both free and mapped"):
        a.check()


# --------------------------------------------------------------------------- #
# PagedKVCache round-trips
# --------------------------------------------------------------------------- #
def _kv(cfg=ARCH, **kw):
    kw = {"max_seq": 16, "block_size": 4, "num_blocks": 12, **kw}
    return PagedKVCache(cfg, device="cpu", **kw)


def _random_row(kv, rng):
    return {m.name: torch.from_numpy(
        rng.standard_normal(m.row_shape).astype(np.float32)).to(m.dtype)
        for m in kv.leaves}


@pytest.mark.parametrize("seed", range(6))
def test_paged_roundtrip_bit_identical(seed):
    """Two requests' rows written interleaved, chunk by chunk: each
    gathers back bit-identical to its source, zeros past its length,
    and releasing one leaves the other untouched."""
    _roundtrip(_kv(), seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_unpaged_roundtrip_bit_identical(seed, dtype):
    """rwkv6-7b: no leaf is paged; each request's whole state, tprev and
    cprev round-trip bit-identically, in f32 and in bf16 configs."""
    cfg = dataclasses.replace(RWKV, dtype=dtype)
    kv = _kv(cfg)
    assert not any(m.paged for m in kv.leaves) and not kv._pools
    _roundtrip(kv, seed)


def _roundtrip(kv, seed):
    kv.check()
    rng = np.random.default_rng(seed)
    len_a, len_b = (int(x) for x in rng.integers(1, kv.max_seq + 1, 2))
    kv.admit("a", len_a)
    kv.admit("b", len_b)
    row_a, row_b = _random_row(kv, rng), _random_row(kv, rng)
    pos_a = pos_b = 0
    while pos_a < len_a or pos_b < len_b:
        if pos_a < len_a:
            n = min(int(rng.integers(1, 5)), len_a - pos_a)
            kv.write_range("a", pos_a, row_a, n)
            pos_a += n
        if pos_b < len_b:
            n = min(int(rng.integers(1, 5)), len_b - pos_b)
            kv.write_range("b", pos_b, row_b, n)
            pos_b += n
    kv.assert_matches("a", row_a, len_a)
    kv.assert_matches("b", row_b, len_b)
    kv.check()
    got = kv.gather_row("a", len_a)
    for meta in kv.leaves:
        if meta.paged:
            tail = got[meta.name].movedim(meta.batch_axis, 0)[len_a:]
            assert not bool(tail.any())
        else:
            assert torch.equal(got[meta.name], row_a[meta.name])
    kv.release("b")
    kv.check()
    kv.assert_matches("a", row_a, len_a)
    kv.release("a")
    assert kv.allocator.free_blocks == kv.allocator.num_blocks


def test_unpaged_leaves_keep_their_dtype():
    """In a bf16 config the f32 recurrent state is stored and gathered in
    f32 (not rounded to the compute dtype); the token-shift rows in bf16."""
    cfg = dataclasses.replace(RWKV, dtype="bfloat16")
    kv = _kv(cfg)
    dtypes = {m.name: m.dtype for m in kv.leaves}
    assert dtypes == {"state": torch.float32, "tprev": torch.bfloat16,
                      "cprev": torch.bfloat16}
    kv.admit("a", 5)
    row = _random_row(kv, np.random.default_rng(1))
    row["state"] = row["state"] + 1e-6 * torch.arange(row["state"].numel()
                                                      ).reshape(row["state"].shape)
    kv.write_range("a", 0, row, 5)
    back = kv.gather_row("a")
    assert back["state"].dtype == torch.float32
    assert torch.equal(back["state"], row["state"])
    kv.assert_matches("a", row, 5)
    newer = {k: v.clone() for k, v in row.items()}
    newer["state"][0, 0, 0, 0] += 1e-7 * (1 + abs(float(row["state"][0, 0, 0, 0])))
    with pytest.raises(AssertionError, match="mismatch on leaf state"):
        kv.assert_matches("a", newer, 5)
    kv.write_range("a", 5, newer, 0)          # the latest write wins
    kv.assert_matches("a", newer, 5)


@pytest.mark.parametrize("max_seq", [4, 16])
def test_state_never_paged_when_max_seq_equals_heads(max_seq):
    """The state row is [L, H, hd, hd]: with max_seq == H (4 reduced) an
    extent test would take H for a sequence axis and page it.  The leaves
    come from the model API, so nothing is paged either way; a dense
    cache's K/V are paged whatever max_seq is."""
    assert RWKV.d_model // RWKV.ssm.head_dim == 4
    kv = _kv(RWKV, max_seq=max_seq, num_blocks=8)
    assert [(m.name, m.paged) for m in kv.leaves] == [
        ("state", False), ("tprev", False), ("cprev", False)]
    dense = _kv(ARCH, max_seq=max_seq, num_blocks=8)
    assert [(m.name, m.paged) for m in dense.leaves] == [("k", True),
                                                         ("v", True)]
    _roundtrip(kv, 4)


def test_paged_mismatch_is_caught():
    kv = _kv()
    rng = np.random.default_rng(0)
    kv.admit("a", 8)
    row = _random_row(kv, rng)
    kv.write_range("a", 0, row, 8)
    row["k"][0, 3, 0, 0] += 1.0
    with pytest.raises(AssertionError, match="mismatch on leaf k"):
        kv.assert_matches("a", row, 8)


def test_kvcache_block_size_must_divide():
    with pytest.raises(ValueError, match="divide"):
        _kv(max_seq=10, block_size=4, num_blocks=4)


def test_kvcache_pool_layout():
    kv = _kv()
    hd = ARCH.resolved_head_dim
    assert [(m.name, m.batch_axis) for m in kv.leaves] == [("k", 1), ("v", 1)]
    assert kv.leaves[0].row_shape == (ARCH.n_layers, 16, ARCH.n_kv_heads, hd)
    assert tuple(kv._pools["k"].shape) == (12, 4, ARCH.n_layers,
                                           ARCH.n_kv_heads, hd)


def test_kvcache_admission_accounting():
    kv = _kv()
    assert kv.blocks_for(1) == 1 and kv.blocks_for(5) == 2
    kv.admit("x", 16)                         # 4 blocks
    kv.admit("y", 16)
    kv.admit("z", 16)
    assert not kv.can_admit(1)                # 12 blocks all reserved
    assert kv.release("y") == 4
    assert kv.can_admit(16)
    kv.release("x")
    kv.release("z")
    kv.check()


# --------------------------------------------------------------------------- #
# Scheduler admission
# --------------------------------------------------------------------------- #
def test_scheduler_head_of_line_blocking():
    """A too-big head request must not be overtaken by smaller ones."""
    sched = Scheduler(4, _kv(num_blocks=4))
    sched.submit(Request(rid="big", prompt_len=12, max_new=4, arrival=0.0))
    sched.submit(Request(rid="small", prompt_len=2, max_new=2, arrival=1.0))
    assert [st.req.rid for st in sched.admit(now=2.0)] == ["big"]
    assert sched.admit(now=2.0) == []         # small waits for blocks
    sched.finish(0, now=3.0)
    assert [st.req.rid for st in sched.admit(now=3.0)] == ["small"]


def test_scheduler_priority_policy():
    sched = Scheduler(1, _kv(num_blocks=64), policy="priority")
    sched.submit(Request(rid="late-hi", prompt_len=2, max_new=1,
                         arrival=0.0, priority=0))
    sched.submit(Request(rid="early-lo", prompt_len=2, max_new=1,
                         arrival=0.0, priority=5))
    assert sched.admit(now=0.0)[0].req.rid == "late-hi"


def test_scheduler_releases_slot_and_blocks():
    kv = _kv(num_blocks=8)
    sched = Scheduler(2, kv)
    sched.submit(Request(rid="a", prompt_len=8, max_new=8))   # 4 blocks
    sched.submit(Request(rid="b", prompt_len=8, max_new=8))
    assert len(sched.admit()) == 2 and kv.allocator.free_blocks == 0
    st = sched.finish(0, now=1.0)
    assert st.req.rid == "a" and st.finish_time == 1.0
    assert kv.allocator.free_blocks == 4
    assert sched.n_active == 1 and sched.has_work


def test_request_validation():
    with pytest.raises(ValueError, match="positive"):
        Request(rid="r", prompt_len=0, max_new=1)
    with pytest.raises(ValueError, match="mismatch"):
        Request(rid="r", prompt_len=3, max_new=1, prompt=(1, 2))
    assert Request(rid="r", prompt_len=3, max_new=2).total_positions == 5
