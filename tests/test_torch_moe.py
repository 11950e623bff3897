"""The port's moe (llama4-scout) and mla_moe (deepseek-v2-lite) families
against the JAX package's, on reduced configs.

Weights come from the reference (``Model.init(jax.random.PRNGKey(s))``) and
reach the port through ``params_from_jax``; token and activation inputs
come from numpy.  Both run in float32 on the CPU (the port's plain kernel
versions), held to rtol/atol 1e-4.

Capacity is the subtle part: a forward pools its B x S tokens into one
routing group, so assignments past an expert's capacity drop; the paged
serve step routes each slot alone, as the reference's ``vmap`` of a B=1
``decode_step`` over the slots does.  The tests below hold both.  The
``gpu`` tests run the same float32 checks on the card and skip elsewhere.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.api import cache_specs as jcache_specs
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ina_matmul as im
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.kernel_times import moe_projections
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.models.api import (cache_batch_axes, cache_leaves,
                                    get_model, paged_cache_leaves)
from repro_torch.models.transformer import layer
from repro_torch.parallel.sharding import shard_params
from repro_torch.parallel.steps import build_paged_serve_step, build_train_step
from repro_torch.serve.batching import Request
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.kvcache import PagedKVCache

ARCH_NAMES = ["llama4-scout-17b-16e", "deepseek-v2-lite-16b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 40
ROOT = Path(__file__).resolve().parents[1]


@functools.cache
def _make_pair(name: str):
    jm = jget_model(JARCHS[name].reduced())
    jp = jm.init(jax.random.PRNGKey(3))
    cfg = ARCHS[name].reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JARCHS[name].reduced())
    tp = params_from_jax(_numpy_tree(jp), cfg, device="cpu")
    return jm, jp, get_model(cfg), tp


def _numpy_tree(jp):
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module", params=ARCH_NAMES)
def pair(request):
    """(reference model, its params, port model, port params)."""
    return _make_pair(request.param)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL)


def _leaves(tree) -> dict:
    """A reference tree's leaves by path, in the port's naming."""
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _close_caches(tc, jc):
    want = _leaves(jc)
    got = cache_leaves(tc)
    assert set(got) == set(want)
    for path, leaf in got.items():
        _close(leaf, want[path])


def _jpos(pos):
    return jnp.asarray(pos, jnp.int32)


# --------------------------------------------------------------------------- #
# routing and attention
# --------------------------------------------------------------------------- #
def _moe_layer(pair):
    """The first MoE layer's FFN weights in both packages."""
    jm, jp, m, tp = pair
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    return jl, layer(tp["layers"], 0)["mlp"]


def test_moe_mlp_matches_where_capacity_drops(pair):
    """Output and aux loss of one MoE FFN over 64 pooled tokens whose
    inputs lean toward expert 0 (+3 along its router column), so that
    expert overflows its capacity and assignments drop in both packages."""
    jm, jp, m, tp = pair
    jl, tl = _moe_layer(pair)
    cfg = m.cfg
    rng = np.random.default_rng(11)
    col = np.asarray(jl["router"])[:, 0]
    x = (rng.standard_normal((4, 16, cfg.d_model))
         + 3.0 * col / np.linalg.norm(col)).astype(np.float32)
    want, want_aux = jmoe.moe_mlp(jl, jnp.asarray(x), JARCHS[cfg.name].reduced())
    with moe.record_routing() as calls:
        got, aux = moe.moe_mlp(tl, torch.from_numpy(x), cfg)
    assert moe.capacity(64, cfg.moe) < 64
    assert int(calls[0].dropped) > 0, "no assignment dropped: the case is vacuous"
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_top_k_order_breaks_ties_to_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.1]])
    vals, idx = moe.top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 3]]
    _close(vals, jv)


@pytest.mark.parametrize("sk,kvh,causal", [(64, 4, True), (64, 2, True),
                                           (64, 4, False), (40, 4, True)],
                         ids=["chunked", "chunked-gqa", "non-causal",
                              "ragged-falls-back"])
def test_attention_by_chunk_matches_with_dv_unlike_d(sk, kvh, causal):
    """MLA's head dims (q/k 24, v 16 reduced) through the reference's
    ``attention`` rule at chunk 16: ``attn_chunked`` where 16 divides the
    KV length, ``attn_full`` where it does not."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, sk, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, sk, kvh, 24)).astype(np.float32)
    v = rng.standard_normal((2, sk, kvh, 16)).astype(np.float32)
    want = jlayers.attention(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal, chunk=16)
    got = layers.attention_by_chunk(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal, chunk=16)
    assert got.shape == (2, sk, 4, 16)
    _close(got, want)
    if sk % 16 == 0:
        _close(layers.attn_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                                   chunk=16, causal=causal),
               jlayers.attn_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                    chunk=16, causal=causal))


@pytest.mark.parametrize("dq,dv", [(24, 16), (192, 192)],
                         ids=["dv-unlike-d", "d-over-128"])
def test_flash_front_rejects_shapes_it_cannot_take(dq, dv):
    q = torch.zeros(1, 4, 2, dq)
    k = torch.zeros(1, 4, 2, dq)
    v = torch.zeros(1, 4, 2, dv)
    with pytest.raises(ValueError, match="one head dim"):
        ops.attention_heads(q, k, v, causal=True)


# --------------------------------------------------------------------------- #
# whole models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seq", [S, 64])
def test_forward_matches(pair, seq):
    """64 tokens take MLA's chunked attention (attn_chunk 32), 40 its full
    attention (32 does not divide 40); the moe family runs the flash
    kernel's plain version for both.  The B x S tokens pool into one
    routing group in both packages."""
    jm, jp, m, tp = pair
    toks = _tokens(1, B, seq, m.cfg.vocab)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with moe.record_routing() as calls:
        got = m.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, seq, m.cfg.vocab)
    assert len(calls) == m.cfg.n_layers - m.cfg.moe.first_dense_layers
    _close(got, want)


def test_loss_matches(pair):
    jm, jp, m, tp = pair
    toks = _tokens(2, B, S, m.cfg.vocab)
    labels = _tokens(3, B, S, m.cfg.vocab)
    want = jm.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    got = m.loss(tp, {"tokens": torch.from_numpy(toks).long(),
                      "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_decode_steps_match(pair):
    """Six decode steps of 2 rows at a shared scalar position from empty
    caches: logits and every cache leaf (nested for MLA) after each."""
    jm, jp, m, tp = pair
    toks = _tokens(4, B, 6, m.cfg.vocab)
    jc = jm.init_cache(B, 8)
    tc = m.init_cache(B, 8, device="cpu")
    for pos in range(6):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, pos:pos + 1]),
                                     "pos": _jpos(pos)}, jc)
        tl, tc = m.decode_step(tp, {"tokens": torch.from_numpy(
            toks[:, pos:pos + 1]).long(), "pos": pos}, tc)
        _close(tl, jl)
        _close_caches(tc, jc)


def test_forward_equals_decode_loop_where_nothing_drops(pair):
    """At T = 8 tokens a forward's capacity is T, so it drops nothing, and
    it equals the per-token decode loop at every position."""
    jm, jp, m, tp = pair
    toks = torch.from_numpy(_tokens(5, 1, 8, m.cfg.vocab)).long()
    assert moe.capacity(8, m.cfg.moe) == 8
    fwd = m.forward(tp, {"tokens": toks})
    tc = m.init_cache(1, 8, device="cpu")
    for pos in range(8):
        tl, tc = m.decode_step(tp, {"tokens": toks[:, pos:pos + 1], "pos": pos},
                               tc)
        torch.testing.assert_close(tl[:, 0], fwd[:, pos], **TOL)


SLOTS = 16


def _filled_cache(m, seed, max_seq, lens):
    """A port cache of ``len(lens)`` rows with row r's positions < lens[r]
    drawn from a seeded normal (a prefix its request wrote earlier), and
    the same rows as numpy, one B=1 reference cache a row."""
    rng = np.random.default_rng(seed)
    tc = m.init_cache(len(lens), max_seq, device="cpu")
    rows = [{} for _ in lens]
    for path, leaf in cache_leaves(tc).items():
        for r, n in enumerate(lens):
            leaf[:, r, :n] = torch.from_numpy(rng.standard_normal(
                tuple(leaf[:, r, :n].shape)).astype(np.float32))
            rows[r][path] = leaf[:, r:r + 1].numpy().copy()
    return tc, rows


def _as_reference_cache(jm, row):
    jc = jm.init_cache(1, 1)
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    leaves = [jnp.asarray(row["/".join(str(k.key) for k in path)])
              for path, _ in flat]
    return jax.tree_util.tree_unflatten(jax.tree.structure(jc), leaves)


def test_paged_step_routes_each_slot_alone(pair, monkeypatch):
    """The paged serve step on 16 slots at their own positions against a
    B=1 reference ``decode_step`` a slot (logits and cache rows).  Every
    slot feeds the same token, so the slots lean to the same experts: a
    capacity pooled over the 16 slots would drop assignments, and the
    step with pooled routing (patched in) differs from the reference."""
    jm, jp, m, tp = pair
    max_seq = 12
    lens = np.random.default_rng(6).integers(0, max_seq, SLOTS).tolist()
    filled, rows = _filled_cache(m, 7, max_seq, lens)
    feed = torch.full((SLOTS, 1), 5, dtype=torch.long)
    batch = {"tokens": feed, "pos": torch.tensor(lens)}
    logits, tc = m.decode_step(tp, batch, _clone(filled))
    for r, n in enumerate(lens):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(feed[r:r + 1].numpy()),
                                     "pos": _jpos(n)},
                                _as_reference_cache(jm, rows[r]))
        _close(logits[r:r + 1], jl)
        want = _leaves(jc)
        for path, leaf in cache_leaves(tc).items():
            _close(leaf[:, r:r + 1], want[path])
    nxt, _ = build_paged_serve_step(m).fn(tp, batch, _clone(filled))
    assert torch.equal(nxt, torch.argmax(logits[:, -1], dim=-1))

    monkeypatch.setattr(moe, "decode_groups", lambda tokens, pos: 1)
    with moe.record_routing() as calls:
        pooled, _ = m.decode_step(tp, batch, _clone(filled))
    assert moe.capacity(SLOTS, m.cfg.moe) < SLOTS
    assert sum(int(c.dropped) for c in calls) > 0, "pooling drops nothing here"
    assert not torch.allclose(pooled, logits, **TOL)


def _clone(tree: dict) -> dict:
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def test_cache_layout(pair):
    """Leaves, shapes and dtypes as the reference's ``init_cache``, nested
    for MLA; batch axes where the reference's ``cache_specs`` puts the
    batch, in the same tree; every leaf paged by position."""
    jm, jp, m, tp = pair
    jc = _leaves(jm.init_cache(3, 8))
    tc = cache_leaves(m.init_cache(3, 8, device="cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tc.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    specs = jcache_specs(JARCHS[m.cfg.name].reduced(), batch_axes="__batch__")
    want = jax.tree.map(lambda spec: list(spec).index("__batch__"), specs,
                        is_leaf=lambda x: not isinstance(x, dict))
    assert cache_batch_axes(m.cfg) == _leaves(want)
    assert set(paged_cache_leaves(m.cfg)) == set(jc)


def test_no_projection_takes_the_generic_path(pair, monkeypatch):
    """bf16: every INA matmul of a forward and of a paged decode step gets
    operands TMA can describe (no ``generic`` plan), and a decode step makes
    as many as chip_smoke.py derives from the code."""
    jm, jp, m, _ = pair
    cfg = dataclasses.replace(m.cfg, dtype="bfloat16")
    model = get_model(cfg)
    tp = params_from_jax(_numpy_tree(jp), cfg, device="cpu")
    regimes = []
    real = ops.ina_matmul

    def spy(x, w):
        regimes.append(im.plan_for(x, w).regime)
        return real(x, w)
    monkeypatch.setattr(ops, "ina_matmul", spy)
    model.forward(tp, {"tokens": torch.from_numpy(_tokens(8, 1, 40, cfg.vocab)).long()})
    cache = model.init_cache(3, 10, device="cpu")
    regimes.clear()
    model.decode_step(tp, {"tokens": torch.full((3, 1), 4),
                           "pos": torch.tensor([0, 4, 9])}, cache)
    assert len(regimes) == _chip_smoke().matmuls_per_pass(cfg)
    assert "generic" not in regimes


# (regime, tile_m, tile_n, cluster) of each MoE-family product at M = 2
# (decode, 2 slots) and 2048 (the B 1 x S 2048 forward), and w_uk/w_uv at
# the decode's M = slots x cache length (2 x 81, and 1 x 81 seating a
# prompt), worked out by hand from plan_matmul's rule: c doubles from 1
# while c < 8, tiles x 2c <= 132 SMs and K holds >= 4c tiles of 64; tiles
# of 128 x 256 at M > 64 where they still give every SM one.
_MOE_PLANS = {
    ("deepseek-v2-lite-16b", "wq"): {2: ("narrow", 8, 64, 2),
                                     2048: ("wide", 128, 256, 1)},
    ("deepseek-v2-lite-16b", "w_dkv"): {2: ("narrow", 8, 64, 8),
                                        2048: ("wide", 128, 128, 1)},
    ("deepseek-v2-lite-16b", "w_uk/w_uv"): {81: ("wide", 128, 128, 4),
                                            162: ("wide", 128, 128, 4),
                                            2048: ("wide", 128, 128, 1)},
    ("deepseek-v2-lite-16b", "wo"): {2: ("narrow", 8, 64, 4),
                                     2048: ("wide", 128, 128, 1)},
    ("deepseek-v2-lite-16b", "shared w_up/w_gate"): {
        2: ("narrow", 8, 64, 2), 2048: ("wide", 128, 256, 1)},
    ("deepseek-v2-lite-16b", "shared w_down"): {2: ("narrow", 8, 64, 4),
                                                2048: ("wide", 128, 128, 1)},
    ("deepseek-v2-lite-16b", "dense w_up/w_gate"): {
        2: ("narrow", 8, 64, 1), 2048: ("wide", 128, 256, 1)},
    ("deepseek-v2-lite-16b", "dense w_down"): {2: ("narrow", 8, 64, 4),
                                               2048: ("wide", 128, 128, 1)},
    ("deepseek-v2-lite-16b", "head"): {2: ("narrow", 8, 64, 1),
                                       2048: ("wide", 128, 256, 1)},
    ("llama4-scout-17b-16e", "wq/wo"): {2: ("narrow", 8, 64, 1),
                                        2048: ("wide", 128, 256, 1)},
    ("llama4-scout-17b-16e", "wk/wv"): {2: ("narrow", 8, 64, 8),
                                        2048: ("wide", 128, 128, 1)},
    ("llama4-scout-17b-16e", "shared w_up/w_gate"): {
        2: ("narrow", 8, 64, 1), 2048: ("wide", 128, 256, 1)},
    ("llama4-scout-17b-16e", "shared w_down"): {2: ("narrow", 8, 64, 1),
                                                2048: ("wide", 128, 256, 1)},
    ("llama4-scout-17b-16e", "head"): {2: ("narrow", 8, 64, 1),
                                       2048: ("wide", 128, 256, 1)},
}


@pytest.mark.parametrize("model,name,k,n,m", [
    (model, name, k, n, m) for model, name, k, n, _ in moe_projections()
    for m in _MOE_PLANS[model, name]])
def test_plan_matmul_moe_shapes(model, name, k, n, m):
    """Every MoE-family product plans a TMA regime (never generic) with the
    tiles and cluster worked out by hand, each K slice whole 64-deep
    tiles."""
    plan = im.plan_matmul(m, n, k, aligned=True)
    assert (plan.regime, plan.tile_m, plan.tile_n, plan.cluster) == \
        _MOE_PLANS[model, name][m]
    assert len(im.k_slices(plan, k)) == plan.cluster


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_params_keep_names_shapes_and_storage(pair):
    """The converter keeps every leaf's name and shape (``dense_layers``,
    ``layers``, the router among them).  Serving storage: a leaf is in the
    compute dtype exactly where its per-layer rank is >= 2 (the matrices
    the reference casts at each call), else float32; the port's own init
    gives the same tree.  Masters follow the reference's ``Model.init``
    cast, leaf for leaf, at param_dtype bfloat16."""
    jm, jp, m, tp = pair
    want = _leaves(jp)
    got = cache_leaves(tp)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert "layers/mlp/router" in got
    assert ("dense_layers/mlp/w_up" in got) == bool(m.cfg.moe.first_dense_layers)
    cfg = dataclasses.replace(m.cfg, dtype="bfloat16")
    stored = cache_leaves(params_from_jax(_numpy_tree(jp), cfg, device="cpu"))
    own = cache_leaves(get_model(cfg).init(device="cpu"))
    for path, leaf in stored.items():
        rank = leaf.dim() - layers.STACK_AXES.get(path.split("/")[0], 0)
        assert leaf.dtype == (torch.bfloat16 if rank >= 2 else torch.float32), path
        assert (own[path].dtype, own[path].shape) == (leaf.dtype, leaf.shape)
    jcfg = dataclasses.replace(JARCHS[m.cfg.name].reduced(), param_dtype="bfloat16")
    jmasters = _leaves(jget_model(jcfg).init(jax.random.PRNGKey(3)))
    masters = cache_leaves(params_from_jax(
        _numpy_tree(jp), dataclasses.replace(m.cfg, param_dtype="bfloat16"),
        device="cpu", masters=True))
    assert {k: str(v.dtype).removeprefix("torch.") for k, v in masters.items()} \
        == {k: str(v.dtype) for k, v in jmasters.items()}


def test_world_above_one_raises(pair):
    """The families are tensor-parallel (``tests/test_torch_tp_families.py``
    holds them against the reference): at world 2 a rank's cache holds its
    KV heads (llama4) or the whole latent (MLA) and its shard half the
    routed experts.  At world 8, which does not divide the 4 heads, the
    moe family takes the uneven head cut (rank 0's cache one KV head, rank
    4's none) and its shard raises on the 4 experts; MLA raises on the
    heads."""
    jm, jp, m, tp = pair
    cache = m.init_cache(2, 8, device="cpu", world=2)
    if m.cfg.family == "moe":
        assert cache["k"].shape[3] == m.cfg.n_kv_heads // 2
    else:
        assert cache["moe"]["latent"].shape[-1] == m.cfg.mla.kv_lora_rank
    shard = shard_params(tp, m.cfg, 0, 2)
    assert shard["layers"]["mlp"]["w_gate"].shape[1] == \
        m.cfg.moe.num_experts // 2
    assert torch.equal(shard["layers"]["mlp"]["router"],
                       tp["layers"]["mlp"]["router"])
    if m.cfg.family == "moe":
        for rank, kvh in ((0, 1), (4, 0)):
            cache = m.init_cache(2, 8, device="cpu", world=8, rank=rank)
            assert cache["k"].shape[3] == kvh
        with pytest.raises(ValueError, match="do not divide layers/mlp/w_"):
            shard_params(tp, m.cfg, 0, 8)
        return
    with pytest.raises(ValueError, match="do not divide"):
        m.init_cache(2, 8, device="cpu", world=8)
    with pytest.raises(ValueError, match="do not divide"):
        shard_params(tp, m.cfg, 0, 8)



@pytest.mark.parametrize("name", ["zamba2-2.7b", "llama-3.2-vision-11b",
                                  "whisper-medium"])
def test_build_train_step_names_why_it_raises(name):
    """Every family trains now (item 5.7 is ported), the two MoE
    families among them (test_build_train_step_trains_the_moe_families):
    the hybrid, vlm and encdec families build a step for the shape asked,
    with one data host."""
    m = get_model(ARCHS[name].reduced())
    ts = build_train_step(m, ShapeConfig("t", 8, 1, "train"))
    assert (ts.shape.seq_len, ts.shape.global_batch) == (8, 1)
    assert (ts.host, ts.hosts) == (0, 1)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_build_train_step_trains_the_moe_families(name):
    """llama4-scout and deepseek-v2-lite train: one step of the reduced
    model (float32 masters) gives a finite loss, the aux loss in it, and
    moves the router and the routed experts (their gradients against
    jax.grad are tests/test_torch_train_families.py's)."""
    from repro_torch.optim.adamw import adamw_init
    m = get_model(ARCHS[name].reduced())
    params = m.init(device="cpu", masters=True)
    mlp = params["layers"]["mlp"]
    before = {k: mlp[k].clone() for k in ("router", "w_gate")}
    ts = build_train_step(m, ShapeConfig("t", 8, 2, "train"))
    tokens = torch.from_numpy(_tokens(4, 2, 9, m.cfg.vocab)).long()
    params, _, st = ts.fn(params, adamw_init(params),
                          {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    assert np.isfinite(float(st["loss"]))
    for k, w in before.items():
        assert not torch.equal(params["layers"]["mlp"][k], w), k


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
PROMPT_LEN, GEN, BATCH = 6, 5, 3
MAX_SEQ = PROMPT_LEN + GEN + 1


def _reference_tokens(jm, jp, prompts):
    """Greedy tokens [B, GEN+1] of a one-batch per-token loop over the
    reference's decode_step (B = 3 pools 3 tokens: capacity 3, no drop)."""
    cache = jm.init_cache(BATCH, MAX_SEQ)
    for pos in range(PROMPT_LEN):
        logits, cache = jm.decode_step(
            jp, {"tokens": jnp.asarray(prompts[:, pos:pos + 1]),
                 "pos": _jpos(pos)}, cache)
    nxt = jnp.argmax(logits[:, -1], axis=-1)
    out = [np.asarray(nxt)]
    for i in range(GEN):
        logits, cache = jm.decode_step(
            jp, {"tokens": nxt[:, None], "pos": _jpos(PROMPT_LEN + i)}, cache)
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        out.append(np.asarray(nxt))
    return np.stack(out, axis=1)


def test_engine_matches_reference_loop(pair):
    """3 requests on 2 slots, prompts seated token by token, paged decode
    with per-slot routing and a paged==monolithic check at every retire:
    greedy tokens equal the reference loop's."""
    jm, jp, m, tp = pair
    prompts = np.random.default_rng(7).integers(
        3, m.cfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
    engine = ServingEngine(m.cfg, params=tp, device="cpu", slots=2,
                           max_seq=MAX_SEQ, block_size=4, check=True)
    report = engine.run([Request(rid=f"r{i}", prompt_len=PROMPT_LEN,
                                 max_new=GEN + 1,
                                 prompt=tuple(int(t) for t in prompts[i]))
                         for i in range(BATCH)])
    assert report.checks == BATCH
    assert report.prefill_chunks == BATCH * PROMPT_LEN
    want = _reference_tokens(jm, jp, prompts)
    got = report.tokens()
    for i in range(BATCH):
        assert got[f"r{i}"] == want[i].tolist()


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_launcher_engine_matches_legacy_loop(name):
    """``launch/serve.py --reduced --device cpu --check``: the engine path
    and ``--legacy-loop`` serve the same tokens from the same seeded
    weights and prompts."""
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--batch", "3",
            "--slots", "2", "--prompt-len", "6", "--gen", "4",
            "--block-size", "4", "--check"]
    engine = launch_serve.main(argv)
    legacy = launch_serve.main(argv + ["--legacy-loop"])
    assert engine == legacy
    assert len(engine) == 3 and all(len(t) == 5 for t in engine)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_engine_equals_the_loop_run_alone(name):
    """Each request run alone through the legacy loop (``rows=[i]``) on a
    cache of the engine's length: the engine seats it through the same
    step, and each paged decode slot computes a B=1 decode, so the
    first-token logits agree to the bit and the tokens token for token."""
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--batch", "3",
            "--slots", "2", "--prompt-len", "6", "--gen", "4"]
    args = launch_serve.build_parser().parse_args(argv)
    cfg = ARCHS[name].reduced()
    params = get_model(cfg).init(device="cpu")
    report = launch_serve.run_engine(args, cfg, params)
    for r in report.requests:
        i = int(r["rid"].removeprefix("req"))
        one = launch_serve.run_legacy(args, cfg, params, rows=[i],
                                      max_seq=args.prompt_len + args.gen + 1)
        assert torch.equal(r["first_logits"], one["first_logits"][0])
        assert r["tokens"] == one["tokens"][0].tolist()


def test_paged_pool_roundtrips_the_nested_mla_cache():
    """The pool stores each nested leaf ("moe/latent", "dense/k_rope", ...)
    by position: a row written in two ranges gathers back bit for bit, zeros
    past its length."""
    cfg = ARCHS["deepseek-v2-lite-16b"].reduced()
    kv = PagedKVCache(cfg, max_seq=16, block_size=4, num_blocks=8, device="cpu")
    assert [meta.name for meta in kv.leaves] == list(
        cache_leaves(get_model(cfg).init_cache(1, 16, device="cpu")))
    gen = torch.Generator().manual_seed(0)
    row = {meta.name: torch.randn(meta.row_shape, generator=gen)
           for meta in kv.leaves}
    kv.admit("a", 11)
    kv.write_range("a", 0, row, 6)
    kv.write_range("a", 6, row, 4)
    kv.assert_matches("a", row, 10)
    back = kv.gather_row("a")
    for meta in kv.leaves:
        assert torch.equal(back[meta.name][:, :10], row[meta.name][:, :10])
        assert not back[meta.name][:, 10:].any()
    kv.check()


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on_host(fn, jp, *args):
    """The reference's ``fn(jp, *args)`` on JAX's CPU device: exact f32
    products, as the JAX package's tests run it, wherever JAX would put it
    (a JAX built for CUDA runs f32 dots through TF32 on the card)."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return fn(jax.device_put(jp, cpu), *args)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_on_card(cuda, name):
    """float32: the forward through the kernels (ina_matmul; flash for the
    moe family) against the reference's, within 1e-4."""
    jm, jp, m, _ = _make_pair(name)
    tp = params_from_jax(_numpy_tree(jp), m.cfg, device=cuda)
    toks = _tokens(1, B, 64, m.cfg.vocab)
    want = _on_host(jm.forward, jp, {"tokens": jnp.asarray(toks)})
    got = m.forward(tp, {"tokens": torch.from_numpy(toks).long().to(cuda)})
    _close(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_engine_on_card(cuda, name):
    """float32: the engine on the card serves the reference loop's tokens."""
    jm, jp, m, _ = _make_pair(name)
    tp = params_from_jax(_numpy_tree(jp), m.cfg, device=cuda)
    prompts = np.random.default_rng(7).integers(
        3, m.cfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
    engine = ServingEngine(m.cfg, params=tp, device=cuda, slots=2,
                           max_seq=MAX_SEQ, block_size=4, check=True)
    report = engine.run([Request(rid=f"r{i}", prompt_len=PROMPT_LEN,
                                 max_new=GEN + 1,
                                 prompt=tuple(int(t) for t in prompts[i]))
                         for i in range(BATCH)])
    want = _on_host(functools.partial(_reference_tokens, jm), jp, prompts)
    for i in range(BATCH):
        assert report.tokens()[f"r{i}"] == want[i].tolist()
