"""Tensor parallelism of the ssm, moe and mla_moe families in the port,
against the JAX package's unsharded models.

The reduced rwkv6-7b (4 heads of 16), llama4-scout-17b-16e (GQA 4:2, 4
experts top-1 and a shared one) and deepseek-v2-lite-16b (MLA, 4 heads, 4
experts top-2, a dense first layer), float32, with the reference's weights
(``Model.init(PRNGKey(3))`` through ``params_from_jax``), run on 1, 2 and 4
gloo ranks, one spawn a world with every family and mode inside it
(``tests/_torch_dist_workers.py``).  Their forward and decode logits must
match the reference's unsharded ``forward`` and ``decode_step`` within the
port's model tolerance (rtol = atol = 1e-4, ``tests/test_torch_models.py``)
under every mode of ``CLI_PSUM_MODES``, the engine's greedy tokens at
worlds 2 and 4 must equal world 1's, and the ``auto`` sites a sharded rank
records must be the ones the plan builder's trace records: two row psums a
RWKV6 layer (the output norm's all-reduce is none), the MoE combine and the
shared experts' psum apart.  The sequence-sharded stream (``rs_seq``) runs
at world 2 under every mode and with ``sp_entry``, and at world 4 under
``ina`` (:func:`rs_cases`): the same logits, those of a 6-token forward
too (which world 4 does not divide: every row site psums), the
forward's collective calls as the layers derive them, and a stream of
[B, S/P, D] between the layers.  The engine seats prompts token by token
and decodes one token a step, so it cuts no step and takes no
``rs_seq``.  The world-4 spawn also runs the moe family's uneven head cut
(``tests/_torch_uneven_cases.py``: 6 and 10 query heads, 2 KV heads),
forward, decode and gradient against the reference's.  In
this process: the shards concatenate back, each leaf's shard at the
published widths is the cut the sharding rules state, and the launcher
serves each family at two ranks with one rank's tokens.  The hybrid, vlm
and encdec families' tensor parallelism is
``tests/test_torch_tp_hybrid_media.py``'s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.collectives import CLI_PSUM_MODES, AxisSpan
from repro_torch.kernels import ina_matmul as im
from repro_torch.launch import mesh
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.kernel_times import TP_WORLDS, rank_projections
from repro_torch.models.api import get_model
from repro_torch.parallel import sharding
from repro_torch.parallel.steps import build_train_step
from repro_torch.parallel.tp import ParallelCtx
from repro_torch.plan.builder import collect_psum_sites

import _torch_dist_workers as W
import _torch_uneven_cases as U

RWKV, LLAMA4, DEEPSEEK = ("rwkv6-7b", "llama4-scout-17b-16e",
                          "deepseek-v2-lite-16b")
ARCH_NAMES = (RWKV, LLAMA4, DEEPSEEK)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, MAX_SEQ, DECODE = 2, 8, 16, 3
PROMPTS = ((5, 9, 11, 3, 7, 2), (8, 8, 1, 4, 6, 10), (12, 3, 3, 9, 1, 5))
GEN = 5
WORLDS = (1, 2, 4)
SHORT = 6       # a prompt length world 4 does not divide


def cases(world: int) -> dict:
    """Every CLI psum mode, and :func:`rs_cases`."""
    return {**{m: {"psum_mode": m} for m in CLI_PSUM_MODES},
            **rs_cases(world)}


def rs_cases(world: int) -> dict:
    """The sequence-sharded stream: at world 2 under every mode and with
    ``sp_entry``'s ring, at world 4 under ``ina``."""
    if world == 1:
        return {}
    out = {f"{m}+rs_seq": {"psum_mode": m, "rs_seq": True}
           for m in (CLI_PSUM_MODES if world == 2 else ("ina",))}
    if world == 2:
        out["ina+rs_seq+sp_entry"] = {"psum_mode": "ina", "rs_seq": True,
                                      "sp_entry": True}
    return out


RS_IDS = [(w, c, a) for w in (2, 4) for c in rs_cases(w) for a in ARCH_NAMES]
RS_NAMES = [f"w{w}-{c}-{a}" for w, c, a in RS_IDS]
@functools.cache
def reference(arch: str):
    """The reference's params (numpy), inputs and unsharded logits."""
    jm = jget_model(JARCHS[arch].reduced())
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    vocab = jm.cfg.vocab
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    dec = [rng.integers(0, vocab, (B,)).astype(np.int32)
           for _ in range(DECODE)]
    want = {"forward": np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)})),
            "forward_short": np.asarray(jm.forward(
                jp, {"tokens": jnp.asarray(toks[:, :SHORT])})),
            "decode": []}
    jc = jm.init_cache(B, MAX_SEQ)
    for pos, tok in enumerate(dec):
        logits, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tok[:, None]),
                                         "pos": jnp.asarray(pos, jnp.int32)},
                                    jc)
        want["decode"].append(np.asarray(logits))
    spec = {"params": jax.tree.map(np.asarray, jp), "tokens": toks,
            "decode_tokens": dec}
    return spec, want


@functools.cache
def port(world: int) -> list:
    spec = {"archs": {a: reference(a)[0] for a in ARCH_NAMES},
            "cases": cases(world), "engine": CLI_PSUM_MODES,
            "max_seq": MAX_SEQ, "prompts": PROMPTS, "gen": GEN,
            "short": SHORT}
    if world == U.WORLD:
        spec["uneven"] = U.specs(LLAMA4)
    return mesh.spawn(W.tp_family_rank, world, "cpu", args=(spec,))


@pytest.mark.parametrize("phase", U.PHASES)
@pytest.mark.parametrize("label", list(U.HEADS))
def test_uneven_head_cut_moe_matches_unsharded_reference(label, phase):
    """The reduced llama4 (moe) set to 6 (and 10) query heads and 2 KV
    heads at world 4, in the world-4 spawn (its 4 experts one a rank):
    forward, decode and the gradient against the reference's unsharded
    model, the engine's tokens against one rank's
    (``tests/_torch_uneven_cases.py``)."""
    U.check(LLAMA4, label, phase, port(U.WORLD))


@pytest.mark.parametrize("label", list(U.HEADS))
def test_uneven_head_cut_moe_adamw_holds_real_heads(label):
    U.check_adamw(LLAMA4, label, port(U.WORLD))


@pytest.mark.parametrize("phase", ["forward", "decode"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mode", CLI_PSUM_MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_tp_family_logits_match_unsharded_reference(world, mode, arch, phase):
    """Every rank returns the whole vocabulary's logits (gathered), each
    within the model tolerance of the reference's unsharded model."""
    _, want = reference(arch)
    for rank in port(world):
        got = rank[arch][mode][phase]
        ref = want[phase]
        if phase == "forward":
            got, ref = [got], [ref]
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, **TOL)


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mode", CLI_PSUM_MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_tp_family_engine_tokens_match_one_rank(world, mode, arch):
    """Greedy tokens on 2 and 4 ranks equal one rank's (the engine checks
    at every retire that all ranks agree)."""
    one = port(1)[0][arch]["engine"][mode]
    assert len(one) == len(PROMPTS)
    for rank in port(world):
        assert rank[arch]["engine"][mode] == one


@pytest.mark.parametrize("phase", ["forward", "forward_short", "decode"])
@pytest.mark.parametrize("world,case,arch", RS_IDS, ids=RS_NAMES)
def test_rs_seq_logits_match_unsharded_reference(world, case, arch, phase):
    """Under ``rs_seq`` every rank returns the whole vocabulary's logits of
    the forward (the stream sequence-sharded), of a 6-token forward and
    of each decode step (one token: nothing to cut), each within the
    model tolerance of the reference's unsharded model."""
    _, want = reference(arch)
    for rank in port(world):
        got, ref = rank[arch][case][phase], want[phase]
        if phase != "decode":
            got, ref = [got], [ref]
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, **TOL)


def rs_forward_calls(arch: str) -> dict:
    """The group operations of one forward under ``rs_seq`` on a sequence
    the world divides, by kind, derived from the layers: the embedding's
    psum (the vocab-parallel lookup), an all-gather at each block's entry
    (a layer's attention or time mix and its FFN or channel mix), a
    reduce-scatter at each row site (``wo`` and ``w_down``; RWKV6's
    ``wo`` and ``wv``; an MoE layer's shared experts' ``w_down``), a whole
    psum at each MoE combine and at RWKV6's output-norm statistic, and
    the head's entry and the logits' gather (two all-gathers)."""
    cfg = ARCHS[arch].reduced()
    n = cfg.n_layers
    whole = n if arch == RWKV else n - cfg.moe.first_dense_layers
    return {"psum": 1 + whole, "all_gather": 2 * n + 2,
            "reduce_scatter": 2 * n}


@pytest.mark.parametrize("world,case,arch", RS_IDS, ids=RS_NAMES)
def test_rs_seq_forward_calls(world, case, arch):
    """Every rank's forward runs the derived operations; without
    ``rs_seq`` the same forward psums at every row site and gathers only
    the logits."""
    want = rs_forward_calls(arch)
    for rank in port(world):
        assert rank[arch][case]["calls"] == want
        rows = want["reduce_scatter"] + want["psum"]
        assert rank[arch][case_mode(case)]["calls"] == {"psum": rows,
                                                        "all_gather": 1}


def case_mode(case: str) -> str:
    """The psum mode of a case name (``"ina_ring+rs_seq"``: ``ina_ring``)."""
    return case.split("+")[0]


@pytest.mark.parametrize("world,case,arch", RS_IDS, ids=RS_NAMES)
def test_rs_seq_stream_is_sequence_sharded(world, case, arch):
    """Between the layers the stream holds [B, S/P, D] on every rank when
    P divides S, and the whole [B, 6, D] when it does not (6 tokens at
    world 4); one entry a layer."""
    cfg = ARCHS[arch].reduced()
    short = SHORT // world if SHORT % world == 0 else SHORT
    for rank in port(world):
        got = rank[arch][case]
        assert got["stream"] == [(B, S // world, cfg.d_model)] * cfg.n_layers
        assert got["stream_short"] == [(B, short, cfg.d_model)] * cfg.n_layers


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("world", [2, 4])
def test_tp_family_sites_are_the_plan_builders(world, arch):
    """The ``auto`` sites a rank records over its shard in a forward and
    the decode steps are, site for site, what the plan builder's ``meta``
    trace of the whole weights records at the same shapes: RWKV6's output
    norm all-reduce is no site, and the MoE combine and the shared
    experts' psum are two."""
    cfg = ARCHS[arch].reduced()
    mesh_ = (("model", world),)
    want = [(s.op, s.p, s.nbytes) for s in collect_psum_sites(
        cfg, mesh_, ShapeConfig("t", S, B, "prefill"))]
    step = [(s.op, s.p, s.nbytes) for s in collect_psum_sites(
        cfg, mesh_, ShapeConfig("t", MAX_SEQ, B, "decode"))]
    want += step * DECODE
    n_moe = cfg.n_layers - (cfg.moe.first_dense_layers if cfg.moe else 0)
    per_layer = {RWKV: 2, LLAMA4: 3, DEEPSEEK: 3}[arch]
    assert len(step) == per_layer * n_moe + 2 * (cfg.n_layers - n_moe)
    for rank in port(world):
        assert [tuple(s) for s in rank[arch]["sites"]] == want


# --------------------------------------------------------------------------- #
# the shards themselves (this process)
# --------------------------------------------------------------------------- #
def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_tp_family_shards_concatenate_to_the_params(arch, world):
    """``unshard_params`` of every rank's shard rebuilds each converted
    leaf, every element distinct (so a piece two ranks share is told apart
    from two pieces that happen to agree), and each cut leaf is a
    contiguous copy."""
    cfg = ARCHS[arch].reduced()
    jp = jget_model(JARCHS[arch].reduced()).init(jax.random.PRNGKey(1))
    jp = jax.tree.map(lambda a: np.arange(a.size, dtype=np.float32).reshape(
        a.shape), jp)
    full = params_from_jax(jp, cfg, device="cpu")
    shards = [sharding.shard_params(full, cfg, r, world)
              for r in range(world)]
    back = dict(_flat(sharding.unshard_params(shards, cfg, world)))
    cut = 0
    for path, leaf in _flat(full):
        assert torch.equal(back[path], leaf), path
        parts = [dict(_flat(s))[path] for s in shards]
        if parts[0].shape != leaf.shape:
            cut += 1
            assert all(p.is_contiguous() for p in parts), path
    assert back.keys() == dict(_flat(full)).keys()
    assert cut >= {RWKV: 12, LLAMA4: 11, DEEPSEEK: 14}[arch]


def _published_shard_shapes(cfg, world: int) -> dict:
    """Each leaf's shard shape at ``world``, by (parent, name), as the
    module docstring of ``parallel/sharding.py`` states the cuts; a
    leaf absent here is whole.  Shapes leave out the stacked [L] axis."""
    d, v, f = cfg.d_model, cfg.vocab, cfg.d_ff
    out = {("", "embed"): (v // world, d), ("", "lm_head"): (d, v // world)}
    if cfg.family == "ssm":
        hd = cfg.ssm.head_dim
        h = d // hd
        dl = d // world
        return {**out, **{("tmix", n): (d, dl) for n in ("wr", "wk", "wv",
                                                         "wg")},
                ("tmix", "w_lora_b"): (64, dl), ("tmix", "w0"): (dl,),
                ("tmix", "ln_x"): (dl,), ("tmix", "u"): (h // world, hd),
                ("tmix", "wo"): (dl, d), ("cmix", "wk"): (d, f // world),
                ("cmix", "wv"): (f // world, d)}
    m = cfg.moe
    e, fe = m.num_experts // world, m.d_ff_expert
    fs = fe * m.num_shared // world
    out.update({("mlp", "w_gate"): (e, d, fe), ("mlp", "w_up"): (e, d, fe),
                ("mlp", "w_down"): (e, fe, d), ("shared", "w_gate"): (d, fs),
                ("shared", "w_up"): (d, fs), ("shared", "w_down"): (fs, d),
                ("dense", "w_gate"): (d, f // world),
                ("dense", "w_up"): (d, f // world),
                ("dense", "w_down"): (f // world, d)})
    hl = cfg.n_heads // world
    if cfg.family == "mla_moe":
        a = cfg.mla
        out.update({("attn", "wq"): (d, hl * (a.qk_nope_head_dim
                                              + a.qk_rope_head_dim)),
                    ("attn", "w_uk"): (a.kv_lora_rank,
                                       hl * a.qk_nope_head_dim),
                    ("attn", "w_uv"): (a.kv_lora_rank, hl * a.v_head_dim),
                    ("attn", "wo"): (hl * a.v_head_dim, d)})
        return out
    hd = cfg.resolved_head_dim
    kl = cfg.n_kv_heads // world
    out.update({("attn", "wq"): (d, hl * hd), ("attn", "wo"): (hl * hd, d),
                ("attn", "wk"): (d, kl * hd), ("attn", "wv"): (d, kl * hd)})
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_tp_family_shards_of_the_published_widths(arch, world):
    """Every rank's shard of the published config (a ``meta`` init): heads
    H/world (RWKV6's time mix, GQA and MLA attention), routed experts
    E/world, the shared experts', the dense layer's and the channel mix's
    d_ff and the vocabulary cut by world; the router, both token-shift
    ``mu``s, ``w_lora_a``, the channel mix's ``wr``, ``w_dkv``,
    ``kv_norm`` and every norm whole."""
    cfg = ARCHS[arch]
    full = dict(_flat(get_model(cfg).init(device="meta")))
    want = _published_shard_shapes(cfg, world)
    whole = {("mlp", "router"), ("tmix", "mu"), ("tmix", "w_lora_a"),
             ("cmix", "mu"), ("cmix", "wr"), ("attn", "w_dkv"),
             ("attn", "kv_norm")}
    for rank in range(world):
        for path, leaf in _flat(sharding.shard_params(
                get_model(cfg).init(device="meta"), cfg, rank, world)):
            parent = "dense" if path[:2] == ("dense_layers", "mlp") \
                else path[-2] if len(path) > 1 else ""
            lead = 1 if path[0] in ("layers", "dense_layers") else 0
            key = (parent, path[-1])
            assert key not in whole or key not in want
            assert tuple(leaf.shape) == tuple(full[path].shape)[:lead] \
                + want.get(key, tuple(full[path].shape)[lead:]), path


# the matrices of a shard that no ina_matmul multiplies by: the table's
# rows (a lookup), the decay LoRA and the router (torch.matmul), the
# token-shift lerps and the bonus (elementwise)
_NO_PRODUCT = {"embed", "mu", "u", "w_lora_a", "w_lora_b", "router"}


@pytest.mark.parametrize("world", TP_WORLDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rank_projections_are_the_shards_products(arch, world):
    """``kernel_times.rank_projections`` (the rank-local shapes
    ``chip_smoke.py`` holds against plain on the card) lists exactly the
    (K, N) of every cut weight matrix a rank multiplies by, and each plans
    a TMA launch (never ``generic``) at the decode's M 2 and the forward's
    M 2048 on operands as the model hands them over."""
    cfg = ARCHS[arch]
    full = dict(_flat(get_model(cfg).init(device="meta")))
    shard = sharding.shard_params(get_model(cfg).init(device="meta"), cfg,
                                  0, world)
    cut = set()
    for path, leaf in _flat(shard):
        lead = 1 if path[0] in ("layers", "dense_layers") else 0
        if leaf.dim() - lead == 2 and path[-1] not in _NO_PRODUCT \
                and leaf.shape != full[path].shape:
            cut.add(tuple(leaf.shape[lead:]))
    listed = {(k, n) for model, _, k, n, _ in rank_projections(world)
              if model == arch}
    assert listed == cut
    for k, n in listed:
        x = torch.empty(2, k, dtype=torch.bfloat16)
        w = torch.empty(k, n, dtype=torch.bfloat16)
        assert im.plan_for(x, w).regime == "narrow"
        assert im.plan_matmul(2048, n, k, aligned=True).regime == "wide"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_tp_family_world_must_divide_the_heads(arch):
    """A world that does not divide the heads raises, rather than hand a
    rank part of a head.  The moe family's attention takes the uneven
    head cut instead (rank 0's cache one KV head), and its shard raises on
    the 4 experts."""
    cfg = ARCHS[arch].reduced()
    full = get_model(cfg).init(device="meta")
    with pytest.raises(ValueError, match="do not divide"):
        sharding.shard_params(full, cfg, 0, 8)
    if cfg.family in sharding.UNEVEN_HEAD_FAMILIES:
        cache = get_model(cfg).init_cache(1, 8, device="meta", world=8)
        assert cache["k"].shape[3] == 1
        return
    with pytest.raises(ValueError, match="do not divide"):
        get_model(cfg).init_cache(1, 8, device="meta", world=8)


@pytest.mark.parametrize("arch", sorted(
    {a for a, c in ARCHS.items() if c.family != "dense"}))
def test_non_dense_families_still_refuse_training(arch):
    """Every non-dense family trains now (item 5.7 is ported): the step
    builds at one rank here and at 2 ranks of a span-2 axis
    (tensor-parallel in tests/test_torch_tp_train_families.py and
    tests/test_torch_tp_train_hybrid_media.py), one data host each."""
    cfg = ARCHS[arch].reduced()
    shape = ShapeConfig("t", 8, 2, "train")
    assert build_train_step(get_model(cfg), shape).shape == shape
    ts = build_train_step(get_model(cfg), shape,
                          ParallelCtx(group=AxisSpan(2)))
    assert ts.shape == shape and ts.hosts == 1


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launcher_model_parallel_serves_each_family(arch):
    """``serve --model-parallel 2 --device cpu`` (two spawned gloo ranks)
    serves the tokens of ``--model-parallel 1``, on the engine (prompts
    seated token by token) and on the legacy loop."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "3",
            "--slots", "2", "--prompt-len", "6", "--gen", "4",
            "--block-size", "4", "--check"]
    assert launch_serve.main(argv + ["--model-parallel", "2", "--psum-mode",
                                     "ina_ring"]) == launch_serve.main(argv)
    legacy = argv + ["--legacy-loop"]
    assert launch_serve.main(legacy + ["--model-parallel", "2", "--psum-mode",
                                       "eject_inject"]) == \
        launch_serve.main(legacy)
