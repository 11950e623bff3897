"""Tensor parallelism of the hybrid, vlm and encdec families in the port,
against the JAX package's unsharded models.

The reduced zamba2-2.7b (4 Mamba2 layers in 2 groups, 8 Mamba2 heads of
16, a shared block of 4 heads of 32), llama-3.2-vision-11b (GQA 4:2, one
self and one gated cross-attention layer over 16 media rows, the gates set
to 0.7 and -0.4 so the media reach the logits) and whisper-medium (2
encoder and 2 decoder layers, 4:2 heads, 16 frames), float32, with the
reference's weights (``Model.init(PRNGKey(3))`` through
``params_from_jax``) and media from numpy, run on 1, 2 and 4 gloo ranks,
one spawn a world with every family and mode inside it
(``tests/_torch_dist_workers.py``).  Their forward and decode logits must
match the reference's unsharded ``forward`` and ``decode_step`` within the
port's model tolerance (rtol = atol = 1e-4) under every mode of
``CLI_PSUM_MODES``: decode carries zamba2's Mamba2 states and conv tails
and vlm's ``prefill_media_kv`` cache.  zamba2's engine tokens at worlds 2
and 4 must equal world 1's, and the ``auto`` sites a sharded rank records
must be the ones the plan builder's trace records (Mamba2's gate-norm
all-reduce is none).  The sequence-sharded stream (``rs_seq``) runs as
``tests/test_torch_tp_families.py``'s (``rs_cases``): the same logits,
those of a 6-token forward too (whisper's 16 frames stay cut at world
4), the forward's collective calls as the layers derive them, and a
stream of [B, S/P, D] between the layers (whisper's encoder [B, F/P,
D]).  In this process: the shards concatenate back, each
leaf's shard at the published widths is the cut ``parallel/sharding.py``
states (``w_in``'s segments, its padded rows and the whole leaves
included), ``kernel_times.rank_projections`` lists the shards' products,
a world that divides no heads raises, and the launcher serves each family
at two ranks with one rank's tokens.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import vision as jvision
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.collectives import CLI_PSUM_MODES
from repro_torch.kernels import ina_matmul as im
from repro_torch.launch import mesh
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.kernel_times import (TP_WORLDS, matmul_layout,
                                             rank_projections)
from repro_torch.models.api import get_model
from repro_torch.parallel import sharding
from repro_torch.plan.builder import collect_psum_sites

import _torch_dist_workers as W
from test_torch_tp_families import SHORT, case_mode, cases, rs_cases

HYBRID, VLM, ENCDEC = "zamba2-2.7b", "llama-3.2-vision-11b", "whisper-medium"
ARCH_NAMES = (HYBRID, VLM, ENCDEC)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, MAX_SEQ, DECODE = 2, 8, 16, 3
PROMPTS = ((5, 9, 11, 3, 7, 2), (8, 8, 1, 4, 6, 10), (12, 3, 3, 9, 1, 5))
GEN = 5
WORLDS = (1, 2, 4)
RS_IDS = [(w, c, a) for w in (2, 4) for c in rs_cases(w) for a in ARCH_NAMES]
RS_NAMES = [f"w{w}-{c}-{a}" for w, c, a in RS_IDS]


def _media(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)


@functools.cache
def reference(arch: str):
    """The reference's params (numpy), inputs and unsharded logits: the
    forward, then decode steps from an empty cache (vlm's media K/V
    written by its ``prefill_media_kv``, whisper's media in every step's
    batch)."""
    jm = jget_model(JARCHS[arch].reduced())
    cfg = jm.cfg
    jp = jm.init(jax.random.PRNGKey(3))
    if arch == VLM:
        for name, gate in (("gate_attn", 0.7), ("gate_mlp", -0.4)):
            jp["xlayers"][name] = jnp.full_like(jp["xlayers"][name], gate)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    dec = [rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
           for _ in range(DECODE)]
    media = _media(cfg, 1) if arch != HYBRID else None
    extra = {} if media is None else {"media": jnp.asarray(media)}
    want = {"forward": np.asarray(jm.forward(
        jp, {"tokens": jnp.asarray(toks), **extra})),
        "forward_short": np.asarray(jm.forward(
            jp, {"tokens": jnp.asarray(toks[:, :SHORT]), **extra})),
        "decode": []}
    jc = jm.init_cache(B, MAX_SEQ)
    if arch == VLM:
        jc = jvision.prefill_media_kv(jp, cfg, extra["media"], jc)
    step = extra if arch == ENCDEC else {}
    for pos, tok in enumerate(dec):
        logits, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tok[:, None]),
                                         "pos": jnp.asarray(pos, jnp.int32),
                                         **step}, jc)
        want["decode"].append(np.asarray(logits))
    spec = {"params": jax.tree.map(np.asarray, jp), "tokens": toks,
            "decode_tokens": dec, "media": media}
    return spec, want


@functools.cache
def port(world: int) -> list:
    spec = {"archs": {a: reference(a)[0] for a in ARCH_NAMES},
            "cases": cases(world), "engine": CLI_PSUM_MODES,
            "max_seq": MAX_SEQ, "prompts": PROMPTS, "gen": GEN,
            "short": SHORT}
    return mesh.spawn(W.tp_family_rank, world, "cpu", args=(spec,))


@pytest.mark.parametrize("phase", ["forward", "decode"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mode", CLI_PSUM_MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_tp_hybrid_media_logits_match_unsharded_reference(world, mode, arch,
                                                          phase):
    """Every rank returns the whole vocabulary's logits, each within the
    model tolerance of the reference's unsharded model."""
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


@pytest.mark.parametrize("mode", CLI_PSUM_MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_tp_hybrid_engine_tokens_match_one_rank(world, mode):
    """zamba2's greedy tokens through the engine on 2 and 4 ranks (each
    pooling its Mamba2 heads' states and its shared-block KV heads) equal
    one rank's; the engine checks at every retire that all ranks agree."""
    one = port(1)[0][HYBRID]["engine"][mode]
    assert len(one) == len(PROMPTS)
    for rank in port(world):
        assert rank[HYBRID]["engine"][mode] == one


@pytest.mark.parametrize("phase", ["forward", "forward_short", "decode"])
@pytest.mark.parametrize("world,case,arch", RS_IDS, ids=RS_NAMES)
def test_rs_seq_hybrid_media_logits_match_unsharded_reference(world, case,
                                                              arch, phase):
    """Under ``rs_seq`` every rank returns the whole vocabulary's logits of
    the forward, of a 6-token forward and of each decode step (the vlm's
    cross-attention over the whole media K/V; whisper's decode step
    encodes the frames sequence-sharded again), each within the model
    tolerance of the reference's unsharded model."""
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
    """The group operations of one forward under ``rs_seq`` on sequences
    the world divides, by kind, derived from the layers: the embedding's
    psum, an all-gather at each block's entry (zamba2: a group's shared
    block and each Mamba2 layer; the vlm: two a layer, self or cross;
    whisper: two an encoder layer, three a decoder layer, and the
    encoder's output once), a reduce-scatter at each row site (zamba2:
    the shared ``wo`` and ``w_down`` a group and ``w_out`` a Mamba2 layer;
    the vlm: ``wo`` and ``w_down`` a layer; whisper: two an encoder
    layer, three a decoder layer), a psum at each Mamba2 gate norm's
    statistic, and the head's entry and the logits' gather."""
    cfg = ARCHS[arch].reduced()
    n = cfg.n_layers
    if arch == HYBRID:
        g = n // cfg.shared_attn_every
        return {"psum": 1 + n, "all_gather": g + n + 2,
                "reduce_scatter": 2 * g + n}
    if arch == VLM:
        return {"psum": 1, "all_gather": 2 * n + 2, "reduce_scatter": 2 * n}
    e = cfg.encoder_layers
    return {"psum": 1, "all_gather": 2 * e + 1 + 3 * n + 2,
            "reduce_scatter": 2 * e + 3 * n}


@pytest.mark.parametrize("world,case,arch", RS_IDS, ids=RS_NAMES)
def test_rs_seq_hybrid_media_forward_calls(world, case, arch):
    """Every rank's forward runs the derived operations; without
    ``rs_seq`` the same forward psums at every row site and gathers only
    the logits."""
    want = rs_forward_calls(arch)
    for rank in port(world):
        assert rank[arch][case]["calls"] == want
        rows = want["reduce_scatter"] + want["psum"]
        assert rank[arch][case_mode(case)]["calls"] == {"psum": rows,
                                                        "all_gather": 1}


@pytest.mark.parametrize("world,case,arch", RS_IDS, ids=RS_NAMES)
def test_rs_seq_hybrid_media_stream_is_sequence_sharded(world, case, arch):
    """Between the checkpointed units (a zamba2 or vlm group, a whisper
    layer) the stream holds [B, S/P, D] on every rank when P divides S,
    and the whole [B, 6, D] when it does not (6 tokens at world 4);
    whisper's encoder layers hold [B, F/P, D] of its 16 frames."""
    cfg = ARCHS[arch].reduced()
    d = cfg.d_model
    short = SHORT // world if SHORT % world == 0 else SHORT
    if arch == HYBRID:
        units = cfg.n_layers // cfg.shared_attn_every
    elif arch == VLM:
        units = cfg.n_layers // cfg.cross_attn_every
    else:
        units = cfg.n_layers
    enc = [(B, cfg.num_media_tokens // world, d)] * cfg.encoder_layers
    for rank in port(world):
        got = rank[arch][case]
        assert got["stream"] == enc + [(B, S // world, d)] * units
        assert got["stream_short"] == enc + [(B, short, d)] * units


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("world", [2, 4])
def test_tp_hybrid_media_sites_are_the_plan_builders(world, arch):
    """The ``auto`` sites a rank records over its shard in a forward and
    the decode steps are, site for site, what the plan builder's ``meta``
    trace of the whole weights records at the same shapes (media in the
    inputs for vlm and whisper): a zamba2 group records its shared
    block's ``wo`` and MLP ``w_down`` and a ``w_out`` a Mamba2 layer, the
    gate norm's all-reduce none; vlm and whisper one site an attention
    and an MLP (whisper's decode step encodes the frames again)."""
    cfg = ARCHS[arch].reduced()
    mesh_ = (("model", world),)
    want = [(s.op, s.p, s.nbytes) for s in collect_psum_sites(
        cfg, mesh_, ShapeConfig("t", S, B, "prefill"))]
    step = [(s.op, s.p, s.nbytes) for s in collect_psum_sites(
        cfg, mesh_, ShapeConfig("t", MAX_SEQ, B, "decode"))]
    want += step * DECODE
    if arch == HYBRID:
        per_step = 2 * cfg.n_layers // cfg.shared_attn_every + cfg.n_layers
    elif arch == VLM:
        per_step = 2 * cfg.n_layers
    else:
        per_step = 2 * cfg.encoder_layers + 3 * cfg.n_layers
    assert len(step) == per_step
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
def test_tp_hybrid_media_shards_concatenate_to_the_params(arch, world):
    """``unshard_params`` of every rank's shard rebuilds each converted
    leaf, every element distinct (so a piece two ranks share, as a KV
    head or Mamba2's B and C, is told apart from two pieces that happen to
    agree); each cut leaf is a contiguous copy, but zamba2's ``w_in``,
    whose rows are padded to a multiple of 8."""
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
            for p in parts:
                if path[-1] == "w_in":
                    assert p.stride(-2) % 8 == 0 and p.stride(-1) == 1
                else:
                    assert p.is_contiguous(), path
    assert back.keys() == dict(_flat(full)).keys()
    assert cut == {HYBRID: 16, VLM: 16, ENCDEC: 17}[arch]


def _lead(path) -> int:
    return {"groups": 2, "layers": 1, "xlayers": 1, "enc_layers": 1,
            "dec_layers": 1}.get(path[0], 0)


def _published_shard_shapes(cfg, world: int) -> dict:
    """Each leaf's shard shape at ``world``, by (parent, name), as the
    module docstring of ``parallel/sharding.py`` states the cuts; a leaf
    absent here is whole.  Shapes leave out the stacked leading axes."""
    d, v, f, p = cfg.d_model, cfg.vocab, cfg.d_ff, world
    out = {}
    if cfg.vocab % p == 0:
        out[("", "embed")] = (v // p, d)
    if cfg.family == "hybrid":
        s = cfg.ssm
        di, n = s.expand * d, s.d_state
        h = di // s.head_dim
        d2, fs = 2 * d, cfg.shared_attn_d_ff
        out.update({("mamba", "w_in"): (d, 2 * di // p + 2 * n + h // p),
                    ("mamba", "conv_w"): (s.conv_kernel, di // p + 2 * n),
                    ("mamba", "conv_b"): (di // p + 2 * n,),
                    ("mamba", "A_log"): (h // p,), ("mamba", "D"): (h // p,),
                    ("mamba", "dt_bias"): (h // p,),
                    ("mamba", "gate_norm"): (di // p,),
                    ("mamba", "w_out"): (di // p, d),
                    ("attn", "wq"): (d2, d2 // p), ("attn", "wk"): (d2, d2 // p),
                    ("attn", "wv"): (d2, d2 // p), ("attn", "wo"): (d2 // p, d2),
                    ("mlp", "w_up"): (d2, fs // p),
                    ("mlp", "w_gate"): (d2, fs // p),
                    ("mlp", "w_down"): (fs // p, d2)})
        return out
    hd = cfg.resolved_head_dim
    q, kv = cfg.n_heads * hd // p, cfg.n_kv_heads * hd // p
    for parent in ("attn", "xattn"):
        out.update({(parent, "wq"): (d, q), (parent, "wk"): (d, kv),
                    (parent, "wv"): (d, kv), (parent, "wo"): (q, d)})
    out.update({("mlp", "w_up"): (d, f // p), ("mlp", "w_down"): (f // p, d)})
    if cfg.family == "vlm":
        out.update({("mlp", "w_gate"): (d, f // p), ("", "lm_head"): (d, v // p)})
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_tp_hybrid_media_shards_of_the_published_widths(arch, world):
    """Every rank's shard of the published config (a ``meta`` init):
    zamba2's Mamba2 by its 80 heads (``w_in`` in segments, B and C whole,
    rows padded to a multiple of 8), its shared block by 32 heads of 160
    and d_ff, ``inv_norms``, ``wo_down`` and ``mlp_down`` whole; vlm's
    self and cross-attention by heads (32:8), the MLPs by d_ff, the
    vocabulary by world, the norms and gates whole; whisper's attentions
    by 16 heads, the MLPs by d_ff, ``pos_dec`` and the odd vocabulary's
    table whole."""
    cfg = ARCHS[arch]
    full = dict(_flat(get_model(cfg).init(device="meta")))
    want = _published_shard_shapes(cfg, world)
    for rank in range(world):
        for path, leaf in _flat(sharding.shard_params(
                get_model(cfg).init(device="meta"), cfg, rank, world)):
            lead = _lead(path)
            parent = path[-2] if len(path) > 1 else ""
            assert tuple(leaf.shape) == tuple(full[path].shape)[:lead] \
                + want.get((parent, path[-1]),
                           tuple(full[path].shape)[lead:]), path
            if path[-1] == "w_in":
                assert leaf.stride(-2) == -(-leaf.shape[-1] // 8) * 8


# the matrices of a shard that no ina_matmul multiplies by: the table's
# rows (a lookup; a tied head reads it as embed.T, listed apart) and the
# conv's taps (elementwise)
_NO_PRODUCT = {"embed", "conv_w"}


@pytest.mark.parametrize("world", TP_WORLDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rank_projections_are_the_hybrid_media_shards_products(arch, world):
    """``kernel_times.rank_projections`` (the rank-local shapes
    ``chip_smoke.py`` holds against plain on the card) lists exactly the
    (K, N, layout) of every cut weight matrix a rank multiplies by (the
    tied head ``embed.T`` where the table is cut; zamba2's ``w_in`` at
    world 4, 2708 wide, as the padded view the shard stores), and each
    plans a TMA launch (never ``generic``) at the decode's M 2 and the
    forward's M 2048 on operands as the model hands them over."""
    cfg = ARCHS[arch]
    full = dict(_flat(get_model(cfg).init(device="meta")))
    shard = sharding.shard_params(get_model(cfg).init(device="meta"), cfg,
                                  0, world)
    cut = set()
    for path, leaf in _flat(shard):
        lead = _lead(path)
        if leaf.dim() - lead != 2 or leaf.shape == full[path].shape:
            continue
        if path[-1] == "embed" and cfg.tie_embeddings:
            cut.add((cfg.d_model, leaf.shape[0], "tied"))
        elif path[-1] not in _NO_PRODUCT:
            w = leaf[(0,) * lead]
            cut.add((*w.shape, matmul_layout(w)))
    listed = {(k, n, kind) for model, _, k, n, kind in rank_projections(world)
              if model == arch}
    assert listed == cut
    assert arch != HYBRID or world != 4 or any(
        kind == "padded" and n % 8 for k, n, kind in listed)
    for k, n, kind in listed:
        x = torch.empty(2, k, dtype=torch.bfloat16)
        w = torch.empty(k, -(-n // 8) * 8, dtype=torch.bfloat16)[:, :n] \
            if kind == "padded" else torch.empty(
                (n, k) if kind == "tied" else (k, n), dtype=torch.bfloat16)
        w = w.T if kind == "tied" else w
        assert matmul_layout(w) == kind
        assert im.plan_for(x, w).regime == "narrow"
        assert im.plan_matmul(2048, n, k, aligned=True).regime == "wide"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_tp_hybrid_media_world_must_divide_the_heads(arch):
    """A world that divides no heads raises, rather than hand a rank part
    of a head: the reduced configs' 4 attention heads at 8 ranks (zamba2's
    8 Mamba2 heads would divide: its shared block's 4 do not)."""
    cfg = ARCHS[arch].reduced()
    full = get_model(cfg).init(device="meta")
    with pytest.raises(ValueError, match="do not divide"):
        sharding.shard_params(full, cfg, 0, 8)
    with pytest.raises(ValueError, match="do not divide"):
        get_model(cfg).init_cache(1, 8, device="meta", world=8)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launcher_model_parallel_serves_hybrid_and_media(arch):
    """``serve --model-parallel 2 --device cpu`` (two spawned gloo ranks)
    serves the tokens of ``--model-parallel 1``: zamba2 on the engine
    (prompts seated token by token) and on the legacy loop, vlm and
    whisper on the legacy loop (media of ones)."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "3",
            "--slots", "2", "--prompt-len", "6", "--gen", "4",
            "--block-size", "4", "--check"]
    assert launch_serve.main(argv + ["--model-parallel", "2", "--psum-mode",
                                     "ina_ring"]) == launch_serve.main(argv)
    if arch == HYBRID:
        legacy = argv + ["--legacy-loop"]
        assert launch_serve.main(legacy + ["--model-parallel", "2",
                                           "--psum-mode", "eject_inject"]) \
            == launch_serve.main(legacy)


def test_every_family_shards():
    """All seven families are cut over ``model``; the one-rank refusals
    (``tp.single_rank``, ``sharding.check_sharded_family``) are gone."""
    from repro_torch.models import api
    from repro_torch.parallel import tp
    assert set(sharding.SHARDED_FAMILIES) == set(api._FAMILIES)
    assert not hasattr(tp, "single_rank")
    assert not hasattr(sharding, "check_sharded_family")
