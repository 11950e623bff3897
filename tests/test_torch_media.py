"""The port's media families, vlm (llama-3.2-vision: gated cross-attention
over patch embeddings) and encdec (whisper: an encoder over frame
embeddings, a decoder with cross-attention), against the JAX package's, on
the reduced configs.

Weights come from the reference (``Model.init(jax.random.PRNGKey(s))``) and
reach the port through ``params_from_jax``; tokens and media (the stub
frontends' embeddings, 16 rows at reduced size) come from numpy.  The
reference initialises vlm's two tanh gates a cross layer at 0, which
multiplies the cross-attention layer's output by 0: the tests set them to
0.7 and -0.4 in the reference's tree before converting it, so the media
reach the logits.  Both packages run in float32 on the CPU (the port's
plain kernel versions), held to rtol/atol 1e-4.  The ``gpu`` tests run
the port on the card against its plain versions and skip elsewhere.
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
from repro.models import encdec as jencdec
from repro.models import vision as jvision
from repro.models.api import cache_specs as jcache_specs
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ina_matmul as im
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import encdec, vision
from repro_torch.models.api import (cache_batch_axes, cache_leaves,
                                    get_model, paged_cache_leaves)
from repro_torch.parallel.sharding import shard_params
from repro_torch.parallel.steps import build_serve_step, build_train_step
from repro_torch.serve.engine import ServingEngine

VLM, ENCDEC = "llama-3.2-vision-11b", "whisper-medium"
ARCH_NAMES = [VLM, ENCDEC]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 40
ROOT = Path(__file__).resolve().parents[1]


@functools.cache
def _make_pair(name: str):
    jcfg = JARCHS[name].reduced()
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    if name == VLM:
        jp["xlayers"]["gate_attn"] = jnp.full_like(jp["xlayers"]["gate_attn"],
                                                   0.7)
        jp["xlayers"]["gate_mlp"] = jnp.full_like(jp["xlayers"]["gate_mlp"],
                                                  -0.4)
    cfg = ARCHS[name].reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
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


def _media(seed, b, cfg):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)


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


def _batches(seed, b, s, cfg):
    """The same tokens and media for both packages."""
    toks, media = _tokens(seed, b, s, cfg.vocab), _media(seed + 100, b, cfg)
    return ({"tokens": jnp.asarray(toks), "media": jnp.asarray(media)},
            {"tokens": torch.from_numpy(toks).long(),
             "media": torch.from_numpy(media)})


def _decode_batches(toks, pos, media):
    jb = {"tokens": jnp.asarray(toks[:, pos:pos + 1]),
          "pos": jnp.asarray(pos, jnp.int32), "media": jnp.asarray(media)}
    tb = {"tokens": torch.from_numpy(toks[:, pos:pos + 1]).long(), "pos": pos,
          "media": torch.from_numpy(media)}
    return jb, tb


def _caches(pair, b, max_seq, media):
    """Empty decode caches of both packages; vlm's media K/V prefilled."""
    jm, jp, m, tp = pair
    jc = jm.init_cache(b, max_seq)
    tc = m.init_cache(b, max_seq, device="cpu")
    if m.cfg.family == "vlm":
        jc = jvision.prefill_media_kv(jp, JARCHS[VLM].reduced(),
                                      jnp.asarray(media), jc)
        tc = vision.prefill_media_kv(tp, m.cfg, torch.from_numpy(media), tc)
    return jc, tc


# --------------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seq", [S, 64])
def test_forward_matches(pair, seq):
    """Non-causal attention over the media (vlm's cross layers; whisper's
    encoder and cross-attention) runs the flash kernel's plain version in
    the port, the reference's attn_full or attn_chunked: the same
    function; so does the causal self-attention."""
    jm, jp, m, tp = pair
    jb, tb = _batches(1, B, seq, m.cfg)
    want = jm.forward(jp, jb)
    got = m.forward(tp, tb)
    assert got.shape == (B, seq, m.cfg.vocab)
    _close(got, want)


def test_loss_matches(pair):
    jm, jp, m, tp = pair
    jb, tb = _batches(2, B, S, m.cfg)
    labels = _tokens(3, B, S, m.cfg.vocab)
    jb["labels"], tb["labels"] = jnp.asarray(labels), \
        torch.from_numpy(labels).long()
    np.testing.assert_allclose(float(m.loss(tp, tb)), float(jm.loss(jp, jb)),
                               **TOL)


def test_decode_steps_match(pair):
    """Six decode steps of 2 rows at a shared scalar position from empty
    caches (vlm's media K/V prefilled; whisper encodes the media every
    step): logits and every cache leaf after each."""
    jm, jp, m, tp = pair
    toks = _tokens(4, B, 6, m.cfg.vocab)
    media = _media(5, B, m.cfg)
    jc, tc = _caches(pair, B, 8, media)
    for pos in range(6):
        jb, tb = _decode_batches(toks, pos, media)
        jl, jc = jm.decode_step(jp, jb, jc)
        tl, tc = m.decode_step(tp, tb, tc)
        _close(tl, jl)
        _close_caches(tc, jc)


def test_forward_equals_decode_loop(pair):
    """Flash over several queries (causal and over the media) against one
    query at a time through attn_full, position by position."""
    jm, jp, m, tp = pair
    _, tb = _batches(6, 1, 12, m.cfg)
    fwd = m.forward(tp, tb)
    media = tb["media"].numpy()
    _, tc = _caches(pair, 1, 12, media)
    toks = tb["tokens"].numpy()
    for pos in range(12):
        _, b = _decode_batches(toks, pos, media)
        tl, tc = m.decode_step(tp, b, tc)
        torch.testing.assert_close(tl[:, 0], fwd[:, pos], **TOL)


def test_decode_step_takes_a_position_a_row(pair):
    """A [B] ``pos`` (the paged step's form) gives row i what a B=1 decode
    at pos[i] gives: RoPE angle, cache column, mask and (whisper) position
    row of ``pos_dec``, against B=1 reference decodes from the same
    prefix."""
    jm, jp, m, tp = pair
    toks = _tokens(7, B, 8, m.cfg.vocab)
    media = _media(8, B, m.cfg)
    lens = [3, 6]
    jrows = []
    for r, n in enumerate(lens):
        jc, _ = _caches(pair, 1, 8, media[r:r + 1])
        for pos in range(n + 1):
            jb, _ = _decode_batches(toks[r:r + 1], pos, media[r:r + 1])
            jl, jc = jm.decode_step(jp, jb, jc)
        jrows.append(jl)
    _, tc = _caches(pair, B, 8, media)
    for pos in range(max(lens)):
        # every row advances through its own prefix; the rows past their
        # length are rewritten by the step under test
        _, tb = _decode_batches(toks, pos, media)
        _, tc = m.decode_step(tp, tb, tc)
    feed = np.stack([toks[r, n] for r, n in enumerate(lens)])[:, None]
    tl, _ = m.decode_step(tp, {"tokens": torch.from_numpy(feed).long(),
                               "pos": torch.tensor(lens),
                               "media": torch.from_numpy(media)}, tc)
    for r in range(B):
        _close(tl[r:r + 1], jrows[r])


def test_prefill_media_kv_matches():
    """Every cross layer's K (k-normed) and V over the media, written into
    ``mk``/``mv``."""
    jm, jp, m, tp = _make_pair(VLM)
    media = _media(9, B, m.cfg)
    jc = jvision.prefill_media_kv(jp, JARCHS[VLM].reduced(),
                                  jnp.asarray(media), jm.init_cache(B, 4))
    tc = vision.prefill_media_kv(tp, m.cfg, torch.from_numpy(media),
                                 m.init_cache(B, 4, device="cpu"))
    for name in ("mk", "mv"):
        assert float(tc[name].abs().max()) > 0
        _close(tc[name], jc[name])


def test_encode_matches():
    """Whisper's encoder over the frames: non-causal attention without
    RoPE, the ungated GELU MLP, the final norm."""
    jm, jp, m, tp = _make_pair(ENCDEC)
    media = _media(10, B, m.cfg)
    want = jencdec.encode(jp, JARCHS[ENCDEC].reduced(), jnp.asarray(media))
    _close(encdec.encode(tp, m.cfg, torch.from_numpy(media)), want)


def test_cache_layout(pair):
    """Leaves, shapes and dtypes as the reference's ``init_cache`` (vlm's
    media K/V ``mk``/``mv`` among them), batch axes where its
    ``cache_specs`` puts the batch; the self-attention K/V paged."""
    jm, jp, m, tp = pair
    jc = _leaves(jm.init_cache(3, 8))
    tc = cache_leaves(m.init_cache(3, 8, device="cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tc.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    specs = jcache_specs(JARCHS[m.cfg.name].reduced(), batch_axes="__batch__")
    assert cache_batch_axes(m.cfg) == \
        {k: list(spec).index("__batch__") for k, spec in specs.items()}
    assert paged_cache_leaves(m.cfg) == ("k", "v")


def test_storage_rule(pair):
    """bf16 serving storage: a leaf is bf16 exactly where its rank without
    the stacked axes (``groups`` two, ``xlayers``, ``enc_layers``,
    ``dec_layers`` one) is >= 2; vlm's 0-d gates stay float32; the port's
    own init stores the same tree; masters follow the reference's cast."""
    jm, jp, m, tp = pair
    cfg = dataclasses.replace(m.cfg, dtype="bfloat16")
    stored = cache_leaves(params_from_jax(_numpy_tree(jp), cfg, device="cpu"))
    lead = {"groups": 2, "xlayers": 1, "enc_layers": 1, "dec_layers": 1}
    for path, leaf in stored.items():
        rank = leaf.dim() - lead.get(path.split("/")[0], 0)
        assert leaf.dtype == (torch.bfloat16 if rank >= 2 else torch.float32), \
            path
    if cfg.family == "vlm":
        assert stored["xlayers/gate_attn"].dtype == torch.float32
        assert stored["groups/ln1"].dtype == torch.float32
    own = cache_leaves(get_model(cfg).init(device="cpu"))
    assert {k: (v.dtype, v.shape) for k, v in own.items()} == \
        {k: (v.dtype, v.shape) for k, v in stored.items()}
    jcfg = dataclasses.replace(JARCHS[m.cfg.name].reduced(),
                               param_dtype="bfloat16")
    jmasters = _leaves(jget_model(jcfg).init(jax.random.PRNGKey(3)))
    masters = cache_leaves(params_from_jax(
        _numpy_tree(jp), dataclasses.replace(m.cfg, param_dtype="bfloat16"),
        device="cpu", masters=True))
    assert {k: str(v.dtype).removeprefix("torch.") for k, v in masters.items()} \
        == {k: str(v.dtype) for k, v in jmasters.items()}


def test_input_specs_carry_the_media(pair):
    """``media`` [B, num_media_tokens, D] in the compute dtype beside the
    reference's other inputs, in every phase's specs."""
    jm, jp, m, tp = pair
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        got = m.input_specs(SHAPES[name])
        want = jm.input_specs(SHAPES[name])
        assert set(got) == set(want)
        assert tuple(got["media"].shape) == want["media"].shape
        assert got["media"].dtype == getattr(torch, m.cfg.dtype)


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_no_projection_takes_the_generic_path(pair, monkeypatch):
    """bf16: every INA matmul of a forward, of vlm's media K/V prefill and
    of a decode step gets operands TMA can describe (whisper's tied head
    over its odd vocabulary included: ``embed.T`` is k-major with row
    stride d_model), and each pass makes as many as chip_smoke.py derives
    from the code."""
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
    _, tb = _batches(11, 1, S, cfg)
    tb["media"] = tb["media"].to(torch.bfloat16)
    model.forward(tp, tb)
    cs = _chip_smoke()
    assert len(regimes) == cs.matmuls_per_pass(cfg)
    cache = model.init_cache(3, 10, device="cpu")
    media = tb["media"].expand(3, -1, -1).contiguous()
    regimes.clear()
    if cfg.family == "vlm":
        vision.prefill_media_kv(tp, cfg, media, cache)
        assert len(regimes) == 2 * (cfg.n_layers // cfg.cross_attn_every)
    regimes.clear()
    model.decode_step(tp, {"tokens": torch.full((3, 1), 4),
                           "pos": torch.tensor([0, 4, 9]), "media": media},
                      cache)
    assert len(regimes) == cs.matmuls_per_pass(cfg, media_cached=True)
    assert "generic" not in regimes


def test_whisper_head_plans_tma():
    """The tied head [1024, 51865] read as ``embed.T``: its row stride is
    d_model (1024, k-major), so every M the paths give it plans a TMA
    regime, never ``generic``, though 51865 is odd."""
    cfg = ARCHS[ENCDEC]
    embed = torch.zeros(cfg.vocab, cfg.d_model, dtype=torch.bfloat16)
    for m in (1, 2, 16, 448):
        x = torch.zeros(m, cfg.d_model, dtype=torch.bfloat16)
        assert im.plan_for(x, embed.T).regime == ("narrow" if m <= 16
                                                   else "wide")


def test_world_above_one_raises(pair):
    """The families are tensor-parallel
    (``tests/test_torch_tp_hybrid_media.py`` holds them against the
    reference): at world 2 a rank's cache holds its KV heads (over the
    media too, vlm) and its shard half the heads of the self- and the
    cross-attention; a world that does not divide the 4 heads raises."""
    jm, jp, m, tp = pair
    cfg = m.cfg
    hd = cfg.resolved_head_dim
    cache = m.init_cache(2, 8, device="cpu", world=2)
    for leaf in cache.values():
        assert leaf.shape[-2] == cfg.n_kv_heads // 2
    shard = shard_params(tp, cfg, 0, 2)
    cross = shard["xlayers" if cfg.family == "vlm" else "dec_layers"]["xattn"]
    assert cross["wq"].shape[-1] == cfg.n_heads // 2 * hd
    assert cross["wk"].shape[-1] == cfg.n_kv_heads // 2 * hd
    assert cross["wo"].shape[-2] == cfg.n_heads // 2 * hd
    with pytest.raises(ValueError, match="do not divide"):
        m.init_cache(2, 8, device="cpu", world=8)
    with pytest.raises(ValueError, match="do not divide"):
        shard_params(tp, cfg, 0, 8)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_build_train_step_names_why_it_raises(name):
    """The vlm and encdec families train (item 5.7 is ported): one step
    of the reduced model (float32 masters) on a batch with media of ones
    (``models.api.media_ones``) gives a finite loss and moves the
    cross-attention's query weights (the gradients against jax's are
    tests/test_torch_train_hybrid_media.py's); a batch without media
    raises."""
    from repro_torch.models.api import media_ones
    from repro_torch.optim.adamw import adamw_init
    m = get_model(ARCHS[name].reduced())
    params = m.init(device="cpu", masters=True)
    if name == VLM:
        for gate in ("gate_attn", "gate_mlp"):
            params["xlayers"][gate].fill_(0.5)
    cross = params["xlayers" if name == VLM else "dec_layers"]["xattn"]
    before = cross["wq"].clone()
    ts = build_train_step(m, ShapeConfig("t", 8, 1, "train"))
    toks = torch.randint(0, m.cfg.vocab, (1, 9),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with pytest.raises(KeyError, match="media"):
        ts.fn(params, adamw_init(params), batch)
    params, _, st = ts.fn(params, adamw_init(params),
                          {**batch, **media_ones(m.cfg, 1, "cpu")})
    assert np.isfinite(float(st["loss"]))
    assert not torch.equal(cross["wq"], before)


# --------------------------------------------------------------------------- #
# serving: the legacy loop, as in the reference
# --------------------------------------------------------------------------- #
PROMPT_LEN, GEN, BATCH = 6, 4, 3


def _reference_tokens(name, jm, jp, prompts):
    """Greedy tokens [B, GEN+1] of the reference launcher's legacy loop
    (``repro.launch.serve.run_legacy``) on the same weights: media of ones,
    vlm's media K/V prefilled, a per-token loop over ``decode_step``."""
    jcfg = JARCHS[name].reduced()
    media = jnp.ones((BATCH, jcfg.num_media_tokens, jcfg.d_model), jnp.float32)
    cache = jm.init_cache(BATCH, PROMPT_LEN + GEN)
    if name == VLM:
        cache = jvision.prefill_media_kv(jp, jcfg, media, cache)
    for pos in range(PROMPT_LEN):
        logits, cache = jm.decode_step(
            jp, {"tokens": jnp.asarray(prompts[:, pos:pos + 1]),
                 "pos": jnp.asarray(pos, jnp.int32), "media": media}, cache)
    nxt = jnp.argmax(logits[:, -1], axis=-1)
    out = [np.asarray(nxt)]
    for i in range(GEN):
        logits, cache = jm.decode_step(
            jp, {"tokens": nxt[:, None],
                 "pos": jnp.asarray(PROMPT_LEN + i, jnp.int32),
                 "media": media}, cache)
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        out.append(np.asarray(nxt))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_legacy_loop_matches_reference_tokens(name):
    """``launch/serve.py``'s legacy loop on the converted weights: the
    reference loop's greedy tokens, token for token."""
    jm, jp, m, tp = _make_pair(name)
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--batch",
            str(BATCH), "--prompt-len", str(PROMPT_LEN), "--gen", str(GEN)]
    args = launch_serve.build_parser().parse_args(argv)
    got = launch_serve.run_legacy(args, m.cfg, tp)["tokens"]
    prompts = launch_serve.make_prompts(m.cfg, BATCH, PROMPT_LEN).numpy()
    assert got.tolist() == _reference_tokens(name, jm, jp, prompts).tolist()


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_launcher_sends_media_families_to_the_legacy_loop(name, capsys):
    """Without ``--legacy-loop`` the launcher says why and runs the legacy
    loop; its tokens equal those of ``--legacy-loop``."""
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "4", "--gen", "3"]
    tokens = launch_serve.main(argv)
    assert "needs media plumbing; running the legacy loop" in \
        capsys.readouterr().out
    assert tokens == launch_serve.main(argv + ["--legacy-loop"])
    assert len(tokens) == 2 and all(len(t) == 4 for t in tokens)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_engine_refuses_media_families(name):
    with pytest.raises(ValueError, match="media plumbing"):
        ServingEngine(ARCHS[name].reduced(), device="cpu", slots=1,
                      max_seq=8, block_size=4)


def test_serve_step_threads_the_media():
    """The legacy serve step hands ``batch["media"]`` to ``decode_step``:
    other media, other logits."""
    jm, jp, m, tp = _make_pair(ENCDEC)
    step = build_serve_step(m)
    toks = torch.full((1, 1), 5)
    out = []
    for seed in (12, 13):
        cache = m.init_cache(1, 4, device="cpu")
        media = torch.from_numpy(_media(seed, 1, m.cfg))
        out.append(step.fn(tp, {"tokens": toks, "pos": 0, "media": media},
                           cache)[2])
    assert not torch.allclose(out[0], out[1])


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_on_card_matches_plain(cuda, pair, dtype):
    """The reduced forward through the kernels (non-causal flash over the
    media included) against the same forward through the plain versions
    on the CPU: 1e-4 in float32 (sum order only), 2^-4 of the largest
    logit in bf16 (one bf16 ulp a product, carried through the layers)."""
    jm, jp, m, _ = pair
    cfg = dataclasses.replace(m.cfg, dtype=dtype)
    model = get_model(cfg)
    _, tb = _batches(14, B, 64, cfg)
    want = model.forward(params_from_jax(_numpy_tree(jp), cfg, device="cpu"),
                         tb).float()
    got = model.forward(params_from_jax(_numpy_tree(jp), cfg, device=cuda),
                        {k: v.to(cuda) for k, v in tb.items()}).float().cpu()
    if dtype == "float32":
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert float((got - want).abs().max()) <= 2 ** -4 * float(want.abs().max())
