"""The port's hybrid family (zamba2: Mamba2 + a weight-shared attention
block) against the JAX package's, on the reduced config.

Weights come from the reference (``Model.init(jax.random.PRNGKey(s))``) and
reach the port through ``params_from_jax``; token and activation inputs
come from numpy.  Both run in float32 on the CPU (the port's plain kernel
versions), held to rtol/atol 1e-4: the two sides compute the same f32
sums in other orders (the port batches the SSD's chunks, the reference
scans them), which moves the logits by ~1e-6.  The reduced config has 4
Mamba2 layers in 2 groups, a shared block of 4 heads of 32 over 2 x 64,
and an SSD chunk of 32, so 40 tokens end in a ragged chunk.  The ``gpu``
tests run the port on the card against its plain versions and skip
elsewhere.
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
from repro.models import ssm as jssm
from repro.models.api import cache_specs as jcache_specs
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ina_matmul as im
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import ssm
from repro_torch.models.api import (cache_batch_axes, cache_leaves,
                                    get_model, paged_cache_leaves)
from repro_torch.models.transformer import layer
from repro_torch.parallel.sharding import shard_params
from repro_torch.parallel.steps import build_paged_serve_step, build_train_step
from repro_torch.serve.batching import Request
from repro_torch.serve.engine import ServingEngine

NAME = "zamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 40
ROOT = Path(__file__).resolve().parents[1]


@functools.cache
def _pair():
    jcfg = JARCHS[NAME].reduced()
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    cfg = ARCHS[NAME].reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, get_model(cfg), tp


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model, port params)."""
    return _pair()


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


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


def _mamba(pair):
    """Layer (0, 1)'s Mamba2 weights in both packages."""
    jm, jp, m, tp = pair
    jl = jax.tree.map(lambda a: a[0, 1], jp["groups"]["mamba"])
    return jl, layer(layer(tp["groups"], 0), 1)["mamba"]


# --------------------------------------------------------------------------- #
# Mamba2
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("with_prev", [False, True], ids=["zeros", "prev"])
def test_causal_conv_matches(with_prev):
    x = _normal(1, 2, 7, 12)
    w, b = _normal(2, 4, 12), _normal(3, 12)
    prev = _normal(4, 2, 3, 12) if with_prev else None
    jy, jtail = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b),
                                  None if prev is None else jnp.asarray(prev))
    ty, ttail = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b),
                                 None if prev is None else torch.from_numpy(prev))
    _close(ty, jy)
    _close(ttail, jtail)


@pytest.mark.parametrize("chunk_len", [32, 9])
def test_ssd_chunk_matches(chunk_len):
    """One chunk from a nonzero carried state: y and the new state.  Decays
    of -dt e^0 with dt ~ softplus, as the block gives them."""
    cfg = ARCHS[NAME].reduced()
    h, hd, n = 4, 16, 16
    dt = np.log1p(np.exp(_normal(5, 2, chunk_len, h)))
    xs = (_normal(6, 2, chunk_len, h, hd), _normal(7, 2, chunk_len, n),
          _normal(8, 2, chunk_len, n), -dt, dt)
    state = _normal(9, 2, h, hd, n, scale=0.5)
    jst, jy = jssm._ssd_chunk(jnp.asarray(state),
                              tuple(jnp.asarray(a) for a in xs),
                              JARCHS[NAME].reduced())
    tst, ty = ssm._ssd_chunk(torch.from_numpy(state),
                             tuple(torch.from_numpy(a) for a in xs), cfg)
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("seq", [S, 64, 5])
def test_mamba2_block_matches(pair, seq):
    """A whole sequence from zeros: 40 (one chunk of 32 and a ragged 8), 64
    (two whole chunks) and 5 (one short chunk); output, final state and the
    conv's tail."""
    jm, jp, m, tp = pair
    jl, tl = _mamba(pair)
    x = _normal(10, B, seq, m.cfg.d_model)
    want = jssm.mamba2_block(jl, jnp.asarray(x), JARCHS[NAME].reduced())
    got = ssm.mamba2_block(tl, torch.from_numpy(x), m.cfg)
    for g, w in zip(got, want):
        _close(g, w)


def test_mamba2_single_step_matches(pair):
    """Eight single steps from zero caches against the reference's, state
    and conv tail after each; then the same steps' outputs against one
    whole-sequence pass over them."""
    jm, jp, m, tp = pair
    jl, tl = _mamba(pair)
    cfg, jcfg = m.cfg, JARCHS[NAME].reduced()
    x = _normal(11, B, 8, cfg.d_model)
    conv = np.zeros((B, cfg.ssm.conv_kernel - 1,
                     ssm.mamba2_dims(cfg)[0] + 2 * cfg.ssm.d_state), np.float32)
    jstate, jconv = None, jnp.asarray(conv)
    tstate, tconv = None, torch.from_numpy(conv)
    ys = []
    for t in range(8):
        jy, jstate, jconv = jssm.mamba2_block(
            jl, jnp.asarray(x[:, t:t + 1]), jcfg, state=jstate,
            conv_prev=jconv, single_step=True)
        ty, tstate, tconv = ssm.mamba2_block(
            tl, torch.from_numpy(x[:, t:t + 1]), cfg, state=tstate,
            conv_prev=tconv, single_step=True)
        _close(ty, jy)
        _close(tstate, jstate)
        _close(tconv, jconv)
        ys.append(ty)
    whole, state, _ = ssm.mamba2_block(tl, torch.from_numpy(x), cfg)
    torch.testing.assert_close(torch.cat(ys, 1), whole, **TOL)
    torch.testing.assert_close(tstate, state, **TOL)


# --------------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seq", [S, 64])
def test_forward_matches(pair, seq):
    """The shared block's causal attention runs the flash kernel's plain
    version in the port, the reference's attn_full (40) or attn_chunked
    (64 past its chunk of 32): the same function."""
    jm, jp, m, tp = pair
    toks = _tokens(1, B, seq, m.cfg.vocab)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = m.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, seq, m.cfg.vocab)
    _close(got, want)


def test_loss_matches(pair):
    jm, jp, m, tp = pair
    toks, labels = _tokens(2, B, S, m.cfg.vocab), _tokens(3, B, S, m.cfg.vocab)
    want = jm.loss(jp, {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(labels)})
    got = m.loss(tp, {"tokens": torch.from_numpy(toks).long(),
                      "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_decode_steps_match(pair):
    """Six decode steps of 2 rows at a shared scalar position from empty
    caches: logits and every cache leaf (Mamba2 states, conv tails, the
    shared block's K/V) after each."""
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


def test_forward_equals_decode_loop(pair):
    """The chunked SSD and flash over 40 tokens against the single-step
    recurrence and one-query attention, position by position."""
    jm, jp, m, tp = pair
    toks = torch.from_numpy(_tokens(5, 1, S, m.cfg.vocab)).long()
    fwd = m.forward(tp, {"tokens": toks})
    tc = m.init_cache(1, S, device="cpu")
    for pos in range(S):
        tl, tc = m.decode_step(tp, {"tokens": toks[:, pos:pos + 1],
                                    "pos": pos}, tc)
        torch.testing.assert_close(tl[:, 0], fwd[:, pos], **TOL)


def test_paged_step_runs_each_row_at_its_position(pair):
    """The paged serve step on 5 rows at their own positions (a [B] pos)
    against a B=1 reference decode a row, each row's cache filled with a
    seeded prefix (K/V up to its position, states and conv tails whole):
    logits and every cache leaf's row."""
    jm, jp, m, tp = pair
    max_seq, lens = 12, [0, 3, 7, 11, 5]
    rng = np.random.default_rng(6)
    tc = m.init_cache(len(lens), max_seq, device="cpu")
    axes = cache_batch_axes(m.cfg)
    rows = [{} for _ in lens]
    for path, leaf in cache_leaves(tc).items():
        for r, n in enumerate(lens):
            row = leaf.select(axes[path], r)
            part = row[:, :n] if path in ("k", "v") else row
            part.copy_(torch.from_numpy(
                0.5 * rng.standard_normal(tuple(part.shape)).astype(np.float32)))
            rows[r][path] = leaf.narrow(axes[path], r, 1).numpy().copy()
    feed = torch.full((len(lens), 1), 5, dtype=torch.long)
    batch = {"tokens": feed, "pos": torch.tensor(lens)}
    filled = {k: v.clone() for k, v in tc.items()}
    logits, tc = m.decode_step(tp, batch, tc)
    for r, n in enumerate(lens):
        jc = {k: jnp.asarray(v) for k, v in rows[r].items()}
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(feed[r:r + 1].numpy()),
                                     "pos": _jpos(n)}, jc)
        _close(logits[r:r + 1], jl)
        for path, leaf in cache_leaves(tc).items():
            _close(leaf.narrow(axes[path], r, 1), jc[path])
    nxt, _ = build_paged_serve_step(m).fn(tp, batch, filled)
    assert torch.equal(nxt, torch.argmax(logits[:, -1], dim=-1))


def test_cache_layout(pair):
    """Leaves, shapes and dtypes as the reference's ``init_cache``; batch
    axes where its ``cache_specs`` puts the batch; the shared block's K/V
    paged by position, the Mamba2 states and conv tails stored whole."""
    jm, jp, m, tp = pair
    jc = _leaves(jm.init_cache(3, 8))
    tc = cache_leaves(m.init_cache(3, 8, device="cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tc.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    specs = jcache_specs(JARCHS[NAME].reduced(), batch_axes="__batch__")
    want = {k: list(spec).index("__batch__") for k, spec in specs.items()}
    assert cache_batch_axes(m.cfg) == want == {"ssm": 2, "conv": 2, "k": 1,
                                               "v": 1}
    assert paged_cache_leaves(m.cfg) == ("k", "v")


def test_storage_rule_keeps_two_axis_stacks_vectors_f32(pair):
    """``groups`` leaves carry two stacked axes [G, per, ...]: in bf16 every
    per-layer vector there (``ln``, ``A_log``, ``D``, ``dt_bias``,
    ``conv_b``, ``gate_norm``) and ``inv_norms`` [G, 2D] stay float32, and
    each matrix is bf16; the port's own init stores the same tree.
    Masters follow the reference's ``Model.init`` cast leaf for leaf."""
    jm, jp, m, tp = pair
    cfg = dataclasses.replace(m.cfg, dtype="bfloat16")
    stored = cache_leaves(params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu"))
    vectors = {"groups/ln", "groups/mamba/A_log", "groups/mamba/D",
               "groups/mamba/dt_bias", "groups/mamba/conv_b",
               "groups/mamba/gate_norm", "inv_norms", "ln_f"}
    for path, leaf in stored.items():
        want = torch.float32 if path in vectors else torch.bfloat16
        assert leaf.dtype == want, path
    own = cache_leaves(get_model(cfg).init(device="cpu"))
    assert {k: (v.dtype, v.shape) for k, v in own.items()} == \
        {k: (v.dtype, v.shape) for k, v in stored.items()}
    jcfg = dataclasses.replace(JARCHS[NAME].reduced(), param_dtype="bfloat16")
    jmasters = _leaves(jget_model(jcfg).init(jax.random.PRNGKey(3)))
    masters = cache_leaves(params_from_jax(
        jax.tree.map(np.asarray, jp),
        dataclasses.replace(m.cfg, param_dtype="bfloat16"), device="cpu",
        masters=True))
    assert {k: str(v.dtype).removeprefix("torch.") for k, v in masters.items()} \
        == {k: str(v.dtype) for k, v in jmasters.items()}


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_no_projection_takes_the_generic_path(pair, monkeypatch):
    """bf16: every INA matmul of a forward and of a paged decode step gets
    operands TMA can describe (the tied head's embed.T included), and each
    pass makes as many as chip_smoke.py derives from the code, the bare
    ``@ wo_down`` and ``@ mlp_down`` among them."""
    jm, jp, m, _ = pair
    cfg = dataclasses.replace(m.cfg, dtype="bfloat16")
    model = get_model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    regimes = []
    real = ops.ina_matmul

    def spy(x, w):
        regimes.append(im.plan_for(x, w).regime)
        return real(x, w)
    monkeypatch.setattr(ops, "ina_matmul", spy)
    model.forward(tp, {"tokens": torch.from_numpy(_tokens(8, 1, S, cfg.vocab)).long()})
    assert len(regimes) == _chip_smoke().matmuls_per_pass(cfg)
    regimes.clear()
    model.decode_step(tp, {"tokens": torch.full((3, 1), 4),
                           "pos": torch.tensor([0, 4, 9])},
                      model.init_cache(3, 10, device="cpu"))
    assert len(regimes) == _chip_smoke().matmuls_per_pass(cfg)
    assert "generic" not in regimes


def test_world_above_one_raises(pair):
    """The family is tensor-parallel (``tests/test_torch_tp_hybrid_media.py``
    holds it against the reference): at world 2 a rank's cache holds half
    the Mamba2 heads, its x channels of the conv tail with B and C whole,
    and half the shared block's KV heads; its shard the same cut; a world
    that does not divide the 4 shared heads raises."""
    jm, jp, m, tp = pair
    cfg = m.cfg
    d_inner, h, n, hd, _ = ssm.mamba2_dims(cfg)
    cache = m.init_cache(2, 8, device="cpu", world=2)
    assert cache["ssm"].shape[3] == h // 2
    assert cache["conv"].shape[-1] == d_inner // 2 + 2 * n
    assert cache["k"].shape[3] == cfg.shared_attn_heads // 2
    shard = shard_params(tp, cfg, 0, 2)
    mamba = shard["groups"]["mamba"]
    assert mamba["w_in"].shape[-1] == d_inner + 2 * n + h // 2
    assert mamba["A_log"].shape[-1] == h // 2
    assert torch.equal(shard["inv_norms"], tp["inv_norms"])
    with pytest.raises(ValueError, match="do not divide"):
        m.init_cache(2, 8, device="cpu", world=8)
    with pytest.raises(ValueError, match="do not divide"):
        shard_params(tp, cfg, 0, 8)


def test_build_train_step_names_why_it_raises():
    """zamba2 trains (item 5.7 is ported): one step of the reduced model
    (float32 masters) gives a finite loss and moves the packed ``w_in``,
    the shared block and ``inv_norms`` (the gradients against jax's are
    tests/test_torch_train_hybrid_media.py's); a depth that is not a
    whole number of groups raises, naming the group, as ``_groups``
    does."""
    from repro_torch.optim.adamw import adamw_init
    m = get_model(ARCHS[NAME].reduced())
    params = m.init(device="cpu", masters=True)
    before = {"w_in": params["groups"]["mamba"]["w_in"].clone(),
              "wq": params["shared"]["attn"]["wq"].clone(),
              "inv_norms": params["inv_norms"].clone()}
    ts = build_train_step(m, ShapeConfig("t", 8, 1, "train"))
    toks = torch.randint(0, m.cfg.vocab, (1, 9),
                         generator=torch.Generator().manual_seed(0))
    params, _, st = ts.fn(params, adamw_init(params),
                          {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(st["loss"]))
    after = {"w_in": params["groups"]["mamba"]["w_in"],
             "wq": params["shared"]["attn"]["wq"],
             "inv_norms": params["inv_norms"]}
    for key, was in before.items():
        assert not torch.equal(after[key], was), key
    odd = get_model(dataclasses.replace(m.cfg, n_layers=3))
    with pytest.raises(ValueError, match="does not divide 3 layers"):
        odd.init(device="cpu", masters=True)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
PROMPT_LEN, GEN, BATCH = 6, 5, 3
MAX_SEQ = PROMPT_LEN + GEN + 1


def _reference_tokens(jm, jp, prompts):
    """Greedy tokens [B, GEN+1] of a one-batch per-token loop over the
    reference's decode_step."""
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
    """3 requests on 2 slots, prompts seated token by token, the shared
    K/V paged and the Mamba2 states pooled whole, a paged==monolithic check
    at every retire: greedy tokens equal the reference loop's."""
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


def test_launcher_engine_matches_legacy_loop():
    """``launch/serve.py --reduced --device cpu --check``: the engine path
    and ``--legacy-loop`` serve the same tokens from the same seeded
    weights and prompts."""
    argv = ["--arch", NAME, "--reduced", "--device", "cpu", "--batch", "3",
            "--slots", "2", "--prompt-len", "6", "--gen", "4",
            "--block-size", "4", "--check"]
    engine = launch_serve.main(argv)
    legacy = launch_serve.main(argv + ["--legacy-loop"])
    assert engine == legacy
    assert len(engine) == 3 and all(len(t) == 5 for t in engine)


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
    """The reduced zamba2 forward through the kernels against the same
    forward through their plain versions on the card: 1e-4 in float32 (sum
    order only), 2^-4 of the largest logit in bf16 (one bf16 ulp a
    product, carried through 4 layers)."""
    jm, jp, m, _ = pair
    cfg = dataclasses.replace(m.cfg, dtype=dtype)
    model = get_model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device=cuda)
    toks = torch.from_numpy(_tokens(9, B, 64, cfg.vocab)).long().to(cuda)
    got = model.forward(tp, {"tokens": toks}).float()
    cpu = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    want = model.forward(cpu, {"tokens": toks.cpu()}).float().to(cuda)
    if dtype == "float32":
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert float((got - want).abs().max()) <= 2 ** -4 * float(want.abs().max())
