"""The port's dense and ssm (RWKV6) models against the JAX package's, on
reduced configs.

Weights come from the reference (``Model.init(jax.random.PRNGKey(s))``) and
reach the port through ``params_from_jax``; token inputs come from numpy.
Both run in float32 on the CPU (the port's plain kernel versions), held to
rtol/atol 1e-4.  The reference's chunked WKV equals the recurrence while a
chunk's cumulative decay stays under 80 nats; every rwkv case here stays
inside that regime.
"""
import functools
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models.api import cache_specs as jcache_specs
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models.api import (cache_batch_axes, get_model,
                                    paged_cache_leaves)

DENSE = ["qwen2-1.5b", "llama3-8b", "phi3-mini-3.8b", "qwen3-14b"]
ARCH_NAMES = DENSE + ["rwkv6-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 40


@functools.cache
def _make_pair(name: str):
    jm = jget_model(JARCHS[name].reduced())
    jp = jm.init(jax.random.PRNGKey(3))
    cfg = ARCHS[name].reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JARCHS[name].reduced())
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, get_model(cfg), tp


@pytest.fixture(scope="module", params=ARCH_NAMES)
def pair(request):
    """(reference model, its params, port model, port params)."""
    return _make_pair(request.param)


@pytest.fixture(scope="module", params=DENSE)
def dense_pair(request):
    """``pair`` for the families with a batched prefill and a K/V cache."""
    return _make_pair(request.param)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL)


def test_params_keep_names_and_shapes(pair):
    jm, jp, m, tp = pair
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_leaves_with_path(tp)}
    assert len(jl) == len(tl)
    for path, leaf in jl:
        assert tuple(tl[jax.tree_util.keystr(path)].shape) == leaf.shape


@pytest.mark.parametrize("seq", [S, 64])
def test_forward_matches(pair, seq):
    """Dense: 64 tokens take the reference's chunked attention (attn_chunk
    32), 40 its full attention; the port runs the flash kernel for both.
    RWKV6: the reference's WKV chunk is 32, so 40 is ragged (padded there)
    and 64 two whole chunks; the port runs the exact recurrence for both."""
    jm, jp, m, tp = pair
    toks = _tokens(1, B, seq, m.cfg.vocab)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = m.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, seq, m.cfg.vocab)
    _close(got, want)


def test_loss_matches(pair):
    jm, jp, m, tp = pair
    toks = _tokens(2, B, S, m.cfg.vocab)
    labels = _tokens(3, B, S, m.cfg.vocab)
    want = jm.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    got = m.loss(tp, {"tokens": torch.from_numpy(toks).long(),
                      "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("chunks", [(0, 12), (0, 8, 20), (5, 13)],
                         ids=["one-chunk", "three-chunks", "offset-start"])
def test_prefill_matches(dense_pair, chunks):
    """Chunked prefill: logits and cache after every chunk, with
    pos_offset 0 and > 0."""
    jm, jp, m, tp = dense_pair
    max_seq = 32
    toks = _tokens(4, B, max_seq, m.cfg.vocab)
    jc = jm.init_cache(B, max_seq)
    tc = m.init_cache(B, max_seq, device="cpu")
    bounds = list(chunks) + [chunks[-1] + 7]
    for p0, p1 in zip(bounds[:-1], bounds[1:]):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, p0:p1])}, jc,
                            pos_offset=p0)
        tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, p0:p1]).long()},
                           tc, pos_offset=p0)
        _close(tl, jl)
        for leaf in ("k", "v"):
            _close(tc[leaf], jc[leaf])


def test_prefill_reads_the_cache_in_place(dense_pair, monkeypatch):
    """Each layer's attention gets q as projected and k/v as the layer's
    cache slice [:, :end], unexpanded and uncopied (batch stride max_seq x
    KVH x D), and returns a contiguous [B, C, H, D]; the logits still
    match the reference."""
    from repro_torch.kernels import ops
    jm, jp, m, tp = dense_pair
    cfg, max_seq = m.cfg, 32
    calls = []
    real = ops.attention_heads

    def spy(q, k, v, **kw):
        calls.append((q, k, v, kw))
        o = real(q, k, v, **kw)
        assert o.is_contiguous() and o.shape == q.shape
        return o
    monkeypatch.setattr(ops, "attention_heads", spy)
    toks = _tokens(6, B, 20, cfg.vocab)
    tc = m.init_cache(B, max_seq, device="cpu")
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, 8:]).long()},
                       m.prefill(tp, {"tokens": torch.from_numpy(
                           toks[:, :8]).long()}, tc)[1], pos_offset=8)
    assert len(calls) == 2 * cfg.n_layers
    hd = cfg.resolved_head_dim
    for i, (q, k, v, kw) in enumerate(calls[cfg.n_layers:]):
        assert q.shape == (B, 12, cfg.n_heads, hd) and q.is_contiguous()
        assert k.shape == v.shape == (B, 20, cfg.n_kv_heads, hd)
        assert k.data_ptr() == tc["k"][i].data_ptr()
        assert v.data_ptr() == tc["v"][i].data_ptr()
        assert k.stride(0) == max_seq * cfg.n_kv_heads * hd
        assert kw == {"causal": True, "q_offset": 8}
    jc = jm.init_cache(B, max_seq)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, jc)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, 8:])}, jc,
                       pos_offset=8)
    _close(tl, jl)


def test_prefill_rejects_chunk_past_cache(dense_pair):
    jm, jp, m, tp = dense_pair
    tc = m.init_cache(1, 8, device="cpu")
    with pytest.raises(ValueError, match="past the cache"):
        m.prefill(tp, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, tc,
                  pos_offset=6)


def test_decode_step_matches(dense_pair):
    """Prefill 9 tokens, then decode 5 steps at a shared scalar position."""
    jm, jp, m, tp = dense_pair
    max_seq = 16
    toks = _tokens(5, B, 14, m.cfg.vocab)
    jc = jm.init_cache(B, max_seq)
    tc = m.init_cache(B, max_seq, device="cpu")
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :9])}, jc)
    _, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, :9]).long()}, tc)
    for pos in range(9, 14):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, pos:pos + 1]),
                                     "pos": jnp.asarray(pos, jnp.int32)}, jc)
        tl, tc = m.decode_step(tp, {"tokens": torch.from_numpy(
            toks[:, pos:pos + 1]).long(), "pos": pos}, tc)
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


def test_per_row_decode_matches_b1_reference(dense_pair):
    """A [B] ``pos`` (the paged step) equals a B=1 reference decode per row
    at its own position: the reference's vmap, written out as a batch."""
    jm, jp, m, tp = dense_pair
    max_seq = 16
    lens = [3, 9, 6]
    toks = _tokens(6, len(lens), 10, m.cfg.vocab)
    tc = m.init_cache(len(lens), max_seq, device="cpu")
    jcaches = []
    for r, n in enumerate(lens):
        jc = jm.init_cache(1, max_seq)
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[r:r + 1, :n])}, jc)
        jcaches.append(jc)
        tc1 = m.init_cache(1, max_seq, device="cpu")
        _, tc1 = m.prefill(tp, {"tokens": torch.from_numpy(toks[r:r + 1, :n]).long()},
                           tc1)
        for leaf in ("k", "v"):
            tc[leaf][:, r] = tc1[leaf][:, 0]
    pos = torch.tensor(lens)
    feed = torch.from_numpy(np.stack([toks[r, n] for r, n in enumerate(lens)]))
    tl, tc = m.decode_step(tp, {"tokens": feed[:, None].long(), "pos": pos}, tc)
    for r, n in enumerate(lens):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[r:r + 1, n:n + 1]),
                                     "pos": jnp.asarray(n, jnp.int32)}, jcaches[r])
        _close(tl[r:r + 1], jl)
        _close(tc["k"][:, r:r + 1], jc["k"])


def test_cache_layout(pair):
    """Leaves, shapes and dtypes as the reference's ``init_cache``; batch
    axes where the reference's ``cache_specs`` puts the batch (read with a
    string marker, which jax 0.9 keeps); paged leaves are those with a
    sequence axis."""
    jm, jp, m, tp = pair
    jc = jm.init_cache(3, 8)
    tc = m.init_cache(3, 8, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tc.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    specs = jcache_specs(JARCHS[m.cfg.name], batch_axes="__batch__")
    assert cache_batch_axes(m.cfg) == {k: list(spec).index("__batch__")
                                       for k, spec in specs.items()}
    assert paged_cache_leaves(m.cfg) == (
        ("k", "v") if m.cfg.family == "dense" else ())


@pytest.mark.parametrize("norm", ["rms_norm", "layer_norm"])
def test_norms_match(norm):
    from repro.models import layers as jlayers

    from repro_torch.models import layers
    rng = np.random.default_rng(8)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 5, 64), (64,), (64,)))
    args = (x, w, b) if norm == "layer_norm" else (x, w)
    want = getattr(jlayers, norm)(*(jnp.asarray(a) for a in args), eps=1e-5)
    got = getattr(layers, norm)(*(torch.from_numpy(a) for a in args), eps=1e-5)
    _close(got, want)


def test_unknown_family_raises():
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(name="x", family="mamba", n_layers=1, d_model=8,
                      n_heads=1, n_kv_heads=1, d_ff=8, vocab=8)
    with pytest.raises(KeyError, match="unknown family 'mamba'"):
        get_model(cfg)


def test_port_registers_the_reference_families():
    """The seven families of tests/test_models_smoke.py, each with every
    config of the reference's registry."""
    from repro.models.api import _FAMILIES as JFAMILIES

    from repro_torch.models.api import _FAMILIES
    fams = {"dense", "moe", "mla_moe", "ssm", "hybrid", "encdec", "vlm"}
    assert set(_FAMILIES) == set(JFAMILIES) == fams
    assert set(ARCHS) == set(JARCHS)
    assert {c.family for c in ARCHS.values()} == fams


# --------------------------------------------------------------------------- #
# RWKV6
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def rwkv():
    return _make_pair("rwkv6-7b")


def _decode_sequence(jm, jp, m, tp, toks):
    """Decode every token of ``toks`` from empty caches in both packages,
    holding the logits and all three cache leaves after every step."""
    jc = jm.init_cache(toks.shape[0], 8)
    tc = m.init_cache(toks.shape[0], 8, device="cpu")
    for pos in range(toks.shape[1]):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, pos:pos + 1]),
                                     "pos": jnp.asarray(pos, jnp.int32)}, jc)
        tl, tc = m.decode_step(tp, {"tokens": torch.from_numpy(
            toks[:, pos:pos + 1]).long(), "pos": pos}, tc)
        _close(tl, jl)
        for leaf in ("state", "tprev", "cprev"):
            _close(tc[leaf], jc[leaf])
    return tl


def test_rwkv_decode_steps_match(rwkv):
    """Six single-step decodes: logits and state/tprev/cprev after each;
    the last step's logits equal the full-sequence forward's last row."""
    jm, jp, m, tp = rwkv
    toks = _tokens(7, B, 6, m.cfg.vocab)
    last = _decode_sequence(jm, jp, m, tp, toks)
    fwd = m.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    _close(last[:, 0], fwd[:, -1].numpy())


def _perturbed(jp, seed):
    """The reference tree with a nonzero bonus ``u`` and a real decay:
    w0 in [-3, 0] gives at most exp(0.5) = 1.65 nats per step with the
    LoRA term, 53 per 32-token chunk, inside the exact regime (<= 80)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, jp)
    tmix = tree["layers"]["tmix"]
    tmix["u"] = (rng.standard_normal(tmix["u"].shape) * 0.3).astype(np.float32)
    tmix["w0"] = rng.uniform(-3.0, 0.0, tmix["w0"].shape).astype(np.float32)
    return tree


@pytest.mark.parametrize("seq", [S, 64])
def test_rwkv_bonus_and_decay_match(rwkv, seq):
    """With u and w0 perturbed before conversion, the bonus term and real
    decay run: forward (ragged 40 and chunked 64) and six decode steps."""
    jm, _, m, _ = rwkv
    tree = _perturbed(_make_pair("rwkv6-7b")[1], 8)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree, m.cfg, device="cpu")
    toks = _tokens(9, B, seq, m.cfg.vocab)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    _close(m.forward(tp, {"tokens": torch.from_numpy(toks).long()}), want)
    _decode_sequence(jm, jp, m, tp, toks[:, :6])


def test_params_from_jax_keeps_u_float32(rwkv):
    """In a bf16 config matrices go to bf16, but the bonus ``u`` [H, hd]
    stays float32, as the reference reads it (ssm.py:231); so do vectors."""
    _, jp, m, _ = rwkv
    cfg = dataclasses.replace(m.cfg, dtype="bfloat16")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tmix = tp["layers"]["tmix"]
    assert tmix["u"].dtype == torch.float32
    assert tmix["w0"].dtype == torch.float32
    assert tmix["wr"].dtype == tmix["mu"].dtype == torch.bfloat16
    assert tp["embed"].dtype == torch.bfloat16
    own = get_model(cfg).init(device="cpu")["layers"]["tmix"]
    assert own["u"].dtype == torch.float32 and own["wr"].dtype == torch.bfloat16
