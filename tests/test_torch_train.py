"""The port's training path against the JAX package's, on reduced configs in
float32 on the CPU.

Weights come from the reference (``Model.init(jax.random.PRNGKey(s))``) and
reach the port as float32 masters through ``params_from_jax(masters=True)``;
batches come from numpy and go to both.  On CPU tensors the kernels'
``autograd.Function`` wrappers run their plain versions, so these tests
exercise the backward the card runs (``InaMatmul``: both gradient products
through ``ina_matmul``; ``FlashAttention``: the VJP of plain f32
attention).  The ``gpu`` tests hold the same backwards on the card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.models.api import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.parallel.steps import build_train_step as jbuild_train_step

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ina_matmul as im
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.ina_matmul import (InaMatmul, ina_matmul,
                                            ina_matmul_plain)
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import shard_params
from repro_torch.parallel.steps import build_train_step, loss_and_grads
from repro_torch.parallel.tp import ParallelCtx

DENSE = ["qwen2-1.5b", "llama3-8b"]
B, S = 2, 40


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(seed, vocab, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)) \
        .astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.cache
def _reference(name: str, seed: int = 3):
    """(reference model, its params with seeded nonzero QKV biases)."""
    jm = jget_model(JARCHS[name].reduced())
    jp = jm.init(jax.random.PRNGKey(seed))
    # the reference initialises biases at zero; seeded values make their
    # gradients and the products through them depend on them
    attn = dict(jp["layers"]["attn"])
    for i, b in enumerate(("bq", "bk", "bv")):
        if b in attn:
            attn[b] = jnp.asarray(0.1 * _normal(40 + i, *attn[b].shape))
    jp = {**jp, "layers": {**jp["layers"], "attn": attn}}
    return jm, jp


def _port(name: str, jp):
    cfg = ARCHS[name].reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JARCHS[name].reduced())
    return get_model(cfg), params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                           device="cpu", masters=True)


def _named(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _port_named(tree):
    return {jax.tree_util.keystr(p): v.detach().float().numpy() for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


# --------------------------------------------------------------------------- #
# the loss's gradient against jax.grad of the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", DENSE)
def test_every_grad_leaf_matches_jax_grad(name):
    """float32 on both sides; the two sum in other orders (and the port's
    attention forward is the flash kernel's blocked online softmax), so a
    leaf agrees within rtol 1e-4 plus atol 1e-5 of the leaf's largest
    gradient: order noise is ~1e-6 relative here, and a wrong or missing
    term moves a leaf by its own order."""
    jm, jp = _reference(name)
    m, params = _port(name, jp)
    batch = _batch(5, m.cfg.vocab)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, batch))(jp)
    loss, grads = loss_and_grads(m, params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want, got = _named(jgrads), _port_named(grads)
    assert sorted(got) == sorted(want)
    for key, g in want.items():
        assert got[key].shape == g.shape, key
        np.testing.assert_allclose(got[key], g, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=key)
        assert np.abs(g).max() > 0, key


@pytest.mark.parametrize("name", DENSE)
def test_params_are_float32_masters(name):
    """Training masters follow the config's param_dtype (float32), as the
    reference's Model.init stores them; the serving rule keeps matrices in
    the compute dtype (float32 in the reduced configs too)."""
    _, jp = _reference(name)
    m, params = _port(name, jp)
    assert all(v.dtype == torch.float32 for v in
               jax.tree_util.tree_leaves(params))
    own = m.init(torch.Generator().manual_seed(0), device="cpu",
                 masters=True)
    assert {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_leaves_with_path(own)} == \
        {k: v.shape for k, v in _named(jp).items()}


def test_masters_rule_follows_param_dtype():
    """A bf16 param_dtype stores every leaf of rank >= 2 in bf16, a stacked
    [L, D] norm weight included, and the final [D] norm in float32."""
    cfg = dataclasses.replace(ARCHS["qwen2-1.5b"].reduced(),
                              param_dtype="bfloat16")
    p = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu",
                            masters=True)
    assert p["embed"].dtype == p["layers"]["ln1"].dtype == torch.bfloat16
    assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["ln_f"].dtype == torch.float32


def test_serving_init_unchanged_by_masters():
    """The same draws: the serving tree is the masters tree stored by the
    serving rule (matrices in the compute dtype, vectors float32)."""
    cfg = dataclasses.replace(ARCHS["qwen2-1.5b"].reduced(),
                              dtype="bfloat16")
    m = get_model(cfg)
    serve = m.init(torch.Generator().manual_seed(4), device="cpu")
    train = m.init(torch.Generator().manual_seed(4), device="cpu",
                   masters=True)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(serve),
                            jax.tree_util.tree_leaves(train)):
        want = b if a.dtype == torch.float32 else b.to(a.dtype)
        assert torch.equal(a, want), jax.tree_util.keystr(path)
    assert serve["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert serve["layers"]["ln1"].dtype == torch.float32


# --------------------------------------------------------------------------- #
# the kernels' autograd Functions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["row", "k-major"])
@pytest.mark.parametrize("m,k,n", [(24, 200, 72), (5, 64, 130)])
def test_ina_matmul_backward_matches_autograd_of_ref(m, k, n, layout):
    """dX and dW through InaMatmul (both products on ina_matmul's plain
    f32 version, one FMA a k) against autograd through ref.matmul_ref:
    the same sums in other orders, rtol 1e-5 and atol 1e-5."""
    x = torch.from_numpy(_normal(1, m, k))
    w = torch.from_numpy(_normal(2, k, n) if layout == "row"
                         else _normal(2, n, k)).contiguous()
    w = w if layout == "row" else w.T          # the tied head's embed.T
    dy = torch.from_numpy(_normal(3, m, n))
    xa, wa = x.clone().requires_grad_(), w.detach().clone().requires_grad_()
    InaMatmul.apply(xa, wa).backward(dy)
    xb, wb = x.clone().requires_grad_(), w.detach().clone().requires_grad_()
    ref.matmul_ref(xb, wb).backward(dy)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-5, atol=1e-5)


def test_ina_matmul_backward_runs_both_products_on_the_kernel(monkeypatch):
    """Forward one ina_matmul call; backward two: dY against a k-major
    w^T for dX, and a row-major x^T against dY for dW."""
    calls = []

    def counting(x, w, plan=None):
        calls.append((tuple(x.shape), tuple(w.shape), w.stride(0) == 1))
        return ina_matmul(x, w, plan)
    monkeypatch.setattr(im, "ina_matmul", counting)
    x = torch.from_numpy(_normal(1, 6, 32)).requires_grad_()
    w = torch.from_numpy(_normal(2, 32, 16)).requires_grad_()
    InaMatmul.apply(x, w).sum().backward()
    assert calls == [((6, 32), (32, 16), False), ((6, 16), (16, 32), True),
                     ((32, 6), (6, 16), False)]


def _expand(t, h):
    """[B, S, KVH, D] -> [B*H, S, D] with query head h reading KV head
    h // (H / KVH)."""
    b, s, kvh, d = t.shape
    return t.repeat_interleave(h // kvh, dim=2).permute(0, 2, 1, 3) \
        .reshape(b * h, s, d)


@pytest.mark.parametrize("h,kvh,sq,sk,off", [(4, 2, 40, 40, 0),
                                             (6, 1, 24, 24, 0),
                                             (4, 4, 16, 40, 24)])
def test_flash_attention_backward_matches_autograd_of_ref(h, kvh, sq, sk,
                                                          off):
    """dq, dk, dv through FlashAttention against autograd through
    ref.attention_ref with the KV heads expanded (their gradients summed
    back by repeat_interleave's backward): the same f32 math in another
    grouping, rtol 1e-5 and atol 1e-6."""
    b, d = 2, 16
    q = torch.from_numpy(_normal(1, b, sq, h, d))
    k = torch.from_numpy(_normal(2, b, sk, kvh, d))
    v = torch.from_numpy(_normal(3, b, sk, kvh, d))
    do = torch.from_numpy(_normal(4, b, sq, h, d))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    FlashAttention.apply(qa, ka, va, True, off).backward(do)
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    o = ref.attention_ref(_expand(qb, h), _expand(kb, h), _expand(vb, h),
                          causal=True, q_offset=off)
    o.reshape(b, h, sq, d).permute(0, 2, 1, 3).backward(do)
    for got, want in ((qa, qb), (ka, kb), (va, vb)):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# launches a step, derived from the code
# --------------------------------------------------------------------------- #
def test_train_step_calls_each_kernel_as_derived(monkeypatch):
    """A step of L layers: 7 L + 1 (the head) ina_matmul calls forward,
    7 L again in the checkpointed layers' recompute, and two for each of
    the 7 L + 1 in the backward; flash attention L forward plus L
    recomputed, none in its backward.  chip_smoke.py holds the card's
    launch counters to the same count at its 8 layers (227 and 16)."""
    calls = {"ina_matmul": 0, "flash_attention": 0}
    real_mm, real_fa = im.ina_matmul, fa._attention

    def mm(*a, **kw):
        calls["ina_matmul"] += 1
        return real_mm(*a, **kw)

    def att(*a, **kw):
        calls["flash_attention"] += 1
        return real_fa(*a, **kw)
    monkeypatch.setattr(im, "ina_matmul", mm)
    monkeypatch.setattr(fa, "_attention", att)
    jm, jp = _reference("qwen2-1.5b")
    m, params = _port("qwen2-1.5b", jp)
    n = m.cfg.n_layers
    ts = build_train_step(m, ShapeConfig("t", S, B, "train"))
    ts.fn(params, adamw.adamw_init(params),
          _torch_batch(_batch(6, m.cfg.vocab)))
    assert calls == {"ina_matmul": 7 * n + 1 + 7 * n + 2 * (7 * n + 1),
                     "flash_attention": 2 * n}


def test_forward_without_grad_takes_no_function(monkeypatch):
    """Serving (no tensor requires a gradient) calls the wrappers straight:
    no autograd Function and no checkpoint."""
    monkeypatch.setattr(InaMatmul, "apply", None)
    monkeypatch.setattr(FlashAttention, "apply", None)
    m = get_model(ARCHS["qwen2-1.5b"].reduced())
    params = m.init(device="cpu")
    logits = m.forward(params, {"tokens": torch.zeros(1, 8, dtype=torch.long)})
    assert logits.shape == (1, 8, m.cfg.vocab)


# --------------------------------------------------------------------------- #
# AdamW against the reference on equal inputs
# --------------------------------------------------------------------------- #
def _tree(seed, scale=1.0):
    """Stacked [L, ...] leaves (decayed), a [D] leaf (not decayed) and an
    embedding, as a model's tree holds them."""
    return {"embed": scale * _normal(seed, 7, 3),
            "layers": {"w": scale * _normal(seed + 1, 2, 4, 3),
                       "ln": scale * _normal(seed + 2, 2, 3)},
            "ln_f": scale * _normal(seed + 3, 3)}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("lr", ["schedule", 2e-2])
@pytest.mark.parametrize("grad_scale", [0.1, 10.0], ids=["unclipped",
                                                         "clipped"])
def test_adamw_update_matches_reference(lr, grad_scale):
    """Three steps on equal params and grads, the moments and step count
    carried: params, m, v, grad_norm and lr within rtol 1e-6 (float32 on
    both sides; the ops round alike up to an FMA)."""
    jlr = jadamw.cosine_schedule(1e-2, 2, 10) if lr == "schedule" else lr
    tlr = adamw.cosine_schedule(1e-2, 2, 10) if lr == "schedule" else lr
    params = _tree(0)
    jp, tp = _to_jax(params), _to_torch(params)
    jopt, topt = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    for i in range(3):
        grads = _tree(10 + 5 * i, grad_scale)
        jp, jopt, jst = jadamw.adamw_update(jp, _to_jax(grads), jopt, jlr)
        tp, topt, tst = adamw.adamw_update(tp, _to_torch(grads), topt, tlr)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tst[key]), float(jst[key]),
                                       rtol=1e-6, err_msg=key)
    assert int(topt.step) == int(jopt.step) == 3
    for j, t in ((jp, tp), (jopt.m, topt.m), (jopt.v, topt.v)):
        want, got = _named(j), _port_named(t)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)


def test_adamw_decays_stacked_leaves_not_vectors():
    """The reference's rule on the stored leaf: with zero gradients only
    weight decay moves a parameter, so the [L, 3] stack shrinks and the
    [3] final norm stays."""
    params = _to_torch(_tree(0))
    zeros = jax.tree.map(torch.zeros_like, params)
    ln_f, ln = params["ln_f"].clone(), params["layers"]["ln"].clone()
    params, _, _ = adamw.adamw_update(params, zeros,
                                      adamw.adamw_init(params), 0.1)
    assert torch.equal(params["ln_f"], ln_f)
    torch.testing.assert_close(params["layers"]["ln"], ln * (1 - 0.1 * 0.1))


@pytest.mark.parametrize("max_norm,scale", [(1.0, 100.0), (1.0, 1e-3),
                                            (5.0, 1.0)])
def test_clip_by_global_norm_matches_reference(max_norm, scale):
    grads = _tree(3, scale)
    jc, jn = jadamw.clip_by_global_norm(_to_jax(grads), max_norm)
    tc, tn = adamw.clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    want, got = _named(jc), _port_named(tc)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 5), (10, 10)])
def test_cosine_schedule_matches_reference(warmup, total):
    jlr = jadamw.cosine_schedule(1e-3, warmup, total)
    tlr = adamw.cosine_schedule(1e-3, warmup, total)
    for step in range(total + 3):
        np.testing.assert_allclose(
            float(tlr(torch.tensor(step, dtype=torch.int32))),
            float(jlr(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=1e-12,
            err_msg=str(step))


# --------------------------------------------------------------------------- #
# the train step against the reference's
# --------------------------------------------------------------------------- #
def test_five_step_loss_trace_matches_reference():
    """The reference's build_train_step on a host mesh of one device and
    the port's, warmup 2, over the same five numpy batches: loss,
    grad_norm and lr at every step within rtol 1e-4.  The gradients agree
    to ~1e-6 (test_every_grad_leaf_matches_jax_grad); Adam divides by
    sqrt(v), which lets a near-zero gradient's rounding move its update
    by up to lr, so later losses part by more than the first's."""
    name = "qwen2-1.5b"
    jm, jp = _reference(name)
    m, params = _port(name, jp)
    shape = JShapeConfig("t", S, B, "train")
    jts = jbuild_train_step(jm, make_host_mesh(1), shape, base_lr=1e-2,
                            warmup=2, total_steps=5, donate=False)
    ts = build_train_step(m, ShapeConfig("t", S, B, "train"), base_lr=1e-2,
                          warmup=2, total_steps=5)
    jopt, opt = jadamw.adamw_init(jp), adamw.adamw_init(params)
    trace = []
    for i in range(5):
        batch = _batch(100 + i, m.cfg.vocab)
        jp, jopt, jst = jts.fn(jp, jopt, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        params, opt, st = ts.fn(params, opt, _torch_batch(batch))
        trace.append((float(st["loss"]), float(jst["loss"])))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(st[key]), float(jst[key]),
                                       rtol=1e-4, err_msg=f"step {i} {key}")
    assert trace[-1][1] < trace[0][1]          # the reference learns here


def test_build_train_step_raises_for_ssm():
    """The ssm family trains (its wkv6 has a gradient): build_train_step
    builds for rwkv6-7b, and a step of the reduced model gives a finite
    loss and updates the time mix's weights (the families' gradients are
    tests/test_torch_train_families.py's).  zamba2-2.7b, whose Mamba2
    layers are ssm blocks of the hybrid family, builds too."""
    m = get_model(ARCHS["rwkv6-7b"].reduced())
    ts = build_train_step(m, ShapeConfig("t", 8, 1, "train"))
    params = m.init(device="cpu", masters=True)
    before = params["layers"]["tmix"]["w_lora_a"].clone()
    params, _, st = ts.fn(params, adamw.adamw_init(params),
                          _torch_batch(_batch(1, m.cfg.vocab, 1, 8)))
    assert np.isfinite(float(st["loss"]))
    assert not torch.equal(params["layers"]["tmix"]["w_lora_a"], before)
    shape = ShapeConfig("t", 8, 1, "train")
    assert build_train_step(get_model(ARCHS["zamba2-2.7b"].reduced()),
                            shape).shape == shape


def test_build_train_step_raises_past_one_rank():
    """Past one rank every family trains (tests/test_torch_tp_train.py,
    tests/test_torch_tp_train_families.py,
    tests/test_torch_tp_train_hybrid_media.py) where the world divides its
    heads, and the dense and moe families also where it does not (the
    uneven head cut): the step builds at 3 ranks for the reduced qwen2's
    4 query heads, whose parameters' cut then refuses its d_ff of 128;
    3 ranks for zamba2's shared block of 4 heads raise, naming the
    family, whose step builds at 2."""
    class ThreeRanks(ParallelCtx):
        world = property(lambda self: 3)
    m = get_model(ARCHS["qwen2-1.5b"].reduced())
    shape = ShapeConfig("t", 8, 1, "train")
    assert build_train_step(m, shape, ThreeRanks()).shape == shape
    with pytest.raises(ValueError, match="do not divide layers/mlp/w_up"):
        shard_params(m.init(device="meta", masters=True), m.cfg, 0, 3)

    class TwoRanks(ParallelCtx):
        world = property(lambda self: 2)
    hybrid = get_model(ARCHS["zamba2-2.7b"].reduced())
    shape = ShapeConfig("t", 8, 1, "train")
    assert build_train_step(hybrid, shape, TwoRanks()).shape == shape
    with pytest.raises(ValueError, match="do not divide.*hybrid family"):
        build_train_step(hybrid, shape, ThreeRanks())


def test_train_step_rejects_other_shapes():
    m = get_model(ARCHS["qwen2-1.5b"].reduced())
    params = m.init(device="cpu", masters=True)
    ts = build_train_step(m, ShapeConfig("t", 8, 2, "train"))
    with pytest.raises(ValueError, match="built for"):
        ts.fn(params, adamw.adamw_init(params),
              _torch_batch(_batch(1, m.cfg.vocab, 1, 8)))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["row", "k-major"])
@pytest.mark.parametrize("m,k,n", [(256, 1536, 256), (128, 512, 1000)])
def test_ina_matmul_backward_on_card(cuda, m, k, n, layout):
    """bf16: dX and dW from the kernel against the plain version of each
    product on the same operands, within one bf16 ulp (rtol 2^-7, atol
    2^-8 of the largest value); two launches, none generic.  The backward
    runs on autograd's worker thread, and here its first CUDA work is this
    product's: the tensor-map encode needs the context the kernel's
    wrapper binds there."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    w = (torch.randn(k, n, generator=gen, device=cuda) if layout == "row"
         else torch.randn(n, k, generator=gen, device=cuda).T) / k ** 0.5
    w = w.bfloat16()
    dy = torch.randn(m, n, generator=gen, device=cuda).bfloat16()
    xa, wa = x.clone().requires_grad_(), w.detach().requires_grad_()
    before, generic = im.launches, im.launches_by_regime["generic"]
    InaMatmul.apply(xa, wa).backward(dy)
    torch.cuda.synchronize()
    assert im.launches - before == 3
    assert im.launches_by_regime["generic"] == generic
    for got, want in ((xa.grad, ina_matmul_plain(dy, w.T)),
                      (wa.grad, ina_matmul_plain(x.T.contiguous(), dy))):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -8 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_backward_on_card(cuda, dtype):
    """qwen2's 12:2 heads of 128: the backward on the card against the same
    f32 VJP taken on the CPU (cuBLAS and the CPU sum in other orders, then
    each rounds to the dtype once: rtol 1e-4 in f32, one bf16 ulp)."""
    dt = getattr(torch, dtype)
    shapes = [(2, 256, 12, 128), (2, 256, 2, 128), (2, 256, 2, 128),
              (2, 256, 12, 128)]
    q, k, v, do = (torch.from_numpy(_normal(i, *s)).to(dt)
                   for i, s in enumerate(shapes))
    grads = []
    for dev in (cuda, "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        FlashAttention.apply(*leaves, True, 0).backward(do.to(dev))
        grads.append([t.grad.cpu().float() for t in leaves])
    tol = (1e-4, 1e-5) if dtype == "float32" else (2 ** -7, 2 ** -7)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=tol[0],
                                   atol=tol[1] * float(want.abs().max()))
