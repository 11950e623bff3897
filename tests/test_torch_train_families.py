"""Training the ssm (rwkv6-7b), moe (llama4-scout-17b-16e) and mla_moe
(deepseek-v2-lite-16b) families in the port, against the JAX package's, on
reduced configs in float32 on the CPU, at one rank.

Weights come from the reference (``Model.init(jax.random.PRNGKey(3))``,
RWKV6's zero bonus ``u`` replaced by seeded values so that the products
through it count) and reach the port as float32 masters through
``params_from_jax(masters=True)``; batches come from numpy and go to both.
On CPU tensors the kernels' ``autograd.Function`` wrappers run their plain
versions, so these tests exercise the backward the card runs: ``Wkv6``'s is
the VJP of the plain chunked wkv6 in float32.

* The loss and every gradient leaf against ``jax.value_and_grad`` of the
  reference's ``loss`` (``tests/test_torch_train.py``'s rule: loss rtol
  1e-5, each leaf rtol 1e-4 plus atol 1e-5 of its largest magnitude).
* Two AdamW steps through ``build_train_step`` against the reference's
  ``build_train_step`` on a host mesh of one device.
* One MoE FFN whose capacity drops, under autograd: the reference's
  experts and its gradients.
* ``Wkv6``'s gradients of r, k, v, logw and u against ``jax.vjp`` of
  ``repro.kernels.ref.wkv6_ref``, at sequences the chunk does not divide
  and decays past the model's clip floor.
* A step's kernel calls against ``chip_smoke.train_launches``, serving
  untouched (no Function, no checkpoint), the untrained families
  refused (the remat policies: ``tests/test_torch_remat_*.py``), and
  ``sharding.data_cut`` against the reference's ``param_specs`` fitted to
  the ``(data 2, model 2)`` mesh.
"""
import dataclasses
import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels import ref as jref
from repro.launch.mesh import make_host_mesh
from repro.models.api import get_model as jget_model
from repro.models.api import param_specs as jparam_specs
from repro.optim import adamw as jadamw
from repro.parallel.sharding import fit_spec as jfit_spec
from repro.parallel.steps import build_train_step as jbuild_train_step

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ina_matmul as im
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.ina_matmul import InaMatmul
from repro_torch.kernels.wkv6 import Wkv6
from repro_torch.models import transformer
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.parallel.steps import build_train_step, loss_and_grads

RWKV, LLAMA4, DEEPSEEK = ("rwkv6-7b", "llama4-scout-17b-16e",
                          "deepseek-v2-lite-16b")
FAMILIES = (RWKV, LLAMA4, DEEPSEEK)
B, S = 2, 40
ROOT = Path(__file__).resolve().parents[1]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(seed, vocab, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)) \
        .astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


@functools.cache
def _reference(name: str):
    """(reference model, its params), RWKV6's ``u`` seeded."""
    jm = jget_model(JARCHS[name].reduced())
    jp = jm.init(jax.random.PRNGKey(3))
    if name == RWKV:
        tmix = dict(jp["layers"]["tmix"])
        tmix["u"] = jnp.asarray(0.5 * _normal(41, *tmix["u"].shape))
        jp = {**jp, "layers": {**jp["layers"], "tmix": tmix}}
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


def _assert_leaves_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=key)


# --------------------------------------------------------------------------- #
# the loss's gradient and two AdamW steps against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", FAMILIES)
def test_every_grad_leaf_matches_jax_grad(name):
    """float32 on both sides, summed in other orders (the port's wkv6 is
    chunked where the reference's scan steps token by token), so each leaf
    within rtol 1e-4 plus atol 1e-5 of its largest gradient; every leaf
    nonzero: the decay LoRA and ``w0`` train through ``logw``, the router
    through the gate values and the aux loss."""
    jm, jp = _reference(name)
    m, params = _port(name, jp)
    batch = _batch(5, m.cfg.vocab)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, batch))(jp)
    loss, grads = loss_and_grads(m, params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _named(jgrads)
    _assert_leaves_close(_port_named(grads), want)
    assert all(np.abs(g).max() > 0 for g in want.values())


@functools.cache
def _two_steps(name: str):
    """The reference's and the port's train steps, warmup 1, over the same
    two numpy batches: the per-step stats of each, and the params and
    moments after them of each."""
    jm, jp = _reference(name)
    m, params = _port(name, jp)
    sched = {"base_lr": 1e-2, "warmup": 1, "total_steps": 10}
    jts = jbuild_train_step(jm, make_host_mesh(1),
                            JShapeConfig("t", S, B, "train"), donate=False,
                            **sched)
    ts = build_train_step(m, ShapeConfig("t", S, B, "train"), **sched)
    jopt, opt = jadamw.adamw_init(jp), adamw.adamw_init(params)
    jstats, stats = [], []
    for i in range(2):
        batch = _batch(100 + i, m.cfg.vocab)
        jp, jopt, jst = jts.fn(jp, jopt, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        params, opt, st = ts.fn(params, opt, _torch_batch(batch))
        jstats.append({k: float(v) for k, v in jst.items()})
        stats.append({k: float(v) for k, v in st.items()})
    return jstats, stats, (_named(jp), _named(jopt.m), _named(jopt.v)), \
        (_port_named(params), _port_named(opt.m), _port_named(opt.v))


@pytest.mark.parametrize("name", FAMILIES)
def test_two_adamw_steps_match_reference(name):
    """Loss, grad_norm and lr of both steps within rtol 1e-4 (the rule of
    ``tests/test_torch_train.py``'s loss trace), and every param within
    AdamW's bound of the reference's after them: the two updates move an
    element by at most lr a step each, on both sides.  The params and
    moments are not held to the gradient tolerance: AdamW divides each
    element's gradient by its own RMS, so a gradient near rounding size
    (equal to 1e-4 on both sides, and so of any direction) moves its
    element by up to lr, and the second step's gradient is taken there."""
    jstats, stats, (jp, _, _), (p, _, _) = _two_steps(name)
    for i, (got, want) in enumerate(zip(stats, jstats)):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    moved = 2 * sum(s["lr"] for s in jstats)
    assert sorted(p) == sorted(jp)
    for key, w in jp.items():
        assert np.all(np.abs(p[key] - w) <= moved + 1e-6 * np.abs(w)), key


# --------------------------------------------------------------------------- #
# Wkv6's gradient
# --------------------------------------------------------------------------- #
def _wkv_inputs(seed, b, s, h, hd, floor):
    """r, k, v [B, S, H, hd], logw with decays down to ``floor`` nats a
    step, u [H, hd] (numpy)."""
    r, k, v = (_normal(seed + i, b, s, h, hd) for i in range(3))
    lo = np.log(-floor)
    logw = -np.exp(np.random.default_rng(seed + 3).uniform(
        -10.0, lo, (b, s, h, hd))).astype(np.float32)
    return r, k, v, logw, _normal(seed + 4, h, hd)


@pytest.mark.parametrize("hd,s,floor", [
    (16, 150, -np.exp(2.0)), (16, 150, -40.0), (64, 70, -np.exp(2.0)),
    (64, 97, -40.0)], ids=["hd16-clip", "hd16-past", "hd64-clip",
                          "hd64-past"])
def test_wkv6_backward_matches_jax_vjp_of_ref(hd, s, floor):
    """dr, dk, dv, dlogw and du through Wkv6 (the VJP of the plain chunked
    form, C 64) against ``jax.vjp`` of the reference's step-by-step
    ``wkv6_ref`` on the same inputs: S not a multiple of the chunk, decays
    down to the model's clip floor (-e^2 a step) and past it (-40),
    where a chunk's decay underflows.  u is shared by the batch, so its
    gradient is the batch's sum.  Within rtol 1e-4 plus atol 1e-5 of the
    leaf's largest: the same f32 sums in other orders."""
    b, h = 2, 3
    r, k, v, logw, u = _wkv_inputs(7, b, s, h, hd, floor)
    dy = _normal(12, b, s, h, hd)
    ins = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, logw, u)]
    y = Wkv6.apply(*ins)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))

    def bh(t):
        return jnp.asarray(t).transpose(0, 2, 1, 3).reshape(b * h, s, hd)

    def fn(r, k, v, logw, u):
        out = jref.wkv6_ref(bh(r), bh(k), bh(v), bh(logw),
                            jnp.broadcast_to(u, (b, h, hd)).reshape(b * h,
                                                                   hd))
        return out.reshape(b, h, s, hd).transpose(0, 2, 1, 3)
    want_y, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (r, k, v, logw, u)))
    want = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-4, atol=1e-5 * float(
                                   np.abs(want_y).max()))
    for name, g, w in zip("r k v logw u".split(), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_wkv6_gradients_keep_the_inputs_dtypes(monkeypatch):
    """bf16 r/k/v get bf16 gradients and the float32 logw and u float32
    ones, each the float32 VJP rounded once; the backward runs the plain
    version only (no wkv6 launch: ``_wkv`` is called by the forward
    alone)."""
    r, k, v, logw, u = _wkv_inputs(3, 1, 20, 2, 16, -5.0)
    calls = []
    real = wk._wkv

    def counting(*a):
        calls.append(1)
        return real(*a)
    monkeypatch.setattr(wk, "_wkv", counting)
    ins = [torch.from_numpy(x).to(dt).requires_grad_() for x, dt in
           zip((r, k, v, logw, u), (torch.bfloat16,) * 3
               + (torch.float32,) * 2)]
    y = Wkv6.apply(*ins)
    assert y.dtype == torch.bfloat16 and len(calls) == 1
    grads = torch.autograd.grad(y.float().sum(), ins)
    assert len(calls) == 1
    assert [g.dtype for g in grads] == [t.dtype for t in ins]
    f32 = [t.detach().float().requires_grad_() for t in ins]
    want = torch.autograd.grad(Wkv6.apply(*f32).sum(), f32)
    for g, w in zip(grads, want):
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("name", [LLAMA4, DEEPSEEK])
def test_moe_gradients_where_capacity_drops(name):
    """One MoE FFN of the reference's weights over 64 pooled tokens that
    lean toward expert 0 (+3 along its router column), so that it
    overflows its capacity: under autograd the port routes to the
    reference's experts and drops assignments, and the gradients of the
    tokens and of every weight (router, experts, shared experts) of
    sum(out * g) + aux match ``jax.grad`` of the reference's ``moe_mlp``
    within the leaf rule.  llama4's router is the exception: at top-1 the
    renormalised gate is v / v = 1, whose gradient is 0, and both sides
    leave its rounding (about 1e-4 of the router leaf's largest gradient)
    in the router's gradient, so that leaf is held only where deepseek's
    top-2 gives the renormalisation a gradient."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer
    jm, jp = _reference(name)
    m, params = _port(name, jp)
    cfg = m.cfg
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    tl = {k: v.detach().clone().requires_grad_() if torch.is_tensor(v)
          else {kk: vv.detach().clone().requires_grad_()
                for kk, vv in v.items()}
          for k, v in layer(params["layers"], 0)["mlp"].items()}
    col = np.asarray(jl["router"])[:, 0]
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 16, cfg.d_model))
         + 3.0 * col / np.linalg.norm(col)).astype(np.float32)
    g = _normal(12, 4, 16, cfg.d_model)

    def jfn(lp, xx):
        out, aux = jmoe.moe_mlp(lp, xx, JARCHS[name].reduced())
        return (out * g).sum() + aux
    jval, (jgl, jgx) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jl, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    with moe.record_routing() as calls:
        out, aux = moe.moe_mlp(tl, xt, cfg)
    val = (out * torch.from_numpy(g)).sum() + aux
    leaves = [xt] + [v for _, v in jax.tree_util.tree_leaves_with_path(tl)]
    grads = torch.autograd.grad(val, leaves)
    assert int(calls[0].dropped) > 0, "no assignment dropped: vacuous"
    logits = np.asarray(jnp.asarray(x).reshape(64, -1) @ jl["router"])
    want_idx = np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1),
                                        cfg.moe.top_k)[1])
    np.testing.assert_array_equal(calls[0].experts.numpy(), want_idx)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    want = [("x", np.asarray(jgx))] + [
        (jax.tree_util.keystr(k), np.asarray(v))
        for k, v in jax.tree_util.tree_leaves_with_path(jgl)]
    for got, (key, w) in zip(grads, want):
        if key == "['router']" and cfg.moe.top_k == 1:
            continue
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=key)


# --------------------------------------------------------------------------- #
# launches a step, serving, refusals
# --------------------------------------------------------------------------- #
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_calls_each_kernel_as_derived(name, monkeypatch):
    """One step's wrapper calls against ``chip_smoke.train_launches``,
    which the card's launch counters are held to: each product of a pass
    forward and twice backward, the layers' once more in their recompute;
    wkv6 twice a layer (the forward and the recompute), none in the
    backward; flash attention likewise (llama4; MLA runs none)."""
    calls = {"ina_matmul": 0, "flash_attention": 0, "wkv6": 0}

    def counted(mod, attr, key):
        real = getattr(mod, attr)

        def fn(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, attr, fn)
    counted(im, "ina_matmul", "ina_matmul")
    counted(fa, "_attention", "flash_attention")
    counted(wk, "_wkv", "wkv6")
    jm, jp = _reference(name)
    m, params = _port(name, jp)
    ts = build_train_step(m, ShapeConfig("t", S, B, "train"))
    ts.fn(params, adamw.adamw_init(params),
          _torch_batch(_batch(6, m.cfg.vocab)))
    assert calls == _chip_smoke().train_launches(m.cfg)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_without_grad_takes_no_function(name, monkeypatch):
    """Serving and ``build_prefill`` (no tensor requires a gradient) call
    the wrappers straight: no autograd Function and no checkpoint, and the
    logits are the same bits as before any training ran."""
    m = get_model(ARCHS[name].reduced())
    params = m.init(device="cpu")
    tokens = torch.from_numpy(_batch(2, m.cfg.vocab, 1, 12)["tokens"]).long()
    want = m.forward(params, {"tokens": tokens})
    for fn in (InaMatmul, FlashAttention, Wkv6):
        monkeypatch.setattr(fn, "apply", None)
    monkeypatch.setattr(transformer, "checkpoint", None)
    assert torch.equal(m.forward(params, {"tokens": tokens}), want)


def test_trained_families():
    """Every family the reference trains, the port trains: a step builds
    for every config (the refusal of item 5.7 is gone)."""
    shape = ShapeConfig("t", 8, 2, "train")
    for cfg in ARCHS.values():
        assert build_train_step(get_model(cfg.reduced()), shape).shape \
            == shape, cfg.name


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "whisper-medium",
                                  "zamba2-2.7b"])
def test_untrained_families_name_item_5_7(name):
    """The families item 5.7 ported (hybrid, vlm, encdec) train: one step
    of the reduced model from its own seeded masters, with media of ones
    where the family reads them, lowers nothing to NaN, and a second step
    on the same batch has a lower loss."""
    from repro_torch.models.api import media_ones
    m = get_model(ARCHS[name].reduced())
    params = m.init(torch.Generator().manual_seed(0), device="cpu",
                    masters=True)
    ts = build_train_step(m, ShapeConfig("t", 8, 2, "train"), base_lr=1e-2,
                          warmup=1, total_steps=10)
    batch = {**_torch_batch(_batch(4, m.cfg.vocab, 2, 8)),
             **media_ones(m.cfg, 2, "cpu")}
    opt = adamw.adamw_init(params)
    losses = []
    for _ in range(2):
        params, opt, st = ts.fn(params, opt, batch)
        losses.append(float(st["loss"]))
    assert all(np.isfinite(losses)) and losses[1] < losses[0]


# --------------------------------------------------------------------------- #
# the data axis's cuts against the reference's specs
# --------------------------------------------------------------------------- #
def _reference_data_dims(name: str) -> dict:
    """{names: the dim where the reference's param_specs, fitted to the
    (data 2, model 2) mesh as its build_train_step fits them, place
    ``data``, or None}."""
    jm, jp = _reference(name)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    specs = jparam_specs(jp, mesh)
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        spec = specs
        for p in path:
            spec = spec[p.key]
        fitted = jfit_spec(spec, leaf.shape, mesh)
        names = tuple(p.key for p in path)
        out[names] = next((i for i, e in enumerate(fitted) if e == "data"
                           or (isinstance(e, tuple) and "data" in e)), None)
    return out


@pytest.mark.parametrize("name", FAMILIES + (
    "zamba2-2.7b", "llama-3.2-vision-11b", "whisper-medium"))
def test_data_cut_is_where_the_reference_places_data(name):
    """Every leaf's ``data_cut`` at ``(data 2, model 2)`` is the dim where
    the reference places ``data``, where 2 data ranks divide that dim of
    the rank's model shard, else None (held whole over ``data``): the
    expert weights [L, E, D, F] and [L, E, F, D] on their second dim after
    E, never L; zamba2's ``groups`` [G, per, ...] past both stack axes
    (Mamba2's packed ``w_in`` on D, its segments cut over ``model`` on
    the last dim), the vlm's ``xlayers`` and whisper's ``enc_layers`` and
    ``dec_layers`` past L, and whisper's ``pos_dec`` on its rows."""
    cfg = ARCHS[name].reduced()
    want = _reference_data_dims(name)
    shards = sharding.shard_params(
        get_model(cfg).init(device="meta", masters=True), cfg, 0, 2)
    got = {}
    for names, dim in want.items():
        got[names] = sharding.data_cut(names, cfg, (2, 2))
        leaf = shards
        for n in names:
            leaf = leaf[n]
        if dim is not None and leaf.shape[dim] % 2:
            dim = None
        assert got[names] == dim, names
    if cfg.moe is not None:
        assert got[("layers", "mlp", "w_gate")] == 2
        assert got[("layers", "mlp", "w_down")] == 2
    named = {"zamba2-2.7b": {("groups", "mamba", "w_in"): 2,
                             ("groups", "mamba", "w_out"): 3},
             "llama-3.2-vision-11b": {("xlayers", "xattn", "wq"): 1,
                                      ("groups", "mlp", "w_down"): 3},
             "whisper-medium": {("dec_layers", "xattn", "wk"): 1,
                                ("enc_layers", "mlp", "w_down"): 2,
                                ("pos_dec",): 0}}.get(name, {})
    for names, dim in named.items():
        assert got[names] == dim, names


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
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wkv6_backward_on_card(cuda, dtype):
    """rwkv6-7b's hd 64 at B 2 x S 200 (past a chunk of 64, ragged): the
    forward launches the kernel once and the backward none; the gradients
    against the same VJP taken on the CPU, whose forward is the plain
    version (the kernel's f32 sums run in another order, then each side
    rounds to the inputs' dtypes once: rtol 1e-4 plus atol 1e-5 of the
    leaf's largest in float32, one bf16 ulp in bf16)."""
    dt = getattr(torch, dtype)
    r, k, v, logw, u = _wkv_inputs(5, 2, 200, 4, 64, -np.exp(2.0))
    dy = torch.from_numpy(_normal(9, 2, 200, 4, 64))
    dts = (dt,) * 3 + (torch.float32,) * 2
    grads = []
    for dev in (cuda, "cpu"):
        ins = [torch.from_numpy(x).to(dev, t).requires_grad_()
               for x, t in zip((r, k, v, logw, u), dts)]
        before = wk.launches
        y = Wkv6.apply(*ins)
        grads.append(torch.autograd.grad(y, ins, dy.to(dev, dt)))
        if dev == cuda:
            torch.cuda.synchronize()
            assert wk.launches - before == 1
    tol = (1e-4, 1e-5) if dtype == "float32" else (2 ** -7, 2 ** -7)
    for got, want in zip(*grads):
        want = want.float()
        torch.testing.assert_close(got.cpu().float(), want, rtol=tol[0],
                                   atol=tol[1] * float(want.abs().max()))
