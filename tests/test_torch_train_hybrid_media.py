"""Training the hybrid (zamba2-2.7b), vlm (llama-3.2-vision-11b) and encdec
(whisper-medium) families in the port, against the JAX package's, on
reduced configs in float32 on the CPU, at one rank.

Weights come from the reference (``Model.init(jax.random.PRNGKey(3))``)
and reach the port as float32 masters through
``params_from_jax(masters=True)``.  The vlm's tanh gates are set to 0.7
and -0.4 in the reference's tree before both sides read it: at the
reference's init they are 0, which zeroes every cross-attention weight's
gradient, and a comparison of zeros proves nothing.  Batches (tokens,
labels and, for the vlm and whisper, media [B, M, D]) come from numpy and
go to both.  On CPU tensors the kernels' ``autograd.Function`` wrappers
run their plain versions, so these tests exercise the backward the card
runs.

* The loss and every gradient leaf against ``jax.value_and_grad`` of the
  reference's ``loss`` (``tests/test_torch_train.py``'s rule: loss rtol
  1e-5, each leaf rtol 1e-4 plus atol 1e-5 of its largest magnitude).
* Two AdamW steps through ``build_train_step`` against the reference's
  ``build_train_step`` on a host mesh of one device, media in the batch.
* No stacked leaf reaches autograd whole: zamba2's ``groups`` is split on
  both of its stack axes and restacked to ``[G, per, ...]``.
* A step's kernel calls against ``chip_smoke.train_launches``, serving
  untouched (no Function, no checkpoint; the remat policies:
  ``tests/test_torch_remat_*.py``), and the launcher on ``--device
  cpu``: a run that checkpoints, and a second that resumes to the bit.
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
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.models.api import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.parallel.steps import build_train_step as jbuild_train_step

from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ina_matmul as im
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.ina_matmul import InaMatmul
from repro_torch.launch import train as launch_train
from repro_torch.models import layers, transformer
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.parallel import steps
from repro_torch.parallel.steps import build_train_step, loss_and_grads

HYBRID, VLM, ENCDEC = "zamba2-2.7b", "llama-3.2-vision-11b", "whisper-medium"
FAMILIES = (HYBRID, VLM, ENCDEC)
B, S = 2, 40
GATES = {"gate_attn": 0.7, "gate_mlp": -0.4}
ROOT = Path(__file__).resolve().parents[1]


def _batch(seed, cfg, b=B, s=S):
    """tokens, labels and, where the family reads them, media (numpy)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.num_media_tokens:
        out["media"] = rng.standard_normal(
            (b, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) if k == "media"
            else torch.from_numpy(np.array(v)).long()
            for k, v in batch.items()}


@functools.cache
def _reference(name: str):
    """(reference model, its params), the vlm's gates nonzero."""
    jm = jget_model(JARCHS[name].reduced())
    jp = jm.init(jax.random.PRNGKey(3))
    if name == VLM:
        xl = {**jp["xlayers"], **{k: jnp.full_like(jp["xlayers"][k], v)
                                  for k, v in GATES.items()}}
        jp = {**jp, "xlayers": xl}
    return jm, jp


def _port(name: str, jp):
    cfg = ARCHS[name].reduced()
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(JARCHS[name].reduced())
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
    """float32 on both sides, summed in other orders (the port batches the
    SSD's chunks and runs flash's plain version where the reference
    scans and einsums), so each leaf within rtol 1e-4 plus atol 1e-5 of
    its largest gradient; every leaf nonzero: the shared block (used by
    every group) and ``inv_norms``, the cross-attention's ``wk``/``wv``
    over the media, ``k_norm`` and the gates, whisper's ``pos_dec`` rows
    past S excepted (no token reads them)."""
    jm, jp = _reference(name)
    m, params = _port(name, jp)
    batch = _batch(5, m.cfg)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, batch))(jp)
    loss, grads = loss_and_grads(m, params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _named(jgrads)
    _assert_leaves_close(_port_named(grads), want)
    for key, g in want.items():
        if key == "['pos_dec']":
            g = g[:S]
        assert np.abs(g).max() > 0, key


@functools.cache
def _two_steps(name: str):
    """The reference's and the port's train steps, warmup 1, over the same
    two numpy batches (media in them for the vlm and whisper): the
    per-step stats of each, and the params after them of each."""
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
        batch = _batch(100 + i, m.cfg)
        jp, jopt, jst = jts.fn(jp, jopt, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        params, opt, st = ts.fn(params, opt, _torch_batch(batch))
        jstats.append({k: float(v) for k, v in jst.items()})
        stats.append({k: float(v) for k, v in st.items()})
    return jstats, stats, _named(jp), _port_named(params)


@pytest.mark.parametrize("name", FAMILIES)
def test_two_adamw_steps_match_reference(name):
    """Loss, grad_norm and lr of both steps within rtol 1e-4, and every
    param within AdamW's bound of the reference's after them (each update
    moves an element by at most lr, on both sides:
    ``tests/test_torch_train_families.py`` says why no tighter)."""
    jstats, stats, jp, p = _two_steps(name)
    for i, (got, want) in enumerate(zip(stats, jstats)):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    moved = 2 * sum(s["lr"] for s in jstats)
    assert sorted(p) == sorted(jp)
    for key, w in jp.items():
        assert np.all(np.abs(p[key] - w) <= moved + 1e-6 * np.abs(w)), key


def test_ssd_gradient_is_finite_past_exp_range():
    """A chunk whose decay over its length passes exp's float32 range
    (zamba2's 256-token chunk at dt ~ 0.7 a step decays ~180 nats; here 128
    tokens at 1 nat a step): the SSD's output and its gradients are
    finite and within 1e-4 of the same function in float64 with the
    masked ratios zeroed before ``exp``, where the reference's form,
    ``where(mask, exp(ratio), 0)``, gives the same output and a NaN
    gradient (0 * exp(inf))."""
    from repro_torch.models import ssm
    cfg = dataclasses.replace(ARCHS[HYBRID].reduced(), ssm=dataclasses.replace(
        ARCHS[HYBRID].reduced().ssm, chunk=128))
    rng = np.random.default_rng(4)
    b, nc, c, h, hd, n = 1, 1, 128, 2, 4, 3
    ins = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((b, nc, c, h, hd)), rng.standard_normal(
            (b, nc, c, n)), rng.standard_normal((b, nc, c, n)),
        -np.ones((b, nc, c, h)), np.full((b, nc, c, h), 0.5))]
    state = torch.zeros(b, h, hd, n)

    def run(xs, dtype, zeroed):
        xs = [t.to(dtype).requires_grad_() for t in xs]
        if not zeroed:
            _, y = ssm._ssd_chunks(state.to(dtype), tuple(xs), cfg)
        else:
            x, bm, cm, logdec, dt = xs
            cum = torch.cumsum(logdec, dim=2)
            ratio = cum[:, :, :, None, :] - cum[:, :, None, :, :]
            mask = torch.ones(c, c, dtype=torch.bool).tril()[:, :, None]
            dec = torch.where(mask, torch.exp(torch.where(mask, ratio, 0.0)),
                              0.0)
            scores = torch.einsum("bctn,bcsn->bcts", cm, bm)[..., None] \
                * dec * dt[:, :, None]
            y = torch.einsum("bctsh,bcshd->bcthd", scores, x)
        g = torch.autograd.grad((y * y).sum(), xs)
        return y.detach(), g
    y, grads = run(ins, torch.float32, False)
    want_y, want = run(ins, torch.float64, True)
    x, bm, cm, logdec, dt = ins
    cum = torch.cumsum(logdec, dim=2)
    ratio = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    assert not torch.isfinite(torch.exp(ratio)).all()
    torch.testing.assert_close(y.double(), want_y, rtol=1e-4, atol=1e-4)
    for g, w in zip(grads, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.double(), w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


# --------------------------------------------------------------------------- #
# the stacks reach autograd a layer at a time
# --------------------------------------------------------------------------- #
def _split(node, shape, axes) -> int:
    """The number of per-layer tensors in ``node``, asserted to be nested
    lists over the ``axes`` leading dims of ``shape`` of tensors of the
    rest."""
    if axes == 0:
        assert torch.is_tensor(node) and tuple(node.shape) == tuple(shape)
        return 1
    assert isinstance(node, list) and len(node) == shape[0]
    return sum(_split(n, shape[1:], axes - 1) for n in node)


@pytest.mark.parametrize("name", FAMILIES)
def test_no_stacked_leaf_reaches_autograd_whole(name):
    """``_grad_leaves`` splits every stacked key (``layers.STACK_AXES``) on
    all of its stack axes: each leaf autograd differentiates is one
    layer's slice (zamba2's ``groups`` a list of G lists of ``per``), and
    the gradients come back in the params' structure, shapes and dtypes,
    ``groups`` as [G, per, ...]."""
    m = get_model(ARCHS[name].reduced())
    params = m.init(device="cpu", masters=True)
    work, leaves = steps._grad_leaves(params)
    count = 0
    for path, p in jax.tree_util.tree_leaves_with_path(params):
        names = [k.key for k in path]
        node = work
        for n in names:
            node = node[n]
        count += _split(node, p.shape, layers.STACK_AXES.get(names[0], 0))
    assert len(leaves) == count
    assert {k for k in params if k in layers.STACK_AXES} == {
        HYBRID: {"groups", "inv_norms"}, VLM: {"groups", "xlayers"},
        ENCDEC: {"enc_layers", "dec_layers"}}[name]
    _, grads = loss_and_grads(m, params, _torch_batch(_batch(1, m.cfg, 1,
                                                             8)))
    for (path, g), (_, p) in zip(
            jax.tree_util.tree_leaves_with_path(grads),
            jax.tree_util.tree_leaves_with_path(params)):
        assert g.shape == p.shape and g.dtype == p.dtype, path


# --------------------------------------------------------------------------- #
# launches a step, serving, refusals, the launcher
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
    forward and twice backward (dX and dW), the checkpointed units' once
    more in their recompute, the vlm's ``wk``/``wv`` over the media
    without a dX (the media take no gradient); flash attention forward
    and recomputed, none in its backward."""
    calls = {"ina_matmul": 0, "flash_attention": 0, "wkv6": 0}

    def counted(mod, attr, key):
        real = getattr(mod, attr)

        def fn(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, attr, fn)
    counted(im, "ina_matmul", "ina_matmul")
    counted(fa, "_attention", "flash_attention")
    jm, jp = _reference(name)
    m, params = _port(name, jp)
    ts = build_train_step(m, ShapeConfig("t", S, B, "train"))
    ts.fn(params, adamw.adamw_init(params), _torch_batch(_batch(6, m.cfg)))
    assert calls == _chip_smoke().train_launches(m.cfg)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_without_grad_takes_no_function(name, monkeypatch):
    """Serving and ``build_prefill`` (no tensor requires a gradient) call
    the wrappers straight: no autograd Function and no checkpoint, and the
    logits are the same bits as before any training ran."""
    m = get_model(ARCHS[name].reduced())
    params = m.init(device="cpu")
    batch = _torch_batch(_batch(2, m.cfg, 1, 12))
    del batch["labels"]
    want = m.forward(params, batch)
    for fn in (InaMatmul, FlashAttention):
        monkeypatch.setattr(fn, "apply", None)
    monkeypatch.setattr(transformer, "checkpoint", None)
    assert torch.equal(m.forward(params, batch), want)


@pytest.mark.parametrize("name", FAMILIES)
def test_launcher_trains_and_resumes_to_the_bit(name, tmp_path, capsys):
    """``launch.train --reduced --device cpu`` (media of ones in the batch
    for the vlm and whisper): 4 steps lower the loss and checkpoint at
    step 2; a second run into the same directory resumes at step 3, whose
    loss equals the first run's to the bit.  A depth that is not a whole
    number of zamba2's or the vlm's groups raises before a step."""
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--lr", "1e-2", "--ckpt-every", "2", "--steps",
            "4", "--ckpt-dir", str(tmp_path / "ck")]
    first = launch_train.main(argv)
    assert first["steps"] == [0, 1, 2, 3]
    assert first["losses"][-1] < first["losses"][0]
    assert latest_step(str(tmp_path / "ck")) == 2
    second = launch_train.main(argv)
    assert second["steps"] == [3] and second["last"] == 4
    assert second["losses"][0] == first["losses"][3]
    params, opt = second["state"]
    assert int(opt.step) == 4
    if name != ENCDEC:
        with pytest.raises(ValueError, match="groups of"):
            launch_train.main(argv + ["--layers", "3"])
    out = capsys.readouterr().out
    assert out.count("[train] done at step") == 2
