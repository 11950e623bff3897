"""The cases of ``tests/test_torch_remat_*.py``: one train step of each
family's reduced config under each remat policy, in the port and in the
JAX package, on the same weights and batch (float32, on the CPU).

Weights come from the reference (``Model.init(jax.random.PRNGKey(3))``;
qwen2's zero QKV biases, RWKV6's zero bonus ``u`` and the vlm's zero tanh
gates replaced by seeded values, as the families' train tests do) and
reach the port as float32 masters through ``params_from_jax(masters=True)``.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ina_matmul as im
from repro_torch.kernels import wkv6 as wk
from repro_torch.core import remat as tape
from repro_torch.models import remat
from repro_torch.models.api import get_model
from repro_torch.parallel.steps import loss_and_grads

POLICIES = ("dots", "dots_nb")
B, S = 2, 40
GATES = {"gate_attn": 0.7, "gate_mlp": -0.4}
ROOT = Path(__file__).resolve().parents[1]
#: each plain product site's kind (``models.remat``'s classification)
SITE_KINDS = {"ina": "nb", "router": "nb", "lora": "nb",
              "experts": "batched", "combine": "batched",
              "mla_attn": "batched", "ssd": "batched",
              "flash": "fused", "wkv6": "fused"}


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cfg(name: str, policy: str):
    return dataclasses.replace(ARCHS[name].reduced(), remat_policy=policy)


@functools.cache
def reference_params(name: str):
    jcfg = JARCHS[name].reduced()
    jp = jget_model(jcfg).init(jax.random.PRNGKey(3))
    if "layers" in jp and "attn" in jp["layers"]:
        attn = dict(jp["layers"]["attn"])
        for i, b in enumerate(("bq", "bk", "bv")):
            if b in attn:
                attn[b] = jnp.asarray(0.1 * _normal(40 + i, *attn[b].shape))
        jp = {**jp, "layers": {**jp["layers"], "attn": attn}}
    if jcfg.family == "ssm":
        tmix = dict(jp["layers"]["tmix"])
        tmix["u"] = jnp.asarray(0.5 * _normal(41, *tmix["u"].shape))
        jp = {**jp, "layers": {**jp["layers"], "tmix": tmix}}
    if jcfg.family == "vlm":
        xl = {**jp["xlayers"], **{k: jnp.full_like(jp["xlayers"][k], v)
                                  for k, v in GATES.items()}}
        jp = {**jp, "xlayers": xl}
    return jp


def batch(cfg, seed: int = 5) -> dict:
    """tokens, labels and, where the family reads them, media (numpy)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.num_media_tokens:
        out["media"] = rng.standard_normal(
            (B, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) if k == "media"
            else torch.from_numpy(np.array(v)).long() for k, v in b.items()}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@functools.cache
def port_step(name: str, policy: str) -> dict:
    """The port's loss and gradient (tensors, by path) under ``policy``,
    each kernel wrapper's calls in the step, and the products
    :data:`repro_torch.core.remat.RECOMPUTED` counts in the recompute."""
    cfg = _cfg(name, policy)
    m = get_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray,
                                          reference_params(name)), cfg,
                             device="cpu", masters=True)
    calls = {"ina_matmul": 0, "flash_attention": 0, "wkv6": 0}
    patched = []
    for mod, attr, key in ((im, "ina_matmul", "ina_matmul"),
                           (fa, "_attention", "flash_attention"),
                           (wk, "_wkv", "wkv6")):
        real = getattr(mod, attr)

        def fn(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        setattr(mod, attr, fn)
        patched.append((mod, attr, real))
    tape.RECOMPUTED.clear()
    try:
        loss, grads = loss_and_grads(m, params, _torch_batch(batch(cfg)))
    finally:
        for mod, attr, real in patched:
            setattr(mod, attr, real)
    return {"loss": loss, "grads": dict(_leaves(grads)), "calls": calls,
            "recomputed": dict(tape.RECOMPUTED)}


@functools.cache
def reference_step(name: str, policy: str):
    """``jax.value_and_grad`` of the reference's loss under ``policy``:
    (loss, gradients by path, numpy)."""
    jcfg = dataclasses.replace(JARCHS[name].reduced(), remat_policy=policy)
    jm = jget_model(jcfg)
    b = batch(jcfg)
    loss, grads = jax.value_and_grad(lambda p: jm.loss(p, b))(
        reference_params(name))
    return float(loss), {tuple(k.key for k in p): np.asarray(v, np.float32)
                         for p, v in jax.tree_util.tree_leaves_with_path(
                             grads)}


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def products_per_step(cfg) -> dict:
    """Each site's product calls in the checkpointed layers of one
    forward, derived from the code (the recompute under ``nothing`` runs
    them all: its early stop comes only after a layer's last product, and
    a product's node saves its operands).  The INA projections and flash
    attention as :func:`chip_smoke.matmuls_per_pass` and
    :func:`chip_smoke.flash_per_pass` count them, the head outside; RWKV6:
    wkv6 and the two LoRA products a layer; an MoE layer: the router, the
    experts' three ``bmm`` and the combine; MLA: the scores and PV einsums
    (``attn_full``: S does not pass ``attn_chunk``, or it does not divide
    S) or the two of each KV chunk; Mamba2: the SSD's four einsums a
    layer."""
    cs = chip_smoke()
    n = {"ina": cs.matmuls_per_pass(cfg) - 1,
         "flash": cs.flash_per_pass(cfg)}
    if cfg.family == "ssm":
        n.update(wkv6=cfg.n_layers, lora=2 * cfg.n_layers)
    if cfg.family in ("moe", "mla_moe"):
        moe = cfg.n_layers - cfg.moe.first_dense_layers
        n.update(router=moe, experts=3 * moe, combine=moe)
    if cfg.family == "mla_moe":
        c = cfg.attn_chunk
        chunks = S // c if c and S > c and S % c == 0 else 1
        n["mla_attn"] = 2 * chunks * cfg.n_layers
    if cfg.family == "hybrid":
        n["ssd"] = 4 * cfg.n_layers
    return {k: v for k, v in n.items() if v}


def expected_recompute(cfg) -> dict:
    """The recompute's product calls under ``cfg.remat_policy``: every
    site of :func:`products_per_step` but those whose kind it keeps."""
    keep = remat.POLICIES[cfg.remat_policy]
    return {site: n for site, n in products_per_step(cfg).items()
            if SITE_KINDS[site] not in keep}


# --------------------------------------------------------------------------- #
# the checks each test file runs for its families
# --------------------------------------------------------------------------- #
def check_matches_reference(name: str, policy: str) -> None:
    """Within 1e-4 of ``jax.value_and_grad`` under the same policy (the
    families' train tests' rule: loss rtol 1e-5, each leaf rtol 1e-4 plus
    atol 1e-5 of its largest magnitude)."""
    jloss, jgrads = reference_step(name, policy)
    got = port_step(name, policy)
    np.testing.assert_allclose(float(got["loss"]), jloss, rtol=1e-5)
    grads = {k: v.detach().float().numpy() for k, v in got["grads"].items()}
    assert sorted(grads) == sorted(jgrads)
    for key, w in jgrads.items():
        assert grads[key].shape == w.shape, key
        np.testing.assert_allclose(grads[key], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=str(key))


def check_bit_equal_to_nothing(name: str, policy: str) -> None:
    want, got = port_step(name, "nothing"), port_step(name, policy)
    assert torch.equal(got["loss"], want["loss"])
    assert sorted(got["grads"]) == sorted(want["grads"])
    for key, g in want["grads"].items():
        assert torch.equal(got["grads"][key], g), key


def check_calls_as_derived(name: str, policy: str) -> None:
    """The step's kernel calls against ``chip_smoke.train_launches`` (the
    card's counters are held to it) and the recompute's product calls
    against :func:`expected_recompute`."""
    cfg = _cfg(name, policy)
    got = port_step(name, policy)
    assert got["calls"] == chip_smoke().train_launches(cfg)
    assert got["recomputed"] == expected_recompute(cfg)
