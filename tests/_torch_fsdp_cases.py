"""The cases of ``tests/test_torch_fsdp_*.py``: FSDP training of the
non-dense families' reduced configs (float32) on the ``(data 2, model 1)``
and ``(pod 2, data 2, model 1)`` meshes of ``tests/test_torch_dp_train.py``
(its ``(data 2, model 2)`` runs in ``tests/test_torch_tp_train_families.py``
and ``..._hybrid_media.py``), one gloo spawn a mesh with every family of a
file inside it (``_torch_dist_workers.dp_train_rank``), B 4 x S 16.

Each rank holds its FSDP piece and gathers each checkpointed unit's pieces
inside the unit's checkpointed body (a layer; zamba2's and the vlm's
group), the leaves outside the units once a step; zamba2's ``inv_norms``
[G, D] is cut on its stacked G at data 2 (each group's row on one data
rank) and gathered with the leaves outside.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import sharding
from repro_torch.parallel.steps import build_train_step

import _torch_dist_workers as W

MESHES = {"d2": ((2, 1), ("data", "model")),
          "p2d2": ((2, 2, 1), ("pod", "data", "model"))}
B, S = 4, 16
SCHEDULE = {"base_lr": 3e-4, "warmup": 1, "total_steps": 10}
GATES = {"gate_attn": 0.7, "gate_mlp": -0.4}
MODE = "ina"


def _batch(rng, cfg) -> tuple:
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = (toks[:, :-1], toks[:, 1:])
    if cfg.num_media_tokens:
        out += (rng.standard_normal((B, cfg.num_media_tokens, cfg.d_model))
                .astype(np.float32),)
    return out


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@functools.cache
def reference(arch: str):
    """The reference's params (numpy; RWKV6's ``u`` and the vlm's gates
    seeded nonzero), batches, and its unsharded loss and gradients on the
    first batch."""
    jm = jget_model(JARCHS[arch].reduced())
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    if jm.cfg.family == "ssm":
        u = jp["layers"]["tmix"]["u"]
        jp["layers"]["tmix"]["u"] = jnp.asarray(
            0.5 * rng.standard_normal(u.shape).astype(np.float32))
    if jm.cfg.family == "vlm":
        for k, v in GATES.items():
            jp["xlayers"][k] = jnp.full_like(jp["xlayers"][k], v)
    grad_batch = _batch(rng, jm.cfg)
    batch = dict(zip(("tokens", "labels", "media"), grad_batch))
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, batch))(jp)
    spec = {"params": jax.tree.map(np.asarray, jp), "grad_batch": grad_batch,
            "step_batches": [_batch(rng, jm.cfg) for _ in range(2)]}
    return spec, float(jloss), _named(jgrads)


@functools.cache
def port(name: str, archs: tuple) -> list:
    spec = {"mesh": MESHES[name],
            "archs": {a: reference(a)[0] for a in archs},
            "cases": {MODE: {"psum_mode": MODE}}, "schedule": SCHEDULE}
    return mesh.spawn(W.dp_train_rank, mesh.RankMesh(*MESHES[name]).size,
                      "cpu", args=(spec,))


@functools.cache
def one_rank(arch: str) -> dict:
    """The groupless step on the whole batches: two steps' loss,
    grad_norm and lr, and the params and moments after them."""
    spec, _, _ = reference(arch)
    cfg = ARCHS[arch].reduced()
    model = get_model(cfg)
    params = params_from_jax(spec["params"], cfg, device="cpu", masters=True)
    ts = build_train_step(model, ShapeConfig("t", S, B, "train"), **SCHEDULE)
    opt, steps = adamw_init(params), []
    for pair in spec["step_batches"]:
        params, opt, st = ts.fn(params, opt, W._batch(pair))
        steps.append({k: float(st[k]) for k in ("loss", "grad_norm", "lr")})
    return {"steps": steps, "params": W._numpy(params),
            "m": W._numpy(opt.m), "v": W._numpy(opt.v)}


def _pod0(name: str, archs: tuple, arch: str) -> list:
    """The ranks of pod 0 (one ``(D, 1)`` world), their results."""
    return [r[arch] for r in port(name, archs)
            if r[arch]["coords"]["pod"] == 0]


def _unshard(name: str, archs: tuple, arch: str, key: str) -> dict:
    ranks = _pod0(name, archs, arch)
    return _named(sharding.unshard_params([r[MODE][key] for r in ranks],
                                          ARCHS[arch].reduced(),
                                          (len(ranks), 1)))


def _assert_leaves_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=key)


def units(cfg) -> int:
    """The checkpointed units of a forward: a layer (of each stack), a
    group for zamba2 and the vlm."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_every
    if cfg.family == "encdec":
        return cfg.encoder_layers + cfg.n_layers
    return cfg.n_layers


# --------------------------------------------------------------------------- #
# the checks each test file runs for its families
# --------------------------------------------------------------------------- #
def check_grads(name: str, archs: tuple, arch: str) -> None:
    """Every rank's loss of the global batch, and the gradient rebuilt from
    pod 0's pieces, against ``jax.value_and_grad`` of the reference on the
    whole batch (loss rtol 1e-5, each leaf rtol 1e-4 plus atol 1e-5 of its
    largest); pod 1's pieces bit-equal to pod 0's."""
    _, jloss, jgrads = reference(arch)
    ranks = [r[arch] for r in port(name, archs)]
    for r in ranks:
        np.testing.assert_allclose(r[MODE]["loss"], jloss, rtol=1e-5)
    _assert_leaves_close(_unshard(name, archs, arch, "grads"), jgrads)
    by_data = {}
    for r in ranks:
        got = _named(r[MODE]["grads"])
        want = by_data.setdefault(r["coords"]["data"], got)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def check_steps(name: str, archs: tuple, arch: str) -> None:
    """Two AdamW steps against the groupless step on the whole batches:
    loss and ``grad_norm`` rtol 1e-5, the moments within the gradient's
    leaf tolerance (``sqrt(v)``), every param within AdamW's bound (lr a
    step) plus that tolerance (``tests/test_torch_tp_train_families.py``'s
    ``_held_to_one_rank``)."""
    one = one_rank(arch)
    for r in port(name, archs):
        for got, want in zip(r[arch][MODE]["steps"], one["steps"]):
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    got = {k: _unshard(name, archs, arch, k) for k in ("m", "v", "params")}
    _assert_leaves_close(got["m"], _named(one["m"]))
    _assert_leaves_close({k: np.sqrt(v) for k, v in got["v"].items()},
                         {k: np.sqrt(v) for k, v in
                          _named(one["v"]).items()})
    moved = 2 * sum(s["lr"] for s in one["steps"])
    for key, w in _named(one["params"]).items():
        atol = 1e-5 * float(np.abs(w).max())
        assert np.all(np.abs(got["params"][key] - w) <= moved + atol), key


def check_gathers(name: str, archs: tuple, arch: str) -> None:
    """One gradient's FSDP gathers: the leaves outside the units once,
    then each unit's pieces in its forward and again in its recompute
    (1 + 2 U all-gathers); the most gathered bytes alive at once is at
    most the outside leaves plus two units' whole weights, at least the
    outside leaves plus one unit, and, where there are more than two
    units, less than all of them (the whole model shard, which a step
    held at once before the gather went inside the layers)."""
    u = units(ARCHS[arch].reduced())
    for r in port(name, archs):
        g = r[arch][MODE]["gathered"]
        outside, unit = g["calls"][0], g["calls"][1:]
        assert len(unit) == 2 * u and sorted(unit[:u]) == sorted(unit[u:])
        assert outside + max(unit) <= g["peak"] <= outside + 2 * max(unit)
        if u > 2:
            assert g["peak"] < outside + sum(unit[:u])
