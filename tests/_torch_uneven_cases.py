"""The uneven head cut's cases for ``tests/test_torch_tp.py`` (dense) and
``tests/test_torch_tp_families.py`` (moe): a reduced config set to a head
count that world 4 does not divide, run in each file's existing world-4
gloo spawn (``_torch_dist_workers.uneven_rank``) and held against the
reference's unsharded model.

At 6 query and 2 KV heads, world 4 gives ranks 0-2 two query heads each
(rank 1's heads 2 and 3 read KV heads 0 and 1: one KV head a query head)
and rank 3 none.  At 10 query heads each rank has three slots: rank 1's
heads 3-5 read KV heads 0, 0 and 1, so its K/V are expanded to one head
a query head (``sharding.kv_index``), and rank 3 holds head 9 alone.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import sharding
from repro_torch.parallel.steps import build_train_step

WORLD = 4
B, S, MAX_SEQ, DECODE = 2, 8, 16, 3
TOL = dict(rtol=1e-4, atol=1e-4)
#: label -> query heads (2 KV heads)
HEADS = {"6:2": 6, "10:2": 10}
SCHEDULE = dict(base_lr=1e-2, warmup=1, total_steps=10)
PROMPTS = ((5, 9, 11, 3, 7, 2), (8, 8, 1, 4, 6, 10), (12, 3, 3, 9, 1, 5))
GEN = 4
#: what each rank's results are held to
PHASES = ("forward", "decode", "grad", "engine")


def config(arch: str, heads: int) -> dict:
    return {"n_heads": heads, "n_kv_heads": 2}


@functools.cache
def reference(arch: str, label: str):
    """(the rank function's spec for ``label``, the reference's unsharded
    forward logits, decode logits, loss and gradients by key path)."""
    fields = config(arch, HEADS[label])
    jm = jget_model(dataclasses.replace(JARCHS[arch].reduced(), **fields))
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(1)
    vocab = jm.cfg.vocab
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    dec = [rng.integers(0, vocab, (B,)).astype(np.int32)
           for _ in range(DECODE)]
    want = {"forward": np.asarray(jm.forward(
        jp, {"tokens": jnp.asarray(toks[:, :-1])})), "decode": []}
    jc = jm.init_cache(B, MAX_SEQ)
    for pos, tok in enumerate(dec):
        logits, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tok[:, None]),
                                         "pos": jnp.asarray(pos, jnp.int32)},
                                    jc)
        want["decode"].append(np.asarray(logits))
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    loss, grads = jax.value_and_grad(lambda p: jm.loss(p, batch))(jp)
    want["loss"] = float(loss)
    want["grads"] = named(grads)
    spec = {"arch": arch, "config": fields,
            "params": jax.tree.map(np.asarray, jp), "tokens": toks[:, :-1],
            "labels": toks[:, 1:], "decode_tokens": dec,
            "max_seq": MAX_SEQ, "schedule": SCHEDULE, "prompts": PROMPTS,
            "gen": GEN}
    return spec, want


def named(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def specs(arch: str) -> dict:
    return {f"{arch} {label}": reference(arch, label)[0] for label in HEADS}


def port_config(arch: str, label: str):
    return dataclasses.replace(ARCHS[arch].reduced(),
                               **config(arch, HEADS[label]))


def _keyed(tree, path: str = "") -> dict:
    """A port tree (nested dicts of arrays) keyed as :func:`named` keys
    the reference's."""
    out = {}
    for k, v in tree.items():
        key = f"{path}[{k!r}]"
        out.update(_keyed(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v, np.float32)})
    return out


def assert_leaves_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=key)


def check(arch: str, label: str, phase: str, ranks: list) -> None:
    """Every rank's forward or decode logits (gathered whole) within the
    model tolerance of the reference's unsharded model; for ``"grad"``,
    each rank's loss and the ranks' gradient shards, joined
    (``unshard_params``), against ``jax.value_and_grad``, and each rank's
    cache its :func:`~repro_torch.parallel.sharding.cache_heads`; for
    ``"engine"``, every rank's greedy tokens (its paged pool of its own
    KV heads) equal to one rank's engine's."""
    _, want = reference(arch, label)
    got = [r["uneven"][f"{arch} {label}"] for r in ranks]
    if phase == "engine":
        one = one_rank_engine(arch, label)
        assert len(one) == len(PROMPTS)
        for g in got:
            assert g["engine"] == one
        return
    if phase == "forward":
        for g in got:
            np.testing.assert_allclose(g["forward"], want["forward"], **TOL)
    elif phase == "decode":
        for g in got:
            assert len(g["decode"]) == len(want["decode"])
            for a, b in zip(g["decode"], want["decode"]):
                np.testing.assert_allclose(a, b, **TOL)
    else:
        cfg = port_config(arch, label)
        for rank, g in enumerate(got):
            assert abs(g["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
            assert g["cache_heads"] == sharding.cache_heads(cfg, rank, WORLD)
        grads = sharding.unshard_params([g["grads"] for g in got], cfg,
                                        WORLD)
        assert_leaves_close(_keyed(grads), want["grads"])


@functools.cache
def one_rank_engine(arch: str, label: str) -> dict:
    """The port's engine at one rank on the reference's weights: its
    greedy tokens on :data:`PROMPTS`."""
    from repro_torch.serve.batching import Request
    from repro_torch.serve.engine import ServingEngine
    spec, _ = reference(arch, label)
    cfg = port_config(arch, label)
    engine = ServingEngine(cfg, params=params_from_jax(spec["params"], cfg,
                                                       device="cpu"),
                           device="cpu", slots=2, max_seq=MAX_SEQ,
                           block_size=4, prefill_chunk=4, psum_mode="ina",
                           check=True)
    return engine.run([Request(rid=f"r{i}", prompt_len=len(p), max_new=GEN,
                               prompt=tuple(p))
                       for i, p in enumerate(PROMPTS)]).tokens()


def one_rank_step(arch: str, label: str):
    """One AdamW step of the port at one rank from the reference's
    weights on the case's batch: (params, AdamW state)."""
    spec, _ = reference(arch, label)
    cfg = port_config(arch, label)
    model = get_model(cfg)
    params = params_from_jax(spec["params"], cfg, device="cpu",
                             masters=True)
    batch = {"tokens": torch.from_numpy(spec["tokens"]).long(),
             "labels": torch.from_numpy(spec["labels"]).long()}
    ts = build_train_step(model, ShapeConfig("t", S, B, "train"),
                          **SCHEDULE)
    params, opt, _ = ts.fn(params, adamw_init(params), batch)
    return params, opt


def check_adamw(arch: str, label: str, ranks: list) -> None:
    """Each rank's params and AdamW moments after one step hold its real
    heads only (the shapes of its ``shard_params`` piece: none on a rank
    with no head), and the moments, joined, equal one rank's step's."""
    spec, _ = reference(arch, label)
    cfg = port_config(arch, label)
    full = params_from_jax(spec["params"], cfg, device="cpu", masters=True)
    got = [r["uneven"][f"{arch} {label}"] for r in ranks]
    for rank, g in enumerate(got):
        piece = _keyed(sharding.shard_params(full, cfg, rank, WORLD))
        for key in ("params", "m", "v"):
            have = _keyed(g[key])
            assert {k: v.shape for k, v in have.items()} == \
                {k: tuple(v.shape) for k, v in piece.items()}, key
    _, opt = one_rank_step(arch, label)
    for key, want in (("m", opt.m), ("v", opt.v)):
        joined = sharding.unshard_params([g[key] for g in got], cfg, WORLD)
        assert_leaves_close(_keyed(joined), _keyed(want))
