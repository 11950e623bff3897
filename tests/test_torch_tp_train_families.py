"""Tensor-parallel and FSDP training of the ssm, moe and mla_moe families in
the port, against the JAX package's unsharded model, on gloo ranks on the
CPU.

The reduced rwkv6-7b (4 heads of 16), llama4-scout-17b-16e (GQA 4:2, 4
experts top-1 and a shared one) and deepseek-v2-lite-16b (MLA, 4 heads, 4
experts top-2 and a shared one, a dense first layer), float32, with the
reference's weights (``Model.init(PRNGKey(3))``, RWKV6's zero bonus ``u``
seeded), B 2 x S 16, cut with ``shard_params`` and trained at worlds 1, 2
and 4, one spawn a world with every family and mode inside it
(``tests/_torch_dist_workers.py``), and on the ``(data 2, model 2)`` mesh.

The backward's sums sit where a replicated tensor enters rank-local work
(Megatron's ``f``, ``tp.enter_cut``): the vocab-parallel head's input,
RWKV6's time-mix input and its channel mix's ``xk`` (not ``xr``, whose
``wr`` is whole), the MoE's tokens and gate values where they meet the
rank's experts (not the router), MLA's ``wq`` input, latent and rope key;
the output norm's statistic sums its gradient (``C.psum_stat``), and the
time mix's whole ``mu`` and ``w_lora_a`` sum theirs in ``GradSync``.  So:

* The loss and every gradient leaf, rebuilt with ``unshard_params``,
  against ``jax.value_and_grad`` of the reference's ``loss`` on the
  unsharded weights, at worlds 1, 2 and 4 under every mode: loss rtol
  1e-5, each leaf rtol 1e-4 plus atol 1e-5 of the leaf's largest.  The
  same under the sequence-sharded stream (``rs_seq``: at world 2 under
  every mode and with ``sp_entry``, at world 4 under ``ina``), where the
  stream's norms sum their gradients in ``GradSync``, and the
  gradient's collective calls against the count derived from the
  layers.
* Two AdamW steps against the groupless one-rank step
  (``tests/test_torch_tp_train.py``'s rule), the leaves every rank holds
  whole (and each shared KV head) bit-equal across ranks after them, and a
  step's collective calls by kind against the count derived from the
  layers.
* A gloo group of one rank is the groupless step, bit for bit.
* ``group_rms_norm``'s gradients at world 2 against the unsharded norm.
* One ``(data 2, model 2)`` step per family against the reference's
  gradient and the one-rank step.
* The launcher trains rwkv6-7b and deepseek-v2-lite at ``--ranks 4
  --model-parallel 2``, lowers the loss, and resumes from its checkpoint.
"""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model

from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.configs import ARCHS
from repro_torch.core.collectives import CLI_PSUM_MODES
from repro_torch.launch import mesh
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.parallel import sharding

import _torch_dist_workers as W
from test_torch_tp_families import rs_cases

RWKV, LLAMA4, DEEPSEEK = ("rwkv6-7b", "llama4-scout-17b-16e",
                          "deepseek-v2-lite-16b")
FAMILIES = (RWKV, LLAMA4, DEEPSEEK)
B, S = 2, 16
SCHEDULE = {"base_lr": 3e-4, "warmup": 1, "total_steps": 10}
WORLDS = (1, 2, 4)
DP_MODE = "ina_ring"


def cases(world: int) -> dict:
    """Every CLI psum mode past one rank; at one rank a gloo group of one
    under ``ina`` (``"groupless"``, no group, is added by the worker)."""
    modes = ("ina",) if world == 1 else CLI_PSUM_MODES
    return {m: {"psum_mode": m} for m in modes}


CASE_IDS = [(w, c, a) for w in WORLDS for c in cases(w) for a in FAMILIES]
IDS = [f"w{w}-{c}-{a}" for w, c, a in CASE_IDS]
SHARDED = [(w, c, a) for w, c, a in CASE_IDS if w > 1]
SHARDED_IDS = [f"w{w}-{c}-{a}" for w, c, a in SHARDED]
RS_IDS = [(w, c, a) for w in WORLDS for c in rs_cases(w) for a in FAMILIES]
RS_NAMES = [f"w{w}-{c}-{a}" for w, c, a in RS_IDS]


def _pair(rng, vocab, b=B):
    toks = rng.integers(0, vocab, (b, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@functools.cache
def reference(arch: str):
    """The reference's params (numpy), batches, and its unsharded loss and
    gradients on the first batch."""
    jm = jget_model(JARCHS[arch].reduced())
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    if arch == RWKV:
        u = jp["layers"]["tmix"]["u"]
        jp["layers"]["tmix"]["u"] = jnp.asarray(
            0.5 * rng.standard_normal(u.shape).astype(np.float32))
    grad_batch = _pair(rng, jm.cfg.vocab)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(
        p, {"tokens": grad_batch[0], "labels": grad_batch[1]}))(jp)
    spec = {"params": jax.tree.map(np.asarray, jp), "grad_batch": grad_batch,
            "step_batches": [_pair(rng, jm.cfg.vocab) for _ in range(2)]}
    return spec, float(jloss), _named(jgrads)


NORM_SHAPE = (B, S, 64)


@functools.cache
def norm_inputs() -> dict:
    rng = np.random.default_rng(9)
    return {k: rng.standard_normal(shape).astype(np.float32) for k, shape in
            (("y", NORM_SHAPE), ("w", NORM_SHAPE[-1:]), ("dy", NORM_SHAPE))}


@functools.cache
def port(world: int) -> list:
    spec = {"archs": {a: reference(a)[0] for a in FAMILIES},
            "cases": cases(world), "grad_cases": rs_cases(world),
            "schedule": SCHEDULE,
            "norm": norm_inputs() if world == 2 else None}
    return mesh.spawn(W.tp_train_families_rank, world, "cpu", args=(spec,))


def _unshard(world: int, arch: str, case: str, key: str) -> dict:
    return _named(sharding.unshard_params(
        [rank[arch][case][key] for rank in port(world)],
        ARCHS[arch].reduced(), world))


def _assert_leaves_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=key)


def _one_rank(arch: str) -> dict:
    return port(1)[0][arch]["groupless"]


def _flat(tree, names=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, names + (k,))
        else:
            yield names + (k,), v


# --------------------------------------------------------------------------- #
# gradients and AdamW against the unsharded step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("world,case,arch", CASE_IDS + RS_IDS,
                         ids=IDS + RS_NAMES)
def test_loss_and_grads_match_unsharded_reference(world, case, arch):
    """Every rank's loss, and the logical gradient rebuilt from the ranks'
    shards, against the reference's ``jax.value_and_grad``: a sum placed
    too early or left out moves the leaves behind it by a factor."""
    _, jloss, jgrads = reference(arch)
    for rank in port(world):
        np.testing.assert_allclose(rank[arch][case]["loss"], jloss,
                                   rtol=1e-5)
    got = _unshard(world, arch, case, "grads")
    _assert_leaves_close(got, jgrads)
    assert all(np.abs(g).max() > 0 for g in got.values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_rank_group_is_the_groupless_step(arch):
    """At world 1 a gloo group of one changes nothing: the loss, gradients,
    losses, norms and params of two steps equal the groupless step's to the
    bit, and no collective runs."""
    got, one = port(1)[0][arch]["ina"], _one_rank(arch)
    assert got["loss"] == one["loss"]
    for a, b in zip(got["steps"], one["steps"]):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
        assert a["calls"] == {}
    assert got["grad_calls"] == {}
    for key in ("grads", "params"):
        for (path, a), (_, b) in zip(_flat(got[key]), _flat(one[key])):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


def _held_to_one_rank(got: dict, one: dict, lrs: list) -> None:
    """The state after two steps against the one-rank step's: AdamW's
    moments m and sqrt(v) within the gradient's leaf tolerance, and every
    param within AdamW's bound of the one-rank param, lr a step, plus that
    tolerance.  The params are held no tighter: Adam's first update of an
    element is lr times the sign of its gradient, whatever its size, so an
    element whose first gradient is rounding-sized on both sides (its two
    values equal within the tolerance, and of either sign) may move by lr
    one way or the other."""
    _assert_leaves_close(got["m"], _named(one["m"]))
    rms = {k: np.sqrt(v) for k, v in _named(one["v"]).items()}
    _assert_leaves_close({k: np.sqrt(v) for k, v in got["v"].items()}, rms)
    want = _named(one["params"])
    assert sorted(got["params"]) == sorted(want)
    moved = 2 * sum(lrs)
    for key, w in want.items():
        atol = 1e-5 * float(np.abs(w).max())
        assert np.all(np.abs(got["params"][key] - w) <= moved + atol), key


@pytest.mark.parametrize("world,case,arch", SHARDED, ids=SHARDED_IDS)
def test_two_adamw_steps_match_one_rank(world, case, arch):
    """Each step's loss and ``grad_norm`` (over the logical arrays: cut
    leaves summed over the ranks, whole leaves counted once) equal the
    groupless one-rank step's within rtol 1e-5; the unsharded state after
    two steps as :func:`_held_to_one_rank` holds it."""
    one = _one_rank(arch)
    for rank in port(world):
        for got, want in zip(rank[arch][case]["steps"], one["steps"]):
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _held_to_one_rank({k: _unshard(world, arch, case, k)
                       for k in ("m", "v", "params")}, one,
                      [s["lr"] for s in one["steps"]])


# the whole leaves each family holds on every rank (sharding._WHOLE and the
# norms)
WHOLE = {RWKV: {"ln_in", "ln1", "ln2", "ln_f", "tmix/mu", "tmix/w_lora_a",
                "cmix/mu", "cmix/wr"},
         LLAMA4: {"ln1", "ln2", "ln_f", "mlp/router"},
         DEEPSEEK: {"ln1", "ln2", "ln_f", "mlp/router", "attn/w_dkv",
                    "attn/kv_norm"}}


@pytest.mark.parametrize("world,case,arch", SHARDED, ids=SHARDED_IDS)
def test_replicated_leaves_stay_bit_equal_across_ranks(world, case, arch):
    """After two steps a leaf every rank holds whole is the same to the bit
    on every rank, the router, RWKV6's token shifts and MLA's ``w_dkv``
    among them (summed where partial, whole where not: a sum placed on a
    whole path would still agree, so the gradient test above is the one
    that sees it), and so is each KV head a group of ranks shares.  Under
    ``eject_inject`` at more than two ranks each rank adds the ring's
    partials in its own order (the reference's), so the replicated stream
    differs by an ulp between ranks, and so do the gradients of the whole
    leaves; AdamW turns a rounding-sized gradient's difference into one of
    up to lr a step, so there the replicas are held to AdamW's bound."""
    cfg = ARCHS[arch].reduced()
    ranks = [dict(_flat(r[arch][case]["params"])) for r in port(world)]
    kinds = dict(_flat(sharding.leaf_holding(
        port(world)[0][arch][case]["params"], cfg, 0, world)))
    whole = [path for path, kind in kinds.items() if kind == "whole"]
    assert {"/".join(p[-2:] if p[-2:-1] in (("tmix",), ("cmix",),
                                            ("mlp",), ("attn",))
                     else p[-1:]) for p in whole} == WHOLE[arch]
    rank_order = world > 2 and case == "eject_inject"
    moved = 2 * sum(st["lr"] for st in port(world)[0][arch][case]["steps"])
    for path in whole:
        for r in ranks[1:]:
            if rank_order:
                np.testing.assert_allclose(r[path], ranks[0][path], rtol=0,
                                           atol=moved, err_msg=str(path))
            else:
                np.testing.assert_array_equal(r[path], ranks[0][path],
                                              err_msg=str(path))
    shared = 0
    for group in sharding.kv_groups(cfg, world):
        for path in ranks[0]:
            if path[-2:] in (("attn", "wk"), ("attn", "wv")):
                shared += 1
                for r in group[1:]:
                    np.testing.assert_array_equal(
                        ranks[r][path], ranks[group[0]][path],
                        err_msg=str(path))
    assert shared == (4 if world == 4 and arch == LLAMA4 else 0)


def expected_calls(arch: str, world: int) -> dict:
    """A train step's group operations on each rank, by kind, derived from
    the model.  Forward: the embedding's psum, then each layer's sites
    (RWKV6: the output norm's statistic, ``wo``'s and the channel mix's
    ``wv`` psums; an MoE layer: ``wo``, the experts' combine and the shared
    experts' psum; a dense layer: ``wo`` and ``w_down``), and the logits'
    gather.  Each checkpointed layer runs its forward again in the
    backward up to the last tensor the backward needs: through the whole
    layer for RWKV6 (its gate) and an MoE layer (its aux loss), up to the
    last row site for a dense layer.  Backward: an all-reduce for each
    ``f`` (RWKV6: the time-mix input, the output norm's statistic and
    ``xk``; GQA attention: its input; MLA: ``wq``'s input, the latent and
    the rope key; an MoE layer: its tokens and gate values; a dense MLP:
    its input; and the head's input).  Then the gradient reductions, one
    bucket each: the shared KV heads (llama4 at world 4) and RWKV6's
    partial ``mu`` and ``w_lora_a``; and the norm's one all-reduce in
    AdamW."""
    cfg = ARCHS[arch].reduced()
    n = cfg.n_layers
    kv = 1 if arch == LLAMA4 and sharding.kv_groups(cfg, world) else 0
    if arch == RWKV:
        return {"psum": 1 + 3 * n + 3 * n, "all_gather": 1,
                "all_reduce": 3 * n + 1 + 1 + 1}
    nd = cfg.moe.first_dense_layers
    nm = n - nd
    attn = 3 if arch == DEEPSEEK else 1
    return {"psum": 1 + (2 * nd + 3 * nm) + (nd + 3 * nm), "all_gather": 1,
            "all_reduce": (attn + 1) * nd + (attn + 2) * nm + 1 + kv + 1}


def expected_rs_calls(arch: str, world: int) -> dict:
    """The gradient's group operations under ``rs_seq`` (S 16, which 2
    and 4 divide) on each rank, by kind, derived from the model.
    Forward: the embedding's psum, an all-gather at each block's entry, a
    reduce-scatter at each row site (RWKV6: ``wo`` and ``wv``; an MoE
    layer: ``wo`` and the shared experts' ``w_down``; a dense layer:
    ``wo`` and ``w_down``), a psum at each MoE combine and RWKV6 output
    norm's statistic, and the head's entry and the logits' gather.  The
    recompute (:func:`expected_calls`' rule) runs the whole RWKV6 and MoE
    layer again, and a dense layer but for its last reduce-scatter.
    Backward: an all-gather at each reduce-scatter and at each whole
    tensor sliced onto the stream (the embedding, an MoE combine, RWKV6's
    channel-mix gate); a reduce-scatter at each entry that takes the
    ``f`` (GQA attention, a dense MLP, the head); an all-reduce at each
    ``f`` a block keeps (RWKV6: the time-mix input and ``xk``; MLA:
    ``wq``'s input, the latent and the rope key; an MoE layer: its tokens
    and gate values) and at each norm statistic.  Then the gradient
    reductions: the partial leaves' bucket (the stream's norms among
    them) and the shared KV heads' (llama4 at world 4)."""
    cfg = ARCHS[arch].reduced()
    n = cfg.n_layers
    if arch == RWKV:
        return {"psum": 1 + 2 * n, "all_gather": 7 * n + 3,
                "reduce_scatter": 4 * n + 1, "all_reduce": 3 * n + 1}
    kv = 1 if arch == LLAMA4 and sharding.kv_groups(cfg, world) else 0
    nd = cfg.moe.first_dense_layers
    nm = n - nd
    mla = arch == DEEPSEEK
    return {"psum": 1 + 2 * nm,
            "all_gather": (2 * n + 2) + (2 * n) + (2 * nd + 3 * nm) + 1,
            "reduce_scatter": (2 * n) + (nd + 2 * nm) + nd
            + (0 if mla else n) + 1,
            "all_reduce": 2 * nm + (3 * n if mla else 0) + 1 + kv}


@pytest.mark.parametrize("world,case,arch", RS_IDS, ids=RS_NAMES)
def test_rs_seq_gradient_calls(world, case, arch):
    """Every rank's gradient under ``rs_seq`` runs the derived
    operations."""
    want = expected_rs_calls(arch, world)
    for rank in port(world):
        assert rank[arch][case]["grad_calls"] == want


@pytest.mark.parametrize("world,case,arch", SHARDED, ids=SHARDED_IDS)
def test_collective_calls_per_step(world, case, arch):
    """Every rank runs the derived operations in each step (the same count
    on every rank, or one would wait forever); the gradient alone runs
    them less the AdamW norm's all-reduce."""
    want = expected_calls(arch, world)
    for rank in port(world):
        for step in rank[arch][case]["steps"]:
            assert step["calls"] == want
        grad = dict(want, all_reduce=want["all_reduce"] - 1)
        assert rank[arch][case]["grad_calls"] == grad


def test_group_rms_norm_grads_match_the_unsharded_norm():
    """Two ranks each holding half the channels of y [B, S, 64] and of the
    weight: the output and the gradients of y and w, joined, equal the
    unsharded ``rms_norm``'s within 1e-6 relative, and the backward sums
    the statistic's gradient (one all-reduce) where the forward summed the
    statistic (one psum)."""
    n = norm_inputs()
    y, w = (torch.from_numpy(n[k]).requires_grad_() for k in ("y", "w"))
    z = L.rms_norm(y, w, ARCHS[RWKV].reduced().norm_eps)
    gy, gw = torch.autograd.grad(z, (y, w), torch.from_numpy(n["dy"]))
    ranks = [r["norm"] for r in port(2)]
    for got, want in (("z", z.detach()), ("dy", gy), ("dw", gw)):
        joined = np.concatenate([r[got] for r in ranks], -1)
        np.testing.assert_allclose(joined, want.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()),
                                   err_msg=got)
    assert all(r["calls"] == {"psum": 1, "all_reduce": 1} for r in ranks)


# --------------------------------------------------------------------------- #
# the (data 2, model 2) mesh
# --------------------------------------------------------------------------- #
@functools.cache
def data_model() -> list:
    spec = {"mesh": ((2, 2), ("data", "model")),
            "archs": {a: reference(a)[0] for a in FAMILIES},
            "cases": {DP_MODE: {"psum_mode": DP_MODE}},
            "schedule": SCHEDULE}
    return mesh.spawn(W.dp_train_rank, 4, "cpu", args=(spec,))


@pytest.mark.parametrize("arch", FAMILIES)
def test_data_model_step_matches_reference_and_one_rank(arch):
    """Each rank of ``(data 2, model 2)`` trains on its row of the batch
    with its FSDP piece: the global batch's loss and the gradient rebuilt
    from the four ranks' pieces against the reference's
    ``jax.value_and_grad``, then two steps against the one-rank step
    (loss and ``grad_norm`` rtol 1e-5, the state as
    :func:`_held_to_one_rank` holds it)."""
    cfg = ARCHS[arch].reduced()
    _, jloss, jgrads = reference(arch)
    ranks = [r[arch] for r in data_model()]
    for r in ranks:
        np.testing.assert_allclose(r[DP_MODE]["loss"], jloss, rtol=1e-5)

    def unshard(key):
        return _named(sharding.unshard_params(
            [r[DP_MODE][key] for r in ranks], cfg, (2, 2)))
    _assert_leaves_close(unshard("grads"), jgrads)
    one = _one_rank(arch)
    for r in ranks:
        for got, want in zip(r[DP_MODE]["steps"], one["steps"]):
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _held_to_one_rank({k: unshard(k) for k in ("m", "v", "params")}, one,
                      [s["lr"] for s in one["steps"]])


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", [RWKV, DEEPSEEK])
def test_launcher_trains_and_resumes_on_the_mesh(arch, tmp_path):
    """``launch.train --reduced --device cpu --ranks 4 --model-parallel 2``
    (gloo ranks as ``(data 2, model 2)``, rank 0 printing): 4 steps lower
    the loss and checkpoint at step 2; a second run into the same
    directory resumes at step 3, where its loss equals the first run's to
    the bit (the same logical state, cut alike, and the same batch); and
    the checkpoint resumes at another model span too, ``(data 1, model
    4)``, its step-3 loss within rtol 1e-5 of the first run's (the same
    sums in another order)."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--lr", "1e-2", "--ckpt-every", "2", "--steps",
            "4", "--psum-mode", "ina_ring"]
    first = launch_train.main(argv + ["--ckpt-dir", ck, "--ranks", "4",
                                      "--model-parallel", "2"])
    assert first["steps"] == [0, 1, 2, 3] and "state" not in first
    assert first["losses"][-1] < first["losses"][0]
    assert latest_step(ck) == 2
    other = str(tmp_path / "other")
    shutil.copytree(ck, other)
    second = launch_train.main(argv + ["--ckpt-dir", ck, "--ranks", "4",
                                       "--model-parallel", "2"])
    assert second["steps"] == [3] and second["last"] == 4
    assert second["losses"][0] == first["losses"][3]
    third = launch_train.main(argv + ["--ckpt-dir", other,
                                      "--model-parallel", "4"])
    assert third["steps"] == [3]
    np.testing.assert_allclose(third["losses"][0], first["losses"][3],
                               rtol=1e-5)
