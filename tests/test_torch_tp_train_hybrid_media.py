"""Tensor-parallel and FSDP training of the hybrid, vlm and encdec families in
the port, against the JAX package's unsharded model, on gloo ranks on the
CPU.

The reduced zamba2-2.7b (8 Mamba2 heads of 16 in 2 groups of 2 layers, a
shared block of 4 heads), llama-3.2-vision-11b (one group: a self layer
and a cross layer, GQA 4:2, 16 media rows) and whisper-medium (2 + 2
layers, GQA 4:2, 16 frames), float32, with the reference's weights
(``Model.init(PRNGKey(3))``, the vlm's gates set to 0.7 and -0.4 so that
the cross layer's weights get a gradient), B 2 x S 16 with seeded media,
cut with ``shard_params`` and trained at worlds 1, 2 and 4, one spawn a
world with every family and mode inside it (``tests/_torch_dist_workers.
py``), and on the ``(data 2, model 2)`` mesh.

The backward's sums sit where a replicated tensor enters rank-local work
(Megatron's ``f``, ``tp.enter_cut``): each Mamba2 block's input (its
packed ``w_in`` is cut in segments, z, x and dt by heads and B and C
whole, and ``GradSync`` sums the whole B and C segments of ``w_in``,
``conv_w`` and ``conv_b``, which meet only the rank's heads), the shared
block's normed input, each attention's and MLP's normed input, the cross
layers' query input, whisper's encoder output and the head's input; a
shared KV head's gradient, self- or cross-attention, sums over the ranks
that hold it.  So:

* The loss and every gradient leaf, rebuilt with ``unshard_params``,
  against ``jax.value_and_grad`` of the reference's ``loss`` on the
  unsharded weights, at worlds 1, 2 (and 4) under every mode: loss rtol
  1e-5, each leaf rtol 1e-4 plus atol 1e-5 of the leaf's largest.  The
  same under the sequence-sharded stream (``rs_seq``: at world 2 under
  every mode and with ``sp_entry``, at world 4 under ``ina``), where
  ``GradSync`` sums the leaves applied on a rank's slice (the stream's
  norms, zamba2's ``inv_norms``, ``wo_down`` and ``mlp_down``, the vlm's
  gates, whisper's ``ln_enc``), and the gradient's collective calls
  against the count derived from the layers.
* Two AdamW steps against the groupless one-rank step, the leaves every
  rank holds whole, the B and C segments and each shared KV head
  bit-equal across ranks after them, and a step's collective calls by
  kind against the count derived from the layers.
* A gloo group of one rank is the groupless step, bit for bit.
* One ``(data 2, model 2)`` step per family against the reference's
  gradient and the one-rank step.
* The launcher trains the vlm at ``--ranks 4 --model-parallel 2`` (each
  data host's rows of the media) and resumes from its checkpoint.

World 4 runs in ``tests/test_torch_tp_train_hybrid_media_w4.py``, with
this file's checks (``check_*``), so that neither file runs long on one
worker.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model

from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.configs import ARCHS
from repro_torch.core.collectives import CLI_PSUM_MODES
from repro_torch.launch import mesh
from repro_torch.launch import train as launch_train
from repro_torch.parallel import sharding

import _torch_dist_workers as W
from test_torch_tp_families import rs_cases

HYBRID, VLM, ENCDEC = "zamba2-2.7b", "llama-3.2-vision-11b", "whisper-medium"
FAMILIES = (HYBRID, VLM, ENCDEC)
B, S = 2, 16
SCHEDULE = {"base_lr": 3e-4, "warmup": 1, "total_steps": 10}
WORLDS = (1, 2)
DP_MODE = "ina_ring"
GATES = {"gate_attn": 0.7, "gate_mlp": -0.4}


def cases(world: int) -> dict:
    """Every CLI psum mode past one rank; at one rank a gloo group of one
    under ``ina`` (``"groupless"``, no group, is added by the worker)."""
    modes = ("ina",) if world == 1 else CLI_PSUM_MODES
    return {m: {"psum_mode": m} for m in modes}


def case_ids(worlds, of=cases) -> tuple:
    """(world, case, arch) of every case of ``of(world)`` at ``worlds``,
    and their ids."""
    ids = [(w, c, a) for w in worlds for c in of(w) for a in FAMILIES]
    return ids, [f"w{w}-{c}-{a}" for w, c, a in ids]


CASE_IDS, IDS = case_ids(WORLDS)
SHARDED, SHARDED_IDS = case_ids([w for w in WORLDS if w > 1])
RS_IDS, RS_NAMES = case_ids(WORLDS, rs_cases)


def _batch(rng, cfg, b=B) -> tuple:
    """(tokens, labels) and, for the vlm and whisper, media [B, M, D]."""
    toks = rng.integers(0, cfg.vocab, (b, S + 1)).astype(np.int32)
    out = (toks[:, :-1], toks[:, 1:])
    if cfg.num_media_tokens:
        out += (rng.standard_normal((b, cfg.num_media_tokens, cfg.d_model))
                .astype(np.float32),)
    return out


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@functools.cache
def reference(arch: str):
    """The reference's params (numpy), batches, and its unsharded loss and
    gradients on the first batch."""
    jm = jget_model(JARCHS[arch].reduced())
    jp = jm.init(jax.random.PRNGKey(3))
    if arch == VLM:
        for k, v in GATES.items():
            jp["xlayers"][k] = jnp.full_like(jp["xlayers"][k], v)
    rng = np.random.default_rng(0)
    grad_batch = _batch(rng, jm.cfg)
    batch = dict(zip(("tokens", "labels", "media"), grad_batch))
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, batch))(jp)
    spec = {"params": jax.tree.map(np.asarray, jp), "grad_batch": grad_batch,
            "step_batches": [_batch(rng, jm.cfg) for _ in range(2)]}
    return spec, float(jloss), _named(jgrads)


@functools.cache
def port(world: int) -> list:
    spec = {"archs": {a: reference(a)[0] for a in FAMILIES},
            "cases": cases(world), "grad_cases": rs_cases(world),
            "schedule": SCHEDULE, "norm": None}
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
    check_loss_and_grads(world, case, arch)


def check_loss_and_grads(world, case, arch):
    """Every rank's loss, and the logical gradient rebuilt from the ranks'
    shards (a whole segment of ``w_in`` and a shared KV head taken from
    one rank), against the reference's ``jax.value_and_grad``: a sum
    placed too early or left out moves the leaves behind it by a factor;
    every leaf nonzero."""
    _, jloss, jgrads = reference(arch)
    for rank in port(world):
        np.testing.assert_allclose(rank[arch][case]["loss"], jloss,
                                   rtol=1e-5)
    got = _unshard(world, arch, case, "grads")
    _assert_leaves_close(got, jgrads)
    for key, g in got.items():
        assert np.abs(g[:S] if key == "['pos_dec']" else g).max() > 0, key


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
    """The state after two steps against the one-rank step's: every param
    within AdamW's bound, lr a step, plus the gradient's leaf tolerance
    (``tests/test_torch_tp_train_families.py`` says why no tighter), and
    AdamW's m and sqrt(v) within rtol 1e-4 plus 1e-4 of the leaf's
    largest.  The moments are held looser than a gradient: the second
    step's gradient is taken at params that already differ by up to lr
    (about 1e-3 of a weight here) where the first gradient was
    rounding-sized, so it differs by that share of the leaf (2e-5 of the
    leaf's largest in whisper's cross-attention ``wq`` and Mamba2's
    ``D``), not by rounding."""
    for key in ("m", "v"):
        root = np.sqrt if key == "v" else (lambda a: a)
        want = {k: root(v) for k, v in _named(one[key]).items()}
        assert sorted(got[key]) == sorted(want)
        for name, w in want.items():
            np.testing.assert_allclose(root(got[key][name]), w, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(w).max()),
                                       err_msg=f"{key} {name}")
    want = _named(one["params"])
    assert sorted(got["params"]) == sorted(want)
    moved = 2 * sum(lrs)
    for key, w in want.items():
        atol = 1e-5 * float(np.abs(w).max())
        assert np.all(np.abs(got["params"][key] - w) <= moved + atol), key


@pytest.mark.parametrize("world,case,arch", SHARDED, ids=SHARDED_IDS)
def test_two_adamw_steps_match_one_rank(world, case, arch):
    check_two_adamw_steps(world, case, arch)


def check_two_adamw_steps(world, case, arch):
    """Each step's loss and ``grad_norm`` (over the logical arrays: a
    segmented leaf's cut runs summed over the ranks and its whole B and C
    counted once) equal the groupless one-rank step's within rtol 1e-5;
    the unsharded state after two steps as :func:`_held_to_one_rank`
    holds it."""
    one = _one_rank(arch)
    for rank in port(world):
        for got, want in zip(rank[arch][case]["steps"], one["steps"]):
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _held_to_one_rank({k: _unshard(world, arch, case, k)
                       for k in ("m", "v", "params")}, one,
                      [s["lr"] for s in one["steps"]])


# the leaves each family holds whole on every rank (sharding._WHOLE and the
# norms, the gates and the per-head norms)
WHOLE = {HYBRID: {"groups/ln", "inv_norms", "ln_f", "shared/wo_down",
                  "shared/mlp_down"},
         VLM: {"groups/ln1", "groups/ln2", "xlayers/lnx", "xlayers/ln2",
               "xlayers/xattn/q_norm", "xlayers/xattn/k_norm",
               "xlayers/gate_attn", "xlayers/gate_mlp", "ln_f"},
         ENCDEC: {"pos_dec", "enc_layers/ln1", "enc_layers/ln2", "ln_enc",
                  "dec_layers/ln1", "dec_layers/lnx", "dec_layers/ln2",
                  "ln_f"}}


@pytest.mark.parametrize("world,case,arch", SHARDED, ids=SHARDED_IDS)
def test_replicated_leaves_stay_bit_equal_across_ranks(world, case, arch):
    check_replicated_leaves(world, case, arch)


def check_replicated_leaves(world, case, arch):
    """After two steps a leaf every rank holds whole is the same to the bit
    on every rank, and so are Mamba2's whole B and C segments of ``w_in``,
    ``conv_w`` and ``conv_b`` (summed by ``GradSync``) and each KV head a
    group of ranks shares (self- and cross-attention).  Under
    ``eject_inject`` at more than two ranks each rank adds the ring's
    partials in its own order, so there the replicas are held to AdamW's
    bound (``tests/test_torch_tp_train_families.py`` says why)."""
    cfg = ARCHS[arch].reduced()
    ranks = [dict(_flat(r[arch][case]["params"])) for r in port(world)]
    kinds = dict(_flat(sharding.leaf_holding(
        port(world)[0][arch][case]["params"], cfg, 0, world)))
    whole = [path for path, kind in kinds.items() if kind == "whole"]
    assert {"/".join(p) for p in whole} == WHOLE[arch]
    segments = [(path, start, size) for path, kind in kinds.items()
                if isinstance(kind, tuple)
                for how, start, size in kind if how == "whole"]
    assert len(segments) == (6 if arch == HYBRID else 0)
    rank_order = world > 2 and case == "eject_inject"
    moved = 2 * sum(st["lr"] for st in port(world)[0][arch][case]["steps"])

    def same(a, b, path):
        if rank_order:
            np.testing.assert_allclose(a, b, rtol=0, atol=moved,
                                       err_msg=str(path))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    for r in ranks[1:]:
        for path in whole:
            same(r[path], ranks[0][path], path)
        for path, start, size in segments:
            same(r[path][..., start:start + size],
                 ranks[0][path][..., start:start + size], path)
    shared = 0
    for group in sharding.kv_groups(cfg, world):
        for path in ranks[0]:
            if path[-2:-1] in (("attn",), ("xattn",)) and \
                    path[-1] in ("wk", "wv"):
                shared += 1
                for r in group[1:]:
                    np.testing.assert_array_equal(
                        ranks[r][path], ranks[group[0]][path],
                        err_msg=str(path))
    assert shared == {(4, VLM): 8, (4, ENCDEC): 12}.get((world, arch), 0)


def expected_calls(arch: str) -> dict:
    """A train step's group operations on each rank, by kind, derived from
    the model (the same at worlds 2 and 4, but the shared KV heads' bucket
    at 4).  Forward: the embedding's psum, then the sites (zamba2: each
    group's shared ``wo`` and ``w_down`` psums, each Mamba2 layer's gate
    norm statistic and ``w_out`` psum; the vlm: ``wo`` and ``w_down`` a
    layer, self or cross; whisper: ``wo`` and ``w_down`` an encoder layer,
    self and cross ``wo`` and ``w_down`` a decoder layer), and the logits'
    gather.  Each checkpointed unit runs its forward again in the backward
    up to the last tensor the backward needs: a zamba2 group or a whisper
    layer up to its last row site, the vlm's group to its end (the MLP
    gate multiplies the last psum's output).  Backward: an all-reduce for
    each ``f`` (zamba2: each shared block's normed input, each Mamba2
    block's input and gate norm statistic; the vlm: each layer's two
    normed inputs; whisper: each attention's and MLP's normed input, the
    cross-attention's query input and the encoder's output; and the
    head's input).  Then the gradient reductions, one bucket each: the
    whole B and C segments (zamba2), the per-head norms (the vlm), the
    shared KV heads (vlm and whisper at world 4); and the norm's one
    all-reduce in AdamW."""
    cfg = ARCHS[arch].reduced()
    n = cfg.n_layers
    if arch == HYBRID:
        g = n // cfg.shared_attn_every
        return {"psum": 1 + 3 * g + 4 * n, "all_gather": 1,
                "all_reduce": g + 2 * n + 1 + 1 + 1}
    if arch == VLM:
        return {"psum": 1 + 2 * n + 2 * n, "all_gather": 1,
                "all_reduce": 2 * n + 1 + 1 + 1}
    e = cfg.encoder_layers
    return {"psum": 1 + (2 * e + 3 * n) + (e + 2 * n), "all_gather": 1,
            "all_reduce": 2 * e + 3 * n + 1 + 1 + 1}


def expected_rs_calls(arch: str, world: int) -> dict:
    """The gradient's group operations under ``rs_seq`` (S 16 and 16 media
    rows, which 2 and 4 divide) on each rank, by kind, derived from the
    model.  Forward: the embedding's psum, an all-gather at each block's
    entry (zamba2: each group's shared block and each Mamba2 layer; the
    vlm: two a layer; whisper: two an encoder layer, three a decoder
    layer, and the encoder's output), a reduce-scatter at each row site,
    a psum at each Mamba2 gate norm's statistic, and the head's entry and
    the logits' gather.  The recompute (:func:`expected_calls`' rule)
    runs a zamba2 group and a whisper layer up to their last
    reduce-scatter, and the vlm's group whole.  Backward: an all-gather at
    each reduce-scatter and at the embedding's slice (whisper's frames
    are data: their slice takes none), a reduce-scatter at each entry
    that takes the ``f`` (all but Mamba2's, which keeps its ``f`` at the
    block: an all-reduce, and one for its gate norm's statistic), and the
    head's.  Then the gradient reductions: the partial leaves' bucket
    (the stream's leaves among them) and the shared KV heads' (vlm and
    whisper at world 4)."""
    cfg = ARCHS[arch].reduced()
    n = cfg.n_layers
    kv = 1 if sharding.kv_groups(cfg, world) else 0
    if arch == HYBRID:
        g = n // cfg.shared_attn_every
        return {"psum": 1 + 2 * n,
                "all_gather": (g + n + 2) + (g + n) + (2 * g + n) + 1,
                "reduce_scatter": (2 * g + n) + (g + n) + g + 1,
                "all_reduce": 2 * n + 1 + kv}
    if arch == VLM:
        return {"psum": 1, "all_gather": (2 * n + 2) + 2 * n + 2 * n + 1,
                "reduce_scatter": 2 * n + 2 * n + 2 * n + 1,
                "all_reduce": 1 + kv}
    e = cfg.encoder_layers
    return {"psum": 1,
            "all_gather": (2 * e + 3 * n + 3) + (2 * e + 3 * n)
            + (2 * e + 3 * n) + 1,
            "reduce_scatter": (2 * e + 3 * n) + (e + 2 * n)
            + (2 * e + 1 + 3 * n) + 1,
            "all_reduce": 1 + kv}


@pytest.mark.parametrize("world,case,arch", RS_IDS, ids=RS_NAMES)
def test_rs_seq_gradient_calls(world, case, arch):
    check_rs_gradient_calls(world, case, arch)


def check_rs_gradient_calls(world, case, arch):
    """Every rank's gradient under ``rs_seq`` runs the derived
    operations."""
    want = expected_rs_calls(arch, world)
    for rank in port(world):
        assert rank[arch][case]["grad_calls"] == want


@pytest.mark.parametrize("world,case,arch", SHARDED, ids=SHARDED_IDS)
def test_collective_calls_per_step(world, case, arch):
    check_collective_calls(world, case, arch)


def check_collective_calls(world, case, arch):
    """Every rank runs the derived operations in each step (the same count
    on every rank, or one would wait forever); the gradient alone runs
    them less the AdamW norm's all-reduce."""
    want = dict(expected_calls(arch))
    if sharding.kv_groups(ARCHS[arch].reduced(), world):
        want["all_reduce"] += 1
    for rank in port(world):
        for step in rank[arch][case]["steps"]:
            assert step["calls"] == want
        grad = dict(want, all_reduce=want["all_reduce"] - 1)
        assert rank[arch][case]["grad_calls"] == grad


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
    (and of the media) with its FSDP piece (zamba2's segmented ``w_in``
    cut on D over ``data`` and in segments over ``model``): the global
    batch's loss and the gradient rebuilt from the four ranks' pieces
    against the reference's ``jax.value_and_grad``, then two steps against
    the one-rank step (loss and ``grad_norm`` rtol 1e-5, the state as
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
def test_launcher_trains_and_resumes_the_vlm_on_the_mesh(tmp_path):
    """``launch.train --arch llama-3.2-vision-11b --reduced --device cpu
    --ranks 4 --model-parallel 2`` (gloo ranks as ``(data 2, model 2)``,
    each data host with its rows of the media of ones): 4 steps lower the
    loss and checkpoint at step 2; a second run into the same directory
    resumes at step 3, where its loss equals the first run's to the
    bit."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", VLM, "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--lr", "1e-2", "--ckpt-every", "2", "--steps",
            "4", "--psum-mode", "ina_ring", "--ckpt-dir", ck, "--ranks", "4",
            "--model-parallel", "2"]
    first = launch_train.main(argv)
    assert first["steps"] == [0, 1, 2, 3] and "state" not in first
    assert first["losses"][-1] < first["losses"][0]
    assert latest_step(ck) == 2
    second = launch_train.main(argv)
    assert second["steps"] == [3] and second["last"] == 4
    assert second["losses"][0] == first["losses"][3]
