"""Tensor-parallel training in the port, against the JAX package's unsharded
step, on gloo ranks on the CPU.

The reduced qwen2 (4 query heads, 2 KV heads: at world 4 two ranks share
each KV head; float32) with the reference's weights
(``Model.init(PRNGKey(3))``, its zero QKV biases replaced by seeded values)
is cut with ``shard_params`` and trained at worlds 1, 2 and 4, one spawn a
world with every case inside it (``tests/_torch_dist_workers.py``): each
psum mode, and at world 2 also ``rs_seq`` under each mode and with
``sp_entry``.  B 2 x S 16.

* The loss and every gradient leaf, rebuilt with ``unshard_params``,
  against ``jax.value_and_grad`` of the reference's ``loss`` on the
  unsharded weights, with ``tests/test_torch_train.py``'s tolerance: loss
  rtol 1e-5, each leaf rtol 1e-4 plus atol 1e-5 of the leaf's largest.
* Two AdamW steps: ``grad_norm`` equal to the groupless one-rank step's
  within rtol 1e-5 and the unsharded params within the leaf tolerance;
  every leaf that ranks hold whole, and each shared KV copy, bit-equal
  across the ranks that hold it.
* A step's collective calls by kind, against the count derived from the
  layer count and the mode.
* At world 1 with a gloo group of one rank: losses and params bit-equal to
  the step without a group, and no collective call.
* Elastic checkpoints: a world-2 run's step-2 checkpoint resumes at worlds 1
  and 4, and the reference's ``restore_pytree`` reads it.
* ``fit_spec`` against the reference's on a table of cases.
* The launcher: ``--model-parallel 2`` trains and lowers the loss; a second
  run at ``--model-parallel 4`` resumes at the saved step.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.checkpoint import ckpt as jckpt
from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model
from repro.optim.adamw import adamw_init as jadamw_init
from repro.parallel.sharding import fit_spec as jfit_spec

from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.configs import ARCHS
from repro_torch.core.collectives import CLI_PSUM_MODES
from repro_torch.launch import mesh
from repro_torch.launch import train as launch_train
from repro_torch.parallel import sharding

import _torch_dist_workers as W

ARCH = "qwen2-1.5b"
B, S = 2, 16
SCHEDULE = {"base_lr": 3e-4, "warmup": 1, "total_steps": 10}
CFG = ARCHS[ARCH].reduced()
L = CFG.n_layers


def cases(world: int) -> dict:
    out = {m: {"psum_mode": m} for m in CLI_PSUM_MODES}
    if world == 2:
        out.update({f"{m}+rs_seq": {"psum_mode": m, "rs_seq": True}
                    for m in CLI_PSUM_MODES})
        out["ina+rs_seq+sp_entry"] = {"psum_mode": "ina", "rs_seq": True,
                                      "sp_entry": True}
    return out


CASE_IDS = [(w, c) for w in (1, 2, 4) for c in cases(w)]
IDS = [f"w{w}-{c}" for w, c in CASE_IDS]
SHARDED = [(w, c) for w, c in CASE_IDS if w > 1]
SHARDED_IDS = [f"w{w}-{c}" for w, c in SHARDED]


def _pair(rng, vocab):
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@functools.cache
def reference():
    """The reference's params (numpy), batches, and its unsharded loss and
    gradients on the first batch."""
    jm = jget_model(JARCHS[ARCH].reduced())
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        leaf = jp["layers"]["attn"][name]
        jp["layers"]["attn"][name] = jnp.asarray(
            0.1 * rng.standard_normal(leaf.shape).astype(np.float32))
    grad_batch = _pair(rng, CFG.vocab)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(
        p, {"tokens": grad_batch[0], "labels": grad_batch[1]}))(jp)
    spec = {"arch": ARCH, "params": jax.tree.map(np.asarray, jp),
            "grad_batch": grad_batch,
            "step_batches": [_pair(rng, CFG.vocab) for _ in range(2)],
            "schedule": SCHEDULE}
    return spec, float(jloss), _named(jgrads)


@functools.cache
def port(world: int) -> list:
    spec, _, _ = reference()
    return mesh.spawn(W.tp_train_rank, world, "cpu",
                      args=({**spec, "cases": cases(world)},))


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _unshard(world: int, case: str, key: str) -> dict:
    return _named(sharding.unshard_params(
        [rank[case][key] for rank in port(world)], CFG, world))


def _assert_leaves_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=key)


def _one_rank() -> dict:
    return port(1)[0]["groupless"]


# --------------------------------------------------------------------------- #
# gradients and AdamW against the unsharded step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("world,case", CASE_IDS, ids=IDS)
def test_loss_and_grads_match_unsharded_reference(world, case):
    """Every rank's loss, and the logical gradient rebuilt from the ranks'
    shards, against the reference's ``jax.value_and_grad``."""
    _, jloss, jgrads = reference()
    for rank in port(world):
        np.testing.assert_allclose(rank[case]["loss"], jloss, rtol=1e-5)
    got = _unshard(world, case, "grads")
    _assert_leaves_close(got, jgrads)
    assert all(np.abs(g).max() > 0 for g in got.values())


ODD_VOCAB = 250          # 4 ranks do not divide it


@functools.cache
def odd_vocab():
    """The reduced qwen2 with a vocabulary that 4 ranks do not divide, at
    world 4: every rank holds the whole tied table, so the head's input
    gradient is whole on every rank (no ``f``, and under ``rs_seq`` the
    gather's backward is a slice).  (the ranks' results, the reference's
    loss and gradients)"""
    jm = jget_model(dataclasses.replace(JARCHS[ARCH].reduced(),
                                        vocab=ODD_VOCAB))
    jp = jm.init(jax.random.PRNGKey(4))
    batch = _pair(np.random.default_rng(1), ODD_VOCAB)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(
        p, {"tokens": batch[0], "labels": batch[1]}))(jp)
    spec = {"arch": ARCH, "config": {"vocab": ODD_VOCAB},
            "params": jax.tree.map(np.asarray, jp), "grad_batch": batch,
            "step_batches": [], "schedule": SCHEDULE,
            "cases": {"ina": {"psum_mode": "ina"},
                      "ina+rs_seq": {"psum_mode": "ina", "rs_seq": True}}}
    ranks = mesh.spawn(W.tp_train_rank, 4, "cpu", args=(spec,))
    return ranks, float(jloss), _named(jgrads)


@pytest.mark.parametrize("case", ["ina", "ina+rs_seq"])
def test_whole_vocab_table_grads_match_reference(case):
    ranks, jloss, jgrads = odd_vocab()
    for rank in ranks:
        np.testing.assert_allclose(rank[case]["loss"], jloss, rtol=1e-5)
    cfg = dataclasses.replace(CFG, vocab=ODD_VOCAB)
    assert ranks[0][case]["grads"]["embed"].shape == (ODD_VOCAB, CFG.d_model)
    _assert_leaves_close(_named(sharding.unshard_params(
        [rank[case]["grads"] for rank in ranks], cfg, 4)), jgrads)
    for rank in ranks[1:]:
        np.testing.assert_array_equal(rank[case]["grads"]["embed"],
                                      ranks[0][case]["grads"]["embed"])


@pytest.mark.parametrize("world,case", SHARDED, ids=SHARDED_IDS)
def test_two_adamw_steps_match_one_rank(world, case):
    """``grad_norm`` is the norm over the logical arrays (the ranks' cut
    leaves summed, whole leaves and shared KV heads counted once): equal
    to the one-rank step's within rtol 1e-5, as is each step's loss.  After
    two steps, AdamW's moments (m, and the RMS gradient sqrt(v): the two
    steps' gradients before AdamW divides one by the other) and the
    params, unsharded, equal the one-rank step's within the leaf
    tolerance.  AdamW moves an element by about lr whatever its
    gradient's size, so where the gradient lies below the tolerance's
    floor (sqrt(v) under 1e-5 of its leaf's largest: a rounding-sized
    gradient, whose direction is rounding) the element is held only to
    AdamW's bound: |m-hat| / sqrt(v-hat) <= 1 at each of the two steps."""
    one = _one_rank()
    for rank in port(world):
        for got, want in zip(rank[case]["steps"], one["steps"]):
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_leaves_close(_unshard(world, case, "m"), _named(one["m"]))
    rms = {k: np.sqrt(v) for k, v in _named(one["v"]).items()}
    _assert_leaves_close({k: np.sqrt(v) for k, v in
                          _unshard(world, case, "v").items()}, rms)
    got, want = _unshard(world, case, "params"), _named(one["params"])
    assert sorted(got) == sorted(want)
    moved = 2 * sum(s["lr"] for s in one["steps"])
    resolved = 0
    for key, w in want.items():
        atol = 1e-5 * float(np.abs(w).max())
        sure = rms[key] > 1e-5 * rms[key].max()
        np.testing.assert_allclose(got[key][sure], w[sure], rtol=1e-4,
                                   atol=atol, err_msg=key)
        assert np.all(np.abs(got[key] - w) <= moved + atol), key
        resolved += sure.sum() / sure.size / len(want)
    assert resolved > 0.9


def _flat(tree, names=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, names + (k,))
        else:
            yield names + (k,), v


@pytest.mark.parametrize("world,case", SHARDED, ids=SHARDED_IDS)
def test_replicated_leaves_stay_bit_equal_across_ranks(world, case):
    """After two steps, a leaf every rank holds whole is the same to the bit
    on every rank (no reduction keeps it so: the same inputs and the same
    arithmetic), and so is each KV head that a group of ranks shares (its
    gradient summed over the group)."""
    ranks = [dict(_flat(r[case]["params"])) for r in port(world)]
    kinds = dict(_flat(sharding.leaf_holding(port(world)[0][case]["params"],
                                             CFG, 0, world)))
    whole = [path for path, kind in kinds.items() if kind == "whole"]
    assert sorted(p[-1] for p in whole) == ["ln1", "ln2", "ln_f"]
    rank_order = world > 2 and cases(world)[case]["psum_mode"] == "eject_inject"
    for path in whole:
        for r in ranks[1:]:
            if rank_order:
                # Fig. 4(a)'s relay: rank i adds the partials in its own ring
                # order, the reference's (held bit for bit against it), so
                # at more than two ranks the replicated stream, and the
                # leaves it trains, differ by an ulp between ranks
                np.testing.assert_allclose(r[path], ranks[0][path],
                                           rtol=2 ** -20, atol=0,
                                           err_msg=str(path))
            else:
                np.testing.assert_array_equal(r[path], ranks[0][path],
                                              err_msg=str(path))
    shared = 0
    for group in sharding.kv_groups(CFG, world):
        for path in ranks[0]:
            if path[-1] in ("wk", "bk", "wv", "bv"):
                shared += 1
                for r in group[1:]:
                    np.testing.assert_array_equal(
                        ranks[r][path], ranks[group[0]][path],
                        err_msg=str(path))
    assert shared == (8 if world == 4 else 0)


def expected_calls(world: int, rs_seq: bool) -> dict:
    """A train step's group operations on each rank, by kind, derived from
    the model: per layer two column-parallel entries (``gather_seq``) and
    two row-parallel sites; the embedding's psum, the head's entry and
    the logits' gather.  Each checkpointed layer runs its forward again in
    the backward up to the last tensor the backward needs (the
    ``torch.utils.checkpoint`` default stops there), which is the MLP's
    ``w_down`` input: every collective of the layer but the last row site.
    Backwards: an entry's all-reduce (Megatron's ``f``) or, under
    ``rs_seq``, its reduce-scatter; a row site's all-gather under
    ``rs_seq`` (a psum's backward is the identity); the sequence scatter
    after the embedding gathers.  Then the gradient reductions, one
    bucket each: the shared KV heads (at world 4) and, under ``rs_seq``,
    the norm weights; and the norm's one all-reduce in AdamW."""
    kv = 1 if sharding.kv_groups(CFG, world) else 0
    if not rs_seq:
        return {"psum": 1 + 2 * L + L, "all_gather": 1,
                "all_reduce": 2 * L + 1 + kv + 1}
    return {"psum": 1,
            "all_gather": (2 * L + 2) + 2 * L + (2 * L + 1),
            "reduce_scatter": 2 * L + L + (2 * L + 1),
            "all_reduce": 1 + kv + 1}


@pytest.mark.parametrize("world,case", SHARDED, ids=SHARDED_IDS)
def test_collective_calls_per_step(world, case):
    """Every rank runs the derived operations in each step (the same count
    on every rank, or one would wait forever); the gradient alone runs
    them less the AdamW norm's all-reduce."""
    want = expected_calls(world, cases(world)[case].get("rs_seq", False))
    for rank in port(world):
        for step in rank[case]["steps"]:
            assert step["calls"] == want
        grad = dict(want, all_reduce=want["all_reduce"] - 1)
        assert rank[case]["grad_calls"] == grad


@pytest.mark.parametrize("case", list(cases(1)))
def test_one_rank_group_is_the_groupless_step(case):
    """At world 1 a gloo group of one changes nothing: the loss, gradients,
    losses, norms and params of two steps equal the groupless step's to the
    bit, and no collective runs."""
    got, one = port(1)[0][case], _one_rank()
    assert got["loss"] == one["loss"]
    for a, b in zip(got["steps"], one["steps"]):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
        assert a["calls"] == {}
    assert got["grad_calls"] == {}
    for key in ("grads", "params"):
        for (path, a), (_, b) in zip(_flat(got[key]), _flat(one[key])):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


# --------------------------------------------------------------------------- #
# elastic checkpoints
# --------------------------------------------------------------------------- #
ELASTIC_STEPS = 4                   # checkpoints at step 2 (every 2)


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """A world-2 run of 4 steps checkpointing at step 2, then runs at worlds
    4 and 1 into the same directory, each resuming at step 3."""
    ck = str(tmp_path_factory.mktemp("elastic"))
    spec = {"arch": ARCH, "shape": (B, S), "schedule": SCHEDULE,
            "ckpt_dir": ck, "steps": ELASTIC_STEPS}
    runs = {2: mesh.spawn(W.elastic_rank, 2, "cpu", args=(spec,))}
    assert latest_step(ck) == 2
    for world in (4, 1):
        runs[world] = mesh.spawn(W.elastic_rank, world, "cpu", args=(spec,))
    return ck, runs


@pytest.mark.parametrize("world", [1, 4])
def test_world_2_checkpoint_resumes_at(elastic, world):
    """The resumed run starts at step 3, and its loss there equals the
    uninterrupted world-2 run's within rtol 1e-5 (the same logical state
    and batch, summed in another order)."""
    _, runs = elastic
    whole = runs[2][0]
    assert whole["steps"] == list(range(ELASTIC_STEPS))
    for rank in runs[world]:
        assert rank["steps"] == [3]
        np.testing.assert_allclose(rank["losses"][0], whole["losses"][3],
                                   rtol=1e-5)


def test_reference_reads_the_logical_checkpoint(elastic):
    """The reference's ``restore_pytree`` reads the world-2 checkpoint into
    its own (params, AdamWState) tree: the params equal the world-2 ranks'
    step-2 shards unsharded, bit for bit, and the step count is 3."""
    ck, runs = elastic
    jm = jget_model(JARCHS[ARCH].reduced())
    like = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    (jp, jo), step = jckpt.restore_pytree((like, jadamw_init(like)), ck)
    assert step == 2 and int(jo.step) == 3
    want = _named(sharding.unshard_params(
        [rank["params"][2] for rank in runs[2]], CFG, 2))
    got = _named(jp)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_unshard_state_inverts_shard_state():
    """Params and AdamW moments cut for every rank of worlds 2 and 4 and
    rebuilt: every leaf back bit for bit, the step count whole."""
    from repro_torch.models.api import get_model
    from repro_torch.optim.adamw import adamw_init
    params = get_model(CFG).init(torch.Generator().manual_seed(5),
                                 device="cpu", masters=True)
    opt = adamw_init(params)
    opt.m["embed"].normal_()
    state = (params, opt)
    for world in (2, 4):
        cuts = [sharding.shard_state(state, CFG, r, world)
                for r in range(world)]
        back = sharding.unshard_state(cuts, CFG, world)
        assert back[1].step is opt.step
        for tree in range(2):
            for (path, a), (_, b) in zip(_flat(state[0] if tree == 0
                                               else state[1].m),
                                         _flat(back[0] if tree == 0
                                               else back[1].m)):
                assert torch.equal(a, b), path


# --------------------------------------------------------------------------- #
# fit_spec against the reference's
# --------------------------------------------------------------------------- #
FIT_CASES = {
    "gqa kv narrower than the span": ((None, "model"), (1536, 2),
                                      {"model": 4}),
    "gqa kv dim on a 16-way span": (("data", "model"), (1536, 256),
                                    {"data": 1, "model": 512}),
    "batch 1 moves to the sequence": (("data", None), (1, 2048),
                                      {"data": 8}),
    "batch 1 decode, 3 dims": (("data", None, "model"), (1, 4096, 1536),
                               {"data": 16, "model": 16}),
    "odd vocab": (("model", "data"), (151655, 1536),
                  {"model": 4, "data": 2}),
    "odd vocab, nowhere to go": (("model",), (151655,), {"model": 4}),
    "duplicate axis": (("model", "model"), (8, 8), {"model": 2}),
    "absent axis": (("pod", "model"), (8, 8), {"model": 2}),
    "two axes on one dim": ((("data", "model"), None), (16, 4),
                            {"data": 2, "model": 4}),
    "2-axis mesh, data homeless": (("data", "model"), (6, 8),
                                   {"data": 4, "model": 2}),
    "2-axis mesh, both fit": (("data", "model"), (8, 8),
                              {"data": 2, "model": 4}),
    "spec longer than the shape": (("data", None, "model"), (4, 4),
                                   {"data": 2, "model": 2}),
    "size-1 dim only": (("data",), (1,), {"data": 2}),
    "empty spec": ((), (4, 4), {"data": 2}),
}


class _Mesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_fit_spec_matches_reference(name):
    spec, shape, mesh_shape = FIT_CASES[name]
    want = tuple(jfit_spec(PartitionSpec(*spec), shape, _Mesh(mesh_shape)))
    assert sharding.fit_spec(spec, shape, mesh_shape) == want


def test_fit_specs_over_a_tree():
    specs = {"a": ("model",), "b": {"c": ("data", None)}}
    shapes = {"a": torch.empty(3), "b": {"c": (1, 8)}}
    assert sharding.fit_specs(specs, shapes, {"model": 2, "data": 2}) == \
        {"a": (), "b": {"c": (None, "data")}}


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
ARGV = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
        "--seq", "32", "--lr", "1e-2", "--ckpt-every", "2"]


def test_launcher_model_parallel_trains_and_resumes_at_4(tmp_path):
    """``--model-parallel 2`` (two gloo ranks, rank 0 printing) lowers the
    loss in 3 steps and checkpoints at step 2; a second run into the same
    directory at ``--model-parallel 4`` resumes at step 3."""
    ck = str(tmp_path / "ck")
    first = launch_train.main(ARGV + ["--steps", "3", "--ckpt-dir", ck,
                                      "--model-parallel", "2",
                                      "--psum-mode", "ina_ring"])
    assert first["steps"] == [0, 1, 2] and "state" not in first
    assert first["losses"][-1] < first["losses"][0]
    assert latest_step(ck) == 2
    second = launch_train.main(ARGV + ["--steps", "4", "--ckpt-dir", ck,
                                       "--model-parallel", "4"])
    assert second["steps"] == [3] and second["last"] == 4


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA group is valid here")


def test_launcher_model_parallel_on_cuda_without_gpus_raises(no_gpu, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", ARCH, "--reduced", "--device", "cuda",
                           "--model-parallel", "2", "--ckpt-dir",
                           str(tmp_path)])
