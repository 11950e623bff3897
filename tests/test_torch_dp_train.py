"""Data-parallel and FSDP training in the port on the rank mesh, against
the JAX package's unsharded step, on gloo ranks on the CPU.

The reduced qwen2 (4 query heads, 2 KV heads; float32) with the
reference's weights (``Model.init(PRNGKey(3))``, its zero QKV biases
replaced by seeded values), B 4 x S 16, on three meshes, one spawn each
with every case inside it (``tests/_torch_dist_workers.py``):
``(data 2, model 1)``, ``(data 2, model 2)`` under each psum mode, and
``(pod 2, data 2, model 1)``.  Each rank holds its FSDP piece
(``shard_params`` at ``(data, model)``) and trains on its rows of the
global batch.

* The loss of the global batch and every gradient leaf, rebuilt with
  ``unshard_params`` from the ranks of pod 0, against
  ``jax.value_and_grad`` of the reference's ``loss`` on the whole batch
  (``tests/test_torch_tp_train.py``'s tolerances: loss rtol 1e-5, each
  leaf rtol 1e-4 plus atol 1e-5 of the leaf's largest); pod 1's pieces
  bit-equal to pod 0's.
* Two AdamW steps against the one-rank step on the whole batch: loss and
  ``grad_norm`` within rtol 1e-5, moments and params as
  ``tests/test_torch_tp_train.py`` holds them; every rank's piece
  bit-equal to its cut of the rebuilt params (the replicas agree).
* A step's collective calls by kind, against the count derived from the
  mesh.
* ``shard_params`` / ``unshard_params`` round trips, ``data_cut``'s dims,
  ``leaf_holding`` and ``kv_groups`` on the 2-D coordinate, the
  ``RankMesh`` layout against ``jax.make_mesh``'s (row-major), the
  refusals (``--production-mesh`` short of 256 ranks, a batch the data
  ranks do not divide), and a ``(2, 2)`` checkpoint resumed at ``(1, 1)``
  and ``(4, 1)`` through the launcher.
"""
import collections
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.api import get_model as jget_model
from repro.configs import ARCHS as JARCHS

from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.collectives import CLI_PSUM_MODES, AxisSpan
from repro_torch.launch import mesh
from repro_torch.launch import train as launch_train
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import adamw_init, tree_map
from repro_torch.parallel import sharding
from repro_torch.parallel.steps import build_train_step
from repro_torch.parallel.tp import ParallelCtx

import _torch_dist_workers as W

ARCH = "qwen2-1.5b"
B, S = 4, 16
SCHEDULE = {"base_lr": 3e-4, "warmup": 1, "total_steps": 10}
CFG = ARCHS[ARCH].reduced()
L = CFG.n_layers
MESHES = {"d2": ((2, 1), ("data", "model")),
          "d2m2": ((2, 2), ("data", "model")),
          "p2d2": ((2, 2, 1), ("pod", "data", "model"))}


def cases(name: str) -> dict:
    modes = CLI_PSUM_MODES if name == "d2m2" else ("ina",)
    return {m: {"psum_mode": m} for m in modes}


CASE_IDS = [(n, c) for n in MESHES for c in cases(n)]
IDS = [f"{n}-{c}" for n, c in CASE_IDS]


def _spans(name: str) -> tuple:
    """(P, D, M) of a mesh."""
    ranks = mesh.RankMesh(*MESHES[name])
    return ranks.span("pod"), ranks.span("data"), ranks.span("model")


def _pair(rng, vocab):
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


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
def port(name: str) -> list:
    spec, _, _ = reference()
    return mesh.spawn(W.dp_train_rank, mesh.RankMesh(*MESHES[name]).size,
                      "cpu", args=({**spec, "mesh": MESHES[name],
                                    "cases": cases(name)},))


def _torch_numpy(tree):
    return {k: _torch_numpy(v) if isinstance(v, dict)
            else v.detach().numpy().copy() for k, v in tree.items()}


@functools.cache
def one_rank() -> dict:
    """The one-rank step, no group, on the whole batches."""
    spec, _, _ = reference()
    model = get_model(CFG)
    params = params_from_jax(spec["params"], CFG, device="cpu", masters=True)
    ts = build_train_step(model, ShapeConfig("t", S, B, "train"), **SCHEDULE)
    opt, steps = adamw_init(params), []
    for pair in spec["step_batches"]:
        params, opt, st = ts.fn(params, opt, W._batch(pair))
        steps.append({k: float(st[k]) for k in ("loss", "grad_norm", "lr")})
    return {"steps": steps, "params": _torch_numpy(params),
            "m": _torch_numpy(opt.m), "v": _torch_numpy(opt.v)}


def _unshard(name: str, case: str, key: str, plane: int = 0) -> dict:
    """``key``'s logical tree from the ranks of pod ``plane``."""
    _, dd, mm = _spans(name)
    ranks = port(name)[plane * dd * mm:(plane + 1) * dd * mm]
    return sharding.unshard_params([r[case][key] for r in ranks], CFG,
                                   (dd, mm))


def _assert_leaves_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=key)


def _flat(tree, names=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, names + (k,))
        else:
            yield names + (k,), v


# --------------------------------------------------------------------------- #
# the step against the reference and the one-rank step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name,case", CASE_IDS, ids=IDS)
def test_loss_and_grads_match_unsharded_reference(name, case):
    """Every rank's loss is the global batch's, and the logical gradient
    rebuilt from pod 0's pieces is ``jax.value_and_grad``'s on the whole
    batch; every rank trains on its own rows (host ``p * D + d``), and
    pod 1's pieces equal pod 0's to the bit."""
    _, jloss, jgrads = reference()
    pp, dd, mm = _spans(name)
    ranks = port(name)
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank[case]["loss"], jloss, rtol=1e-5)
        at = rank["coords"]
        assert rank[case]["host"] == (at["pod"] * dd + at["data"], pp * dd)
    got = _named(_unshard(name, case, "grads"))
    _assert_leaves_close(got, jgrads)
    assert all(np.abs(g).max() > 0 for g in got.values())
    for plane in range(1, pp):
        for (path, a), (_, b) in zip(
                _flat(_unshard(name, case, "grads", plane)),
                _flat(_unshard(name, case, "grads"))):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("name,case", CASE_IDS, ids=IDS)
def test_two_adamw_steps_match_one_rank(name, case):
    """Each step's loss and ``grad_norm`` (the norm over the logical
    arrays: cut pieces summed over data and model, whole leaves counted
    once) within rtol 1e-5 of the one-rank step's on the whole batch; after
    two steps the moments (m, and sqrt(v)) and the params, unsharded,
    within the leaf tolerance.  AdamW moves an element by about lr whatever
    its gradient's size, so an element's update is known only as well as
    its gradient's direction: where sqrt(v) is under 1e-3 of its leaf's
    largest (within 100 times the gradient tolerance's floor, 1e-5 of the
    leaf's largest, so that its relative error may pass 1%) the element is
    held only to AdamW's bound, |m-hat| / sqrt(v-hat) <= 1 at each step.
    (``tests/test_torch_tp_train.py`` cuts at 1e-5: here the data axis
    sums the rows' gradients in another order, and one ``bk`` element at
    1.6e-5 of its leaf's largest, a gradient of 1.8e-8 beside a summation
    error of 1.7e-8, moves 3.9e-6 away, past that cut.)"""
    one = one_rank()
    for rank in port(name):
        for got, want in zip(rank[case]["steps"], one["steps"]):
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-5)
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            assert got["lr"] == want["lr"]
    _assert_leaves_close(_named(_unshard(name, case, "m")), _named(one["m"]))
    rms = {k: np.sqrt(v) for k, v in _named(one["v"]).items()}
    _assert_leaves_close({k: np.sqrt(v) for k, v in
                          _named(_unshard(name, case, "v")).items()}, rms)
    got, want = _named(_unshard(name, case, "params")), _named(one["params"])
    moved = 2 * sum(s["lr"] for s in one["steps"])
    resolved = 0
    for key, w in want.items():
        atol = 1e-5 * float(np.abs(w).max())
        sure = rms[key] > 1e-3 * rms[key].max()
        np.testing.assert_allclose(got[key][sure], w[sure], rtol=1e-4,
                                   atol=atol, err_msg=key)
        assert np.all(np.abs(got[key] - w) <= moved + atol), key
        resolved += sure.sum() / sure.size / len(want)
    assert resolved > 0.9


@pytest.mark.parametrize("name,case", CASE_IDS, ids=IDS)
def test_every_replica_of_a_piece_agrees(name, case):
    """After two steps every rank's params are, to the bit, its cut of the
    logical params rebuilt from the first holder of each piece: pieces
    held by several ranks (over pod, over data where a leaf is whole
    there, over model where it is whole there) stay equal."""
    _, dd, mm = _spans(name)
    logical = tree_map(torch.from_numpy, _unshard(name, case, "params"))
    for rank in port(name):
        at = rank["coords"]
        mine = sharding.shard_params(logical, CFG, (at["data"], at["model"]),
                                     (dd, mm))
        for (path, a), (_, b) in zip(_flat(rank[case]["params"]),
                                     _flat(mine)):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=str(path))


def expected_calls(name: str) -> tuple:
    """(the gradient's group operations on each rank, a whole step's), by
    kind, derived from the mesh.  The model axis at M > 1 runs the
    tensor-parallel step's (``tests/test_torch_tp_train.py``:
    ``expected_calls``, no KV head shared at M 2).  The data axis at D > 1
    gathers the leaves outside the layers once (one all-gather) and each
    layer's pieces inside its checkpointed body, in its forward and again
    in its recompute (2 L all-gathers), and reduce-scatters each of those
    L + 1 gradients in the backward; one all-reduce sums the whole leaves'
    gradients with the loss (one float32 bucket each); the pod axis at
    P > 1 one all-reduce.  AdamW's norm all-reduces over data and over
    model, where each spans more than one rank."""
    pp, dd, mm = _spans(name)
    grad = collections.Counter()
    if mm > 1:
        grad.update(psum=1 + 3 * L, all_gather=1, all_reduce=2 * L + 1)
    if dd > 1:
        grad.update(all_gather=1 + 2 * L, reduce_scatter=1 + L,
                    all_reduce=1)
    if pp > 1:
        grad.update(all_reduce=1)
    step = grad + collections.Counter(all_reduce=(dd > 1) + (mm > 1))
    return dict(grad), dict(step)


@pytest.mark.parametrize("name,case", CASE_IDS, ids=IDS)
def test_gathered_bytes_stay_within_two_layers(name, case):
    """At D > 1 the FSDP gathers of one gradient are the leaves outside
    the layers once, then each layer's pieces in its forward and again in
    its recompute (1 + 2 L all-gathers, each the whole of what it
    gathers), and the most gathered bytes alive at once on a rank is at
    most the outside leaves plus two layers' whole weights (float32
    masters; together the leaves of the model shard at M that ``data``
    cuts), at least the outside leaves plus one layer."""
    _, dd, mm = _spans(name)
    cut = sum(v.numel() * 4 for n, v in _flat(sharding.shard_params(
        _masters(), CFG, 0, mm)) if sharding.data_cut(n, CFG, (dd, mm))
        is not None)
    for rank in port(name):
        g = rank[case]["gathered"]
        if dd == 1:
            assert g == {"calls": [], "peak": 0}
            continue
        outside, layers = g["calls"][0], g["calls"][1:]
        assert len(layers) == 2 * L and layers[:L] == layers[L:]
        assert outside + sum(layers[:L]) == cut
        assert outside + max(layers) <= g["peak"] \
            <= outside + 2 * max(layers)


@pytest.mark.parametrize("name,case", CASE_IDS, ids=IDS)
def test_collective_calls_per_step(name, case):
    grad, step = expected_calls(name)
    for rank in port(name):
        assert rank[case]["grad_calls"] == grad
        for s in rank[case]["steps"]:
            assert s["calls"] == step


# --------------------------------------------------------------------------- #
# shards on the 2-D coordinate, without spawning
# --------------------------------------------------------------------------- #
def _masters(seed: int = 5) -> dict:
    return get_model(CFG).init(torch.Generator().manual_seed(seed),
                               device="cpu", masters=True)


@pytest.mark.parametrize("world", [(2, 2), (4, 1), (2, 1), (1, 4)])
def test_shard_then_unshard_round_trips(world):
    """Params and AdamW moments cut for every rank of ``(D, M)`` and rebuilt
    bit for bit; each rank holds a D*M-th of every leaf both axes cut."""
    params = _masters()
    opt = adamw_init(params)
    opt.m["embed"].normal_()
    n = world[0] * world[1]
    cuts = [sharding.shard_state((params, opt), CFG, r, world)
            for r in range(n)]
    back = sharding.unshard_state(cuts, CFG, world)
    assert back[1].step is opt.step
    for a, b in ((params, back[0]), (opt.m, back[1].m)):
        for (path, x), (_, y) in zip(_flat(a), _flat(b)):
            assert torch.equal(x, y), path
    assert cuts[n - 1][0]["layers"]["mlp"]["w_up"].numel() * n == \
        params["layers"]["mlp"]["w_up"].numel()


DATA_DIMS = {("embed",): 1, ("layers", "attn", "wq"): 1,
             ("layers", "attn", "wk"): 1, ("layers", "attn", "wo"): 2,
             ("layers", "mlp", "w_up"): 1, ("layers", "mlp", "w_down"): 2,
             ("layers", "attn", "bq"): None, ("layers", "ln1"): None,
             ("ln_f",): None}


@pytest.mark.parametrize("names", list(DATA_DIMS), ids=["/".join(n) for n in
                                                        DATA_DIMS])
def test_data_cut_dims(names):
    """``data`` on a column-parallel weight's input dim, a row-parallel
    weight's and the embedding's d_model, never a stacked leaf's L; none on
    norms and biases; none where D does not divide the model shard."""
    assert sharding.data_cut(names, CFG, (2, 2)) == DATA_DIMS[names]
    assert sharding.data_cut(names, CFG, (1, 2)) is None
    assert sharding.data_cut(names, CFG, (3, 1)) is None


@pytest.mark.parametrize("world", [(2, 2), (2, 4), (4, 1)])
def test_leaf_holding_counts_each_piece_once(world):
    """Over the data x model plane the ``"cut"`` pieces of a leaf hold its
    sum of squares once (what AdamW's norm all-reduces); a leaf neither
    axis cuts is ``"whole"`` on every rank."""
    params = _masters()
    n = world[0] * world[1]
    cuts = [dict(_flat(sharding.shard_params(params, CFG, r, world)))
            for r in range(n)]
    kinds = [dict(_flat(sharding.leaf_holding(
        sharding.shard_params(params, CFG, r, world), CFG, r, world)))
        for r in range(n)]
    for path, leaf in _flat(params):
        ks = [k[path] for k in kinds]
        if "whole" in ks:
            assert set(ks) == {"whole"}, path
            continue
        got = sum(float(cuts[r][path].double().square().sum())
                  for r in range(n) if ks[r] == "cut")
        np.testing.assert_allclose(got, float(leaf.double().square().sum()),
                                   rtol=1e-12, err_msg=str(path))


def test_kv_groups_on_the_mesh():
    """The ranks that share a KV head, in each data row of the mesh."""
    assert sharding.kv_groups(CFG, (2, 4)) == [[0, 1], [2, 3], [4, 5],
                                               [6, 7]]
    assert sharding.kv_groups(CFG, 4) == [[0, 1], [2, 3]]
    assert sharding.kv_groups(CFG, (2, 2)) == []
    with pytest.raises(ValueError, match="rank"):
        sharding.shard_params(_masters(), CFG, (0, 1), 2)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rank_mesh_layout_is_make_mesh_row_major(multi_pod):
    ranks = mesh.make_production_mesh(multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    assert ranks.shape == shape and ranks.size == int(np.prod(shape))
    np.testing.assert_array_equal(ranks.devices(),
                                  np.arange(ranks.size).reshape(shape))
    for r in (0, 17, ranks.size - 1):
        at = ranks.coords(r)
        assert ranks.devices()[tuple(at[a] for a in ranks.axes)] == r
    for axis in ranks.axes:
        lines = ranks.lines(axis)
        assert len(lines) == ranks.size // ranks.span(axis)
        assert sorted(r for line in lines for r in line) == \
            list(range(ranks.size))
    assert ranks.lines("model")[1] == list(range(16, 32))
    assert mesh.make_host_mesh(8, 2).pairs == (("data", 4), ("model", 2))
    assert mesh.make_host_mesh(1, 4).pairs == (("data", 1), ("model", 1))


# --------------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------------- #
ARGV = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "8",
        "--seq", "32", "--lr", "1e-2", "--ckpt-every", "2"]


def test_production_mesh_needs_256_ranks(tmp_path):
    with pytest.raises(RuntimeError, match="256 ranks"):
        launch_train.main(ARGV + ["--steps", "1", "--ckpt-dir",
                                  str(tmp_path), "--production-mesh",
                                  "--ranks", "4"])


def test_batch_the_data_ranks_do_not_divide_raises(tmp_path):
    """3 data ranks for a batch of 4 rows (the step, here on a span with no
    processes) or of 8 (the launcher) raise before any rank starts."""
    model = get_model(CFG)
    with pytest.raises(ValueError, match="does not divide over 3"):
        build_train_step(model, ShapeConfig("t", S, 4, "train"),
                         ParallelCtx(data_group=AxisSpan(3)))
    with pytest.raises(ValueError, match="does not divide"):
        launch_train.main(ARGV + ["--steps", "1", "--ckpt-dir",
                                  str(tmp_path), "--ranks", "3"])


# --------------------------------------------------------------------------- #
# a (2, 2) checkpoint resumed on other meshes
# --------------------------------------------------------------------------- #
RESUME_STEPS = 6


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """An uninterrupted ``(data 2, model 2)`` run of 6 steps checkpointing
    every 2, then runs of the same 6 steps into a copy of its directory cut
    back to the step-2 checkpoint, at ``(1, 1)`` and ``(data 4, model
    1)``."""
    root = tmp_path_factory.mktemp("dp_resume")
    argv = ARGV + ["--steps", str(RESUME_STEPS)]
    whole = launch_train.main(argv + ["--ckpt-dir", str(root / "whole"),
                                      "--ranks", "4", "--model-parallel",
                                      "2"])
    runs = {}
    for label, extra in (("1x1", ["--ranks", "1"]), ("4x1", ["--ranks", "4"])):
        ck = root / label
        shutil.copytree(root / "whole", ck)
        for d in ck.iterdir():
            if d.name != "step_00000002":
                shutil.rmtree(d)
        assert latest_step(str(ck)) == 2
        runs[label] = launch_train.main(argv + ["--ckpt-dir", str(ck)]
                                        + extra)
    return whole, runs


@pytest.mark.parametrize("label", ["1x1", "4x1"])
def test_2x2_checkpoint_resumes_at(resumed, label):
    """The resumed run starts at step 3, and each of its steps' losses is
    the uninterrupted run's within rtol 1e-5."""
    whole, runs = resumed
    assert whole["steps"] == list(range(RESUME_STEPS))
    assert runs[label]["steps"] == list(range(3, RESUME_STEPS))
    np.testing.assert_allclose(runs[label]["losses"], whole["losses"][3:],
                               rtol=1e-5)
