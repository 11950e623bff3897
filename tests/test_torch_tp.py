"""Tensor parallelism in the port, against the JAX package's unsharded model.

The reduced qwen2 (4 query heads, 2 KV heads, float32) with the reference's
weights (``Model.init(PRNGKey(3))``, its zero QKV biases replaced by seeded
values so that their cut is exercised) runs on 1, 2 and 4 gloo ranks, one
spawn a world with every case inside it (``tests/_torch_dist_workers.py``):
each psum mode, and at world 2 also ``rs_seq`` under each mode and
``sp_entry``.  Its forward, chunked-prefill and decode logits must match
the reference's unsharded ``forward``, ``prefill`` and ``decode_step``
within the port's model tolerance (rtol = atol = 1e-4,
``tests/test_torch_models.py``), and the engine's greedy tokens at worlds 2
and 4 must equal world 1's.  The world-4 spawn also runs the uneven head
cut (``tests/_torch_uneven_cases.py``): the reduced config at 6 and 10
query heads, whose forward, decode and gradient must match the
reference's, and whose AdamW state holds each rank's real heads only.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model
from repro.models.api import param_specs as jparam_specs
from repro.parallel.tp import combine_experts as jcombine

from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core.collectives import CLI_PSUM_MODES
from repro_torch.launch import mesh
from repro_torch.launch import serve as launch_serve
from repro_torch.parallel import sharding

import _torch_dist_workers as W
import _torch_uneven_cases as U

ARCH = "qwen2-1.5b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, MAX_SEQ = 2, 8, 16
CHUNKS = ((0, 4), (4, 8))
DECODE = 2
PROMPTS = ((5, 9, 11, 3, 7, 2), (8, 8, 1, 4, 6, 10), (12, 3, 3, 9, 1, 5))
GEN = 5


def cases(world: int) -> dict:
    out = {m: {"psum_mode": m} for m in CLI_PSUM_MODES}
    if world == 2:
        out.update({f"{m}+rs_seq": {"psum_mode": m, "rs_seq": True}
                    for m in CLI_PSUM_MODES})
        out["ina+rs_seq+sp_entry"] = {"psum_mode": "ina", "rs_seq": True,
                                      "sp_entry": True}
    return out


CASE_IDS = [(w, c) for w in (1, 2, 4) for c in cases(w)]


@functools.cache
def reference():
    """The reference's params (numpy), inputs and unsharded logits."""
    jm = jget_model(JARCHS[ARCH].reduced())
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        leaf = jp["layers"]["attn"][name]
        jp["layers"]["attn"][name] = jnp.asarray(
            0.1 * rng.standard_normal(leaf.shape).astype(np.float32))
    params = jax.tree.map(np.asarray, jp)
    vocab = jm.cfg.vocab
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    dec = [rng.integers(0, vocab, (B,)).astype(np.int32) for _ in range(DECODE)]
    want = {"forward": np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}))}
    jc = jm.init_cache(B, MAX_SEQ)
    want["prefill"] = []
    for p0, p1 in CHUNKS:
        logits, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, p0:p1])}, jc,
                                pos_offset=p0)
        want["prefill"].append(np.asarray(logits))
    want["decode"] = []
    for pos, tok in enumerate(dec, start=S):
        logits, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tok[:, None]),
                                         "pos": jnp.asarray(pos, jnp.int32)}, jc)
        want["decode"].append(np.asarray(logits))
    comb = rng.standard_normal((B, 3, 4, 5)).astype(np.float32)
    experts = rng.standard_normal((4, 5, 6)).astype(np.float32)
    want["combine"] = np.asarray(jcombine(jnp.asarray(comb),
                                          jnp.asarray(experts)))
    spec = {"arch": ARCH, "params": params, "tokens": toks,
            "decode_tokens": dec, "chunks": CHUNKS, "max_seq": MAX_SEQ,
            "prompts": PROMPTS, "gen": GEN, "engine_modes": CLI_PSUM_MODES,
            "combine": (comb, experts)}
    return spec, want


@functools.cache
def port(world: int) -> list:
    spec, _ = reference()
    spec = {**spec, "cases": cases(world)}
    if world != 2:
        del spec["combine"]
    if world == U.WORLD:
        spec["uneven"] = U.specs(ARCH)
    return mesh.spawn(W.tp_rank, world, "cpu", args=(spec,))


@pytest.mark.parametrize("phase", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("world,case", CASE_IDS,
                         ids=[f"w{w}-{c}" for w, c in CASE_IDS])
def test_tp_logits_match_unsharded_reference(world, case, phase):
    """Every rank returns the whole vocabulary's logits (gathered), each
    within the model tolerance of the reference's."""
    _, want = reference()
    for rank in port(world):
        got = rank[case][phase]
        if phase == "forward":
            got, ref = [got], [want["forward"]]
        else:
            ref = want[phase]
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, **TOL)


@pytest.mark.parametrize("phase", U.PHASES)
@pytest.mark.parametrize("label", list(U.HEADS))
def test_uneven_head_cut_matches_unsharded_reference(label, phase):
    """The reduced qwen2 set to 6 (and 10) query heads and 2 KV heads at
    world 4, in the world-4 spawn: ranks with two heads, one straddling
    both KV heads, one with none (at 10: three slots, rank 1's K/V
    expanded to one head a query head); forward, decode and the
    gradient against the reference's unsharded model, the engine's
    tokens against one rank's (``tests/_torch_uneven_cases.py``)."""
    U.check(ARCH, label, phase, port(U.WORLD))


@pytest.mark.parametrize("label", list(U.HEADS))
def test_uneven_head_cut_adamw_holds_real_heads(label):
    U.check_adamw(ARCH, label, port(U.WORLD))


@pytest.mark.parametrize("mode", CLI_PSUM_MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_engine_tokens_match_one_rank(world, mode):
    """Greedy tokens on 2 and 4 ranks equal one rank's (the engine checks
    at every retire that all ranks agree)."""
    one = port(1)[0]["engine"][mode]
    assert len(one) == len(PROMPTS)
    for rank in port(world):
        assert rank["engine"][mode] == one


@pytest.mark.parametrize("mode", CLI_PSUM_MODES)
def test_combine_experts_matches_reference(mode):
    """The MoE INA site at world 2: each rank's 2 of 4 experts, partial
    sums accumulated under ``mode``, equal the reference's einsum."""
    _, want = reference()
    for rank in port(2):
        np.testing.assert_allclose(rank["combine"][mode], want["combine"],
                                   rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# the shards themselves (this process)
# --------------------------------------------------------------------------- #
def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3-8b"])
def test_shards_concatenate_to_the_params(arch, world):
    """Concatenating the ranks' shards along the cut dim rebuilds every
    converted leaf (a KV head that several ranks share counted once)."""
    cfg = ARCHS[arch].reduced()
    jp = jget_model(JARCHS[arch].reduced()).init(jax.random.PRNGKey(1))
    # every element distinct (the init's biases are zeros), so a shard that
    # two ranks share is told apart from two shards that happen to agree
    jp = jax.tree.map(lambda a: np.arange(a.size, dtype=np.float32).reshape(
        a.shape), jp)
    full = params_from_jax(jp, cfg, device="cpu")
    shards = [dict(_flat(sharding.shard_params(full, cfg, r, world)))
              for r in range(world)]
    cut = 0
    for path, leaf in _flat(full):
        parts = [s[path] for s in shards]
        if all(p.shape == leaf.shape for p in parts):
            for p in parts:
                assert torch.equal(p, leaf), path
            continue
        cut += 1
        dim = next(d for d, (a, b) in enumerate(zip(parts[0].shape,
                                                    leaf.shape)) if a != b)
        distinct = [p for i, p in enumerate(parts)
                    if i == 0 or not torch.equal(p, parts[i - 1])]
        assert torch.equal(torch.cat(distinct, dim), leaf), path
        for p in parts:
            assert p.is_contiguous()
    # per layer: wq bq wk bk wv bv wo w_up w_gate w_down (+ embed or lm_head)
    assert cut >= 8


def test_head_split_whole_heads():
    """qwen2-1.5b (12 query heads, 2 KV heads) at world 4: 3 query heads a
    rank and KV head rank // 2; world 2: one KV head each.  A world that
    does not divide the query heads takes the uneven head cut (the dense
    family): ``ceil(12/world)`` query-head slots a rank, the real heads
    only, the KV heads they read (at 5: rank 2's heads 6-8 read KV heads
    1 only, at 8 rank 2's 4 and 5 read KV head 0); a family without it (the
    vlm's 32 heads at 5 and 6) raises, naming the family."""
    cfg = ARCHS["qwen2-1.5b"]
    for r in range(4):
        q, kv = sharding.head_split(cfg, r, 4)
        assert (list(q), list(kv)) == ([3 * r, 3 * r + 1, 3 * r + 2], [r // 2])
    assert [list(sharding.head_split(cfg, r, 2)[1]) for r in (0, 1)] == [[0], [1]]
    assert sharding.local_heads(ARCHS["llama3-8b"], 4) == (8, 2)
    five = [tuple(map(list, sharding.head_split(cfg, r, 5)))
            for r in range(5)]
    assert five == [([0, 1, 2], [0]), ([3, 4, 5], [0]), ([6, 7, 8], [1]),
                    ([9, 10, 11], [1]), ([], [])]
    eight = [tuple(map(list, sharding.head_split(cfg, r, 8)))
             for r in range(8)]
    assert eight == [([2 * r, 2 * r + 1], [r // 3]) for r in range(6)] + \
        [([], [])] * 2
    for world in (5, 6):
        with pytest.raises(ValueError, match="do not divide.*vlm family"):
            sharding.head_split(ARCHS["llama-3.2-vision-11b"], 0, world)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3-8b", "rwkv6-7b"])
@pytest.mark.parametrize("span", [1, 2, 4, 16])
def test_leaf_rules_match_reference(arch, span):
    """The port's copy of the name rules gives the reference's spec for
    every leaf of the reduced and the published configs."""
    for cfg in (JARCHS[arch].reduced(), JARCHS[arch]):
        shapes = jax.eval_shape(jget_model(cfg).init, jax.random.PRNGKey(0))

        class FakeMesh:
            shape = {"data": 1, "model": span}
        want = dict(_flat(jax.tree.map(tuple, jparam_specs(shapes, FakeMesh()),
                                       is_leaf=lambda x: isinstance(
                                           x, jax.sharding.PartitionSpec))))
        tree = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                            shapes)
        got = {path: sharding.leaf_spec(path, tuple(leaf.shape),
                                        {"data": 1, "model": span})
               for path, leaf in _flat(tree)}
        assert got.keys() == want.keys()
        for path in want:
            assert got[path] == want[path], path


@pytest.mark.parametrize("arch,world", [
    ("qwen2-1.5b", 1), ("qwen2-1.5b", 2), ("qwen2-1.5b", 4),
    ("qwen2-1.5b", 6), ("llama3-8b", 2), ("llama3-8b", 8),
    ("llama3-8b", 16)])
def test_shards_of_the_published_widths(arch, world):
    """Every rank's shard of the published config (meta tensors) has the
    shape its config gives: H/world query heads, the KV heads they read,
    d_ff/world of the MLP, V/world of the table and of an untied head where
    world divides V, else the whole of them; every other leaf whole.  A world that divides the
    heads but not d_ff (qwen2 at 6) raises rather than serve each rank the
    whole MLP, which the row psum would count ``world`` times."""
    cfg = ARCHS[arch]
    shapes = jax.eval_shape(jget_model(JARCHS[arch]).init,
                            jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)
    if cfg.d_ff % world:
        with pytest.raises(ValueError, match="do not divide"):
            sharding.shard_params(tree, cfg, 0, world)
        return
    hd, d = cfg.resolved_head_dim, cfg.d_model
    hl = cfg.n_heads // world
    kl = cfg.n_kv_heads // world if cfg.n_kv_heads % world == 0 else 1
    fl = cfg.d_ff // world
    rows = cfg.vocab // world if cfg.vocab % world == 0 else cfg.vocab
    want = {"wq": (d, hl * hd), "bq": (hl * hd,), "wk": (d, kl * hd),
            "bk": (kl * hd,), "wv": (d, kl * hd), "bv": (kl * hd,),
            "wo": (hl * hd, d), "w_up": (d, fl), "w_gate": (d, fl),
            "w_down": (fl, d), "embed": (rows, d), "lm_head": (d, rows)}
    full = dict(_flat(tree))
    for rank in range(world):
        for path, leaf in _flat(sharding.shard_params(tree, cfg, rank,
                                                      world)):
            lead = tuple(full[path].shape[:1]) if path[0] == "layers" else ()
            assert tuple(leaf.shape) == lead + want.get(
                path[-1], tuple(full[path].shape)[len(lead):]), path


def test_launcher_model_parallel_matches_one_rank():
    """``serve --model-parallel 2`` (two spawned gloo ranks, rank 0
    printing) serves the tokens one rank serves, on the engine and on the
    legacy loop."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "3",
            "--slots", "2", "--prompt-len", "6", "--gen", "4",
            "--prefill-chunk", "4", "--block-size", "4", "--check"]
    one = launch_serve.main(argv)
    assert launch_serve.main(argv + ["--model-parallel", "2", "--psum-mode",
                                     "ina_ring"]) == one
    legacy = argv + ["--legacy-loop"]
    assert launch_serve.main(legacy + ["--model-parallel", "2", "--psum-mode",
                                       "eject_inject"]) == \
        launch_serve.main(legacy)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA group is valid here")


def test_model_parallel_on_cuda_without_gpus_raises(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cuda",
                           "--model-parallel", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.init_group(2, 0, "cuda", "/nonexistent/store")
