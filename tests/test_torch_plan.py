"""The port's plan layer (``repro_torch.plan``) against the reference's.

* ``gemm_layers`` / ``transformer_gemms`` and the mapper's verdicts
  (``gemm_verdicts``) equal the reference's field by field;
* ``build_plan``'s psum decisions equal the reference's ``resolve_sites``
  over its own ``collect_psum_sites`` (traced on an ``AbstractMesh`` built
  here: the reference's ``trace_mesh`` passes pairs, which some JAX
  versions refuse).  The reference traces its ``lax.scan`` body once, the
  port's Python loop every layer, so the port's ``count`` is the
  reference's times ``n_layers``; every other field is equal;
* the Hopper tile policy is ``plan_matmul`` itself and free of
  ``verify_plan`` findings, and the verifier catches launches the kernel
  cannot make;
* the store: byte-deterministic JSON, round trip, schema and config-edit
  invalidation, a corrupt file and a reference plan read as cold, no
  collective simulation on a warm load;
* the consumers: ``resolve_auto_mode`` on a plan hit and miss,
  ``ops.matmul(plan=)`` on aligned and unaligned operands, the ``meta``
  path, and the reduced qwen2 served under ``--psum-mode auto`` through
  plans with the planless run's tokens at world 1 and at world 2 (gloo);
* a ``gpu`` test: the planned decode step on the card equals the planless
  one to the bit.
"""
import dataclasses
import functools
import json
import re
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.core.ops import transformer_gemms as jtransformer_gemms
from repro.models.api import get_model as jget_model
from repro.plan import builder as jbuilder
from repro.plan.plan import ExecutionPlan as JExecutionPlan
from repro.plan.plan import plan_key as jplan_key
from repro.plan.plan import plan_schema_hash as jplan_schema_hash
from repro.plan.store import PLAN_DIR_ENV as JPLAN_DIR_ENV
from repro.plan.store import default_plan_dir as jdefault_plan_dir

from repro_torch.analysis import VerificationError, verify_plan
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import collectives as C
from repro_torch.core.noc import simcache
from repro_torch.core.noc.collective import cost
from repro_torch.core.ops import transformer_gemms
from repro_torch.kernels import ina_matmul as im
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.mapper import search_network
from repro_torch.mapper.space import Mapping, QUICK_MAPPER
from repro_torch.models.api import get_model
from repro_torch.parallel.tp import ParallelCtx
from repro_torch.plan import (PHASES, PlanStore, TileChoice, build_plan,
                              choose_tiles, gemm_verdicts,
                              plan_key, plan_schema_hash, tile_working_set)
from repro_torch.plan.builder import PHASE_SHAPES, resolve_sites
from repro_torch.plan.plan import ExecutionPlan, PsumDecision
from repro_torch.plan.tiles import SMEM_LIMIT

ROOT = Path(__file__).resolve().parents[1]
MESH_16 = (("data", 16), ("model", 16))
QWEN2, LLAMA3 = "qwen2-1.5b", "llama3-8b"


def _abstract_mesh(pairs):
    """The reference's mesh for a trace: ``AbstractMesh(sizes, names)``,
    or the pairs form on JAX versions that take that one."""
    sizes = tuple(s for _, s in pairs)
    names = tuple(a for a, _ in pairs)
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(pairs))


@functools.cache
def reference_sites(name: str, reduced: bool, pairs: tuple, phase: str):
    cfg = JARCHS[name].reduced() if reduced else JARCHS[name]
    return jbuilder.collect_psum_sites(cfg, _abstract_mesh(pairs),
                                       JSHAPES[PHASE_SHAPES[phase]])


@functools.cache
def reference_decisions(name: str, reduced: bool, pairs: tuple, phase: str,
                        chips: int = 1, package: str = "mesh"):
    return jbuilder.resolve_sites(reference_sites(name, reduced, pairs,
                                                  phase),
                                  chips=chips, package=package)


@functools.cache
def chip_smoke():
    """``chip_smoke.py`` as a module (its constants)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _port_cfg(name: str, reduced: bool):
    return ARCHS[name].reduced() if reduced else ARCHS[name]


@pytest.fixture
def plan_env(tmp_path, monkeypatch):
    """Plans and the sim store under ``tmp_path``, and nothing persisted
    once the test is over."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_DIR", str(tmp_path / "plans"))
    monkeypatch.setenv("REPRO_TORCH_SIMCACHE_DIR", str(tmp_path / "sims"))
    saved = simcache.SIM_CACHE._persist_dir
    simcache.SIM_CACHE._persist_dir = None
    yield tmp_path
    simcache.SIM_CACHE._persist_dir = saved


# --------------------------------------------------------------------------- #
# GEMM layers and mapper verdicts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tokens", [256, 2])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_gemm_layers_match_reference(name, tokens):
    want = jget_model(JARCHS[name]).gemm_layers(tokens)
    assert [dataclasses.astuple(g) for g in
            get_model(ARCHS[name]).gemm_layers(tokens)] == \
        [dataclasses.astuple(g) for g in want]
    assert [dataclasses.astuple(g) for g in
            transformer_gemms(ARCHS[name], tokens)] == \
        [dataclasses.astuple(g) for g in jtransformer_gemms(JARCHS[name],
                                                            tokens)]


@pytest.mark.parametrize("name,tokens", [(QWEN2, 256), (QWEN2, 2),
                                         (LLAMA3, 256)])
def test_gemm_verdicts_match_reference(name, tokens):
    got, hw = gemm_verdicts(ARCHS[name], tokens)
    want, jhw = jbuilder.gemm_verdicts(JARCHS[name], tokens)
    assert hw == jhw
    assert [dataclasses.asdict(v) for v in got] == \
        [dataclasses.asdict(v) for v in want]


def _layers():
    from repro.core.ina_model import ConvLayer as JConv
    from repro_torch.core.ina_model import ConvLayer
    return [(jl, tl) for jl, tl in
            zip(jtransformer_gemms(JARCHS[QWEN2], 2)[:2]
                + jtransformer_gemms(JARCHS[LLAMA3], 256)[-1:]
                + [JConv("conv3", R=3, C=192, F=384, O=13)],
                transformer_gemms(ARCHS[QWEN2], 2)[:2]
                + transformer_gemms(ARCHS[LLAMA3], 256)[-1:]
                + [ConvLayer("conv3", R=3, C=192, F=384, O=13)])]


@pytest.mark.parametrize("e_pes", [1, 2])
@pytest.mark.parametrize("mode", ["ws_ina", "ws_noina", "os_gather"])
def test_simulate_layer_matches_reference(mode, e_pes):
    """The heap engine alone gives the reference's numbers exactly (the
    reference here runs its default engines, which it holds bit-identical
    to its heap engine)."""
    from repro.core.noc import NocConfig as JNoc
    from repro.core.noc.traffic import layer_plan as jlayer_plan
    from repro.core.noc.traffic import simulate_layer as jsimulate_layer
    from repro_torch.core.noc import NocConfig, layer_plan, simulate_layer
    for jl, tl in _layers():
        for n, rows in ((8, None), (4, 16)):
            jcfg, tcfg = JNoc(n=n, rows=rows), NocConfig(n=n, rows=rows)
            assert dataclasses.asdict(layer_plan(tl, tcfg, e_pes, mode)) == \
                dataclasses.asdict(jlayer_plan(jl, jcfg, e_pes, mode))
            got = simulate_layer(tl, mode, tcfg, e_pes, sim_rounds=4)
            want = jsimulate_layer(jl, mode, jcfg, e_pes, sim_rounds=4)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_gemm_verdicts_do_not_depend_on_jobs():
    """``exec.pool.parallel_map`` fans the hardware points out over spawned
    workers and merges their sim entries back: the verdicts are those of
    one job, and the stores hold the entries one job leaves: a key comes
    back without the worker's cached hash, so a key the parent also
    computed merges into its own entry."""
    from repro_torch.exec import parallel_map
    from repro_torch.mapper import search
    from repro_torch.plan import builder
    assert parallel_map(abs, [-3, 1, -2], jobs=2) == [3, 1, 2]
    cfg = ARCHS[LLAMA3]
    sizes, verdicts = [], []
    for jobs in (1, 2):
        builder._GEMM_MEMO.pop((cfg, 2, "quick"), None)
        with simcache.fresh_sim_cache():
            verdicts.append(gemm_verdicts(cfg, 2, jobs=jobs))
            sizes.append((len(simcache.SIM_CACHE), len(search._eval_store())))
    assert verdicts[1] == verdicts[0] and sizes[1] == sizes[0]


# --------------------------------------------------------------------------- #
# psum decisions
# --------------------------------------------------------------------------- #
def _same_decisions(got, want, n_layers: int) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.p, g.nbytes, g.mode, g.ops, g.costs) == \
            (w.p, w.nbytes, w.mode, w.ops, w.costs)
        assert g.count == w.count * n_layers


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("name", [QWEN2, LLAMA3])
def test_psum_decisions_at_16x16_match_reference(name, phase):
    plan = build_plan(ARCHS[name], MESH_16, phase, gemm_search=False)
    want = reference_decisions(name, False, MESH_16, phase)
    assert want, "the reference recorded no site"
    _same_decisions(plan.psum, want, ARCHS[name].n_layers)
    assert verify_plan(plan) == []


@pytest.mark.parametrize("phase", PHASES)
def test_chip_smoke_holds_the_reference_decisions(phase):
    """``chip_smoke.py`` checks the card's 16 x 16 plans against
    ``PLAN_16X16``: the reference's decisions, count times the depth."""
    cs = chip_smoke()
    layers = ARCHS[QWEN2].n_layers
    assert cs.MESH_16 == MESH_16
    assert cs.PLAN_16X16[phase] == tuple(
        (d.p, d.nbytes, d.mode, d.ops, d.count * layers, d.costs)
        for d in reference_decisions(QWEN2, False, MESH_16, phase))


@pytest.mark.parametrize("package", ["mesh", "express"])
@pytest.mark.parametrize("phase", PHASES)
def test_chip_smoke_holds_the_reference_decisions_across_chips(phase,
                                                               package):
    """``chip_smoke.py`` checks the card's 16 x 16 plans at 4 chips
    against ``PLAN_16X16_C4``: the reference's ``resolve_sites(...,
    chips=4, package=...)``, count times the depth, which the port's
    ``build_plan`` gives too."""
    want = chip_smoke().PLAN_16X16_C4[package, phase]
    layers = ARCHS[QWEN2].n_layers
    assert want == tuple(
        (d.p, d.nbytes, d.mode, d.ops, d.count * layers, d.costs)
        for d in reference_decisions(QWEN2, False, MESH_16, phase, 4,
                                     package))
    plan = build_plan(ARCHS[QWEN2], MESH_16, phase, gemm_search=False,
                      chips=4, package=package)
    assert tuple((d.p, d.nbytes, d.mode, d.ops, d.count, d.costs)
                 for d in plan.psum) == want
    assert plan.key.endswith("__c4" + ("e" if package == "express" else "")
                             + "__torch")
    assert verify_plan(plan) == []


@pytest.mark.parametrize("package", ["mesh", "express"])
@pytest.mark.parametrize("name", [QWEN2, "rwkv6-7b",
                                  "llama4-scout-17b-16e"])
def test_psum_decisions_across_chips_match_reference(name, package):
    """The reduced dense, ssm and moe configs at ``(data 2, model 4)``
    with the model axis over 2 and 4 chips: every decision of every phase
    is the reference's ``resolve_sites(..., chips, package)``."""
    cfg = _port_cfg(name, True)
    pairs = (("data", 2), ("model", 4))
    for phase in PHASES:
        for chips in (2, 4):
            plan = build_plan(cfg, pairs, phase, gemm_search=False,
                              chips=chips, package=package)
            want = reference_decisions(name, True, pairs, phase, chips,
                                       package)
            assert want, "the reference recorded no site"
            _same_decisions(plan.psum, want, _stack_depth(cfg))
            assert verify_plan(plan) == []


def test_resolve_sites_at_one_chip_is_the_flat_resolution():
    sites = [C.PsumSite("psum", 4, 4096), C.PsumSite("psum", 4, 4096),
             C.PsumSite("reduce_scatter", 8, 65536)]
    flat = resolve_sites(sites)
    assert resolve_sites(sites, chips=1, package="express") == flat
    assert [d.count for d in flat] == [2, 1]
    across = resolve_sites(sites, chips=2, package="express")
    assert [(d.p, d.nbytes, d.count) for d in across] == \
        [(d.p, d.nbytes, d.count) for d in flat]
    assert across != flat


def test_multichip_plan_store_warm_roundtrip(plan_env):
    """The reference's ``test_hierarchy.py`` round trip (which fails on the
    installed jax): a multi-chip plan keys under ``__c2``, re-plans warm
    with 0 collective simulations, is never read by a flat request, and
    the express package keys apart under ``__c2e``."""
    from repro_torch.plan import plan_for_launch
    cfg, shape = ARCHS[QWEN2], SHAPES["decode_32k"]
    kw = {"plan_dir": plan_env / "s", "verbose": False,
          "gemm_search": False}
    plan, info = plan_for_launch(cfg, MESH_16, shape, "auto", chips=2, **kw)
    assert plan.chips == 2 and "__c2__" in plan.key
    assert not info["from_store"] and info["collective_sims"] > 0
    _cold()
    again, info2 = plan_for_launch(cfg, MESH_16, shape, "auto", chips=2,
                                   **kw)
    assert again == plan
    assert info2["from_store"] and info2["collective_sims"] == 0
    flat, finfo = plan_for_launch(cfg, MESH_16, shape, "auto", **kw)
    assert flat.chips == 1 and flat.key != plan.key
    assert not finfo["from_store"]
    exp, einfo = plan_for_launch(cfg, MESH_16, shape, "auto", chips=2,
                                 package="express", **kw)
    assert "__c2e__" in exp.key and exp.key != plan.key
    assert not einfo["from_store"] and exp.package == "express"
    assert {p.name for p in (plan_env / "s").glob("*.json")} == \
        {f"{p.key}.json" for p in (plan, flat, exp)}


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("p", [2, 4])
def test_psum_decisions_reduced_match_reference(p, phase):
    cfg = _port_cfg(QWEN2, True)
    plan = build_plan(cfg, (("model", p),), phase, gemm_search=False)
    _same_decisions(plan.psum,
                    reference_decisions(QWEN2, True, (("model", p),), phase),
                    cfg.n_layers)


def _stack_depth(cfg) -> int:
    """Layers a stack of the reduced config: the reference traces each
    stack's scanned body once (deepseek's dense first layer and its MoE
    layers are two stacks, of one layer each here), the port every
    layer."""
    nd = cfg.moe.first_dense_layers if cfg.moe else 0
    depths = {n for n in (nd, cfg.n_layers - nd) if n}
    assert len(depths) == 1, depths
    return depths.pop()


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", ["rwkv6-7b", "llama4-scout-17b-16e",
                                  "deepseek-v2-lite-16b"])
def test_psum_decisions_reduced_families_match_reference(name, p, phase):
    """The non-dense families' sites at p 2 and 4: two row psums a RWKV6
    layer (its output norm's all-reduce is no site), and the MoE
    combine beside the shared experts' psum; a fused MoE sum or a
    recorded norm would change the counts."""
    cfg = _port_cfg(name, True)
    plan = build_plan(cfg, (("model", p),), phase, gemm_search=False)
    want = reference_decisions(name, True, (("model", p),), phase)
    assert want, "the reference recorded no site"
    _same_decisions(plan.psum, want, _stack_depth(cfg))
    assert verify_plan(plan) == []


@functools.cache
def _reference_decisions_at(name: str, pairs: tuple, shape: tuple):
    """The reference's decisions for the reduced ``name`` at ``shape``
    (seq_len, global_batch, kind)."""
    from repro.configs.base import ShapeConfig as JShapeConfig
    sites = jbuilder.collect_psum_sites(JARCHS[name].reduced(),
                                        _abstract_mesh(pairs),
                                        JShapeConfig("t", *shape))
    return jbuilder.resolve_sites(sites)


# whisper's reduced position table holds 128 rows: the reference cannot
# trace PHASE_SHAPES' 4096 tokens at train and prefill (its add of the
# table to the tokens fails), so those two phases run at 64
WHISPER_SHAPES = {"train": (64, 2, "train"), "prefill": (64, 2, "prefill")}


def _site_bodies(cfg, shape) -> dict:
    """Each site payload (bytes) of the reduced hybrid, vlm or encdec
    config at ``shape`` -> [(sites one scanned body of the reference
    records, bodies of that kind the port's loop runs)].  zamba2: a Mamba2
    layer's ``w_out`` (one a layer) and its shared block's ``wo`` and MLP
    ``w_down`` over 2 x d_model (two a group); vlm: a self layer's and a
    cross layer's ``wo`` and ``w_down`` (two each, one payload); whisper:
    a decoder layer's self and cross ``wo`` and ``w_down`` over the tokens
    (three), an encoder layer's ``wo`` and ``w_down`` over the frames
    (two)."""
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    b = shape.global_batch
    row = b * (1 if shape.kind == "decode" else shape.seq_len) \
        * cfg.d_model * item
    if cfg.family == "hybrid":
        return {row: [(1, cfg.n_layers)],
                2 * row: [(2, cfg.n_layers // cfg.shared_attn_every)]}
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_every
        return {row: [(2, cfg.n_layers - g), (2, g)]}
    frames = b * cfg.num_media_tokens * cfg.d_model * item
    return {row: [(3, cfg.n_layers)], frames: [(2, cfg.encoder_layers)]}


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("name", ["zamba2-2.7b", "llama-3.2-vision-11b",
                                  "whisper-medium"])
def test_psum_decisions_reduced_hybrid_media_match_reference(name, p, phase):
    """The hybrid, vlm and encdec families' sites at p 2 and 4, media in
    the inputs: every field of each decision the reference's, the count
    scaled site by site (:func:`_site_bodies`: the reference traces each
    scanned body once, the port runs every layer).  Mamba2's gate norm
    all-reduce is no site: a recorded one would add a [..., 1] payload."""
    cfg = _port_cfg(name, True)
    at = WHISPER_SHAPES.get(phase) if name == "whisper-medium" else None
    shape = ShapeConfig("t", *at) if at else SHAPES[PHASE_SHAPES[phase]]
    plan = build_plan(cfg, (("model", p),), phase, gemm_search=False,
                      shape=shape)
    want = _reference_decisions_at(name, (("model", p),),
                                   (shape.seq_len, shape.global_batch,
                                    shape.kind))
    bodies = _site_bodies(cfg, shape)
    assert sorted(d.nbytes for d in want) == sorted(bodies)
    assert len(plan.psum) == len(want)
    for g, w in zip(plan.psum, want):
        assert (g.p, g.nbytes, g.mode, g.ops, g.costs) == \
            (w.p, w.nbytes, w.mode, w.ops, w.costs)
        assert w.count == sum(n for n, _ in bodies[w.nbytes])
        assert g.count == sum(n * depth for n, depth in bodies[w.nbytes])
    assert verify_plan(plan) == []


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_config_plans_at_one_rank(name):
    """Every family traces on the meta device; at one rank there is no
    group, so no site, as the reference records none."""
    for phase in PHASES:
        plan = build_plan(ARCHS[name], (("model", 1),), phase,
                          gemm_search=False)
        assert plan.psum == () and plan.tiles
        assert verify_plan(plan, check_layers=True) == []


def test_input_specs_are_meta_of_the_reference_shapes():
    m, jm = get_model(ARCHS[QWEN2]), jget_model(JARCHS[QWEN2])
    for name in PHASE_SHAPES.values():
        got, want = m.input_specs(SHAPES[name]), jm.input_specs(JSHAPES[name])
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            if k != "pos":
                assert tuple(v.shape) == want[k].shape
    assert tuple(got["pos"].shape) == (SHAPES["decode_32k"].global_batch,)


def test_sites_are_recorded_on_meta_only():
    """The stand-in span computes nothing: the two mode dispatchers take
    meta tensors under every mode, and a CPU tensor raises."""
    span = C.AxisSpan(4)
    x = torch.empty(2, 8, device="meta")
    assert C.axis_size(span) == 4 and C.axis_index(span) == 0
    with C.record_psum_sites() as sites:
        assert C.psum_with_mode(x, span, "auto", 1).shape == (2, 8)
        assert C.reduce_scatter_with_mode(x, span, "auto", 1).shape == (2, 2)
    assert [(s.op, s.p, s.nbytes) for s in sites] == \
        [("psum", 4, 64), ("reduce_scatter", 4, 64)]
    for mode in ("ina", "ina_ring", "eject_inject", "xla"):
        assert C.psum_with_mode(x, span, mode, 1).device.type == "meta"
        assert C.reduce_scatter_with_mode(x, span, mode, 1).shape == (2, 2)
    with pytest.raises(ValueError, match="meta tensors only"):
        C.psum_with_mode(torch.zeros(2, 8), span, "auto", 1)
    with pytest.raises(ValueError, match="meta tensors only"):
        C.reduce_scatter_with_mode(torch.zeros(2, 8), span, "eject_inject",
                                   1)


# --------------------------------------------------------------------------- #
# the Hopper tile policy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [1, 2, 64, 256, 2048])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_choose_tiles_is_plan_matmul(name, m, dtype):
    tiles = []
    for g in get_model(ARCHS[name]).gemm_layers(m):
        got = choose_tiles(g.M, g.K, g.N, dtype)
        want = im.plan_matmul(g.M, g.N, g.K, True) \
            if dtype == "bfloat16" else im.F32_PLAN
        assert got == want
        tiles.append(TileChoice(g.M, g.K, g.N, dtype, *got))
    plan = ExecutionPlan(model=name, mesh=(("model", 1),), phase="decode",
                         dtype=dtype, tiles=tuple(tiles), tokens=m)
    assert verify_plan(plan) == []


def test_tma_tiles_are_the_kernels_instantiations():
    """Each entry of ``TMA_TILES`` is a ``launch_tma<NWG, WN, TA, TB, SWAP,
    STAGES>`` of ``launch_planned`` in the CUDA source, and back."""
    src = (ROOT / "src/repro_torch/kernels/csrc/ina_matmul.cu").read_text()
    body = src[src.index("int launch_planned("):]
    body = body[:body.index("\n}\n")]
    found = {(int(a), int(b), s == "true", int(st)) for a, b, s, st in
             re.findall(r"launch_tma<(\d+), (\d+), \d, \d, (true|false), "
                        r"(\d+)>", body)}
    want = set()
    for (regime, tm, tn), (nwg, wn, stages) in im.TMA_TILES.items():
        swap = regime == "narrow"
        assert (wn, 64 * nwg) == ((tm, tn) if swap else (tn, tm))
        want.add((nwg, wn, swap, stages))
    assert found == want
    assert "SMEM = 1024 + BYTES + 2 * STAGES * 8" in src


def test_tile_working_set_fits_every_instantiation():
    sizes = {key: tile_working_set(im.MatmulPlan(*key, 1, im.BK))
             for key in im.TMA_TILES}
    assert sizes[("wide", 128, 256)] == 1024 + 4 * (16384 + 32768) + 64
    assert sizes[("narrow", 8, 64)] == 1024 + 8 * (8192 + 1024) + 128
    assert max(sizes.values()) <= SMEM_LIMIT


@pytest.mark.parametrize("bad,finding", [
    (dict(regime="tiled"), "regime"),
    (dict(tile_n=96), "not instantiated"),
    (dict(cluster=3), "power of two"),
    (dict(cluster=16), "power of two"),
    (dict(cluster=8, m=4096), "SMs"),
    (dict(cluster=8, k=512), "fewer than"),
    (dict(bk=128), "K tile"),
    (dict(dtype="float32"), "does not take"),
])
def test_verify_plan_catches_bad_tiles(bad, finding):
    good = TileChoice(2, 1536, 1536, "bfloat16",
                      *im.plan_matmul(2, 1536, 1536, True))
    plan = ExecutionPlan(model=QWEN2, mesh=(("model", 1),), phase="decode",
                         dtype="bfloat16",
                         tiles=(dataclasses.replace(good, **bad),))
    found = verify_plan(plan)
    assert found and all(f.check == "plan-tile" for f in found)
    assert any(finding in f.message for f in found), found


def test_verify_plan_keeps_the_psum_checks():
    costs = (("ina", 5, 1.0), ("ina_ring", 4, 2.0), ("eject_inject", 9, 3.0))
    ok = PsumDecision(p=2, nbytes=64, mode="ina_ring", ops=("psum",),
                      count=1, costs=costs)
    for mode, objective, n in (("ina_ring", "latency", 0),
                               ("ina", "latency", 1), ("ina", "energy", 0),
                               ("xla", "latency", 1)):
        plan = ExecutionPlan(model=QWEN2, mesh=(("model", 2),),
                             phase="decode", dtype="bfloat16",
                             objective=objective,
                             psum=(dataclasses.replace(ok, mode=mode),))
        assert len(verify_plan(plan)) == n, (mode, objective)


# --------------------------------------------------------------------------- #
# the store
# --------------------------------------------------------------------------- #
def _cold():
    cost._simulate.cache_clear()
    C._fallback_choice.cache_clear()


def test_plan_json_is_byte_deterministic():
    cfg = _port_cfg(QWEN2, True)
    a = build_plan(cfg, (("model", 2),), "decode")
    b = build_plan(cfg, (("model", 2),), "decode")
    assert a.to_json() == b.to_json()
    assert ExecutionPlan.from_json(a.to_json()) == a
    assert ExecutionPlan.from_json(a.to_json()).to_json() == a.to_json()


def test_store_round_trip_and_warm_load_runs_no_simulation(plan_env):
    cfg = _port_cfg(QWEN2, True)
    store = PlanStore(plan_env / "store")
    _cold()
    with simcache.fresh_sim_cache():
        runs = cost.COST_STATS["engine_runs"]
        plan, built = store.get_or_build(cfg, (("model", 4),), "decode")
        assert built and cost.COST_STATS["engine_runs"] > runs
        _cold()
        runs = cost.COST_STATS["engine_runs"]
        again, built = PlanStore(plan_env / "store").get_or_build(
            cfg, (("model", 4),), "decode")
        assert not built and again == plan
        assert cost.COST_STATS["engine_runs"] == runs
    assert store.path_for(plan.key).read_text() == plan.to_json()
    assert plan.key == plan_key(cfg.name, (("model", 4),), "decode",
                                "float32")


def test_store_invalidates_on_schema_and_config_edits(plan_env):
    cfg = _port_cfg(QWEN2, True)
    store = PlanStore(plan_env)
    plan, _ = store.get_or_build(cfg, (("model", 2),), "decode",
                                 gemm_search=False)
    path = store.path_for(plan.key)
    doc = json.loads(path.read_text())
    doc["schema"] = "0" * 16
    path.write_text(json.dumps(doc))
    assert store.load(plan.key) is None
    _, built = store.get_or_build(cfg, (("model", 2),), "decode",
                                  gemm_search=False)
    assert built
    edited = dataclasses.replace(cfg, d_ff=2 * cfg.d_ff)
    again, built = store.get_or_build(edited, (("model", 2),), "decode",
                                      gemm_search=False)
    assert built and again.config != plan.config
    _, built = store.get_or_build(edited, (("model", 2),), "decode",
                                  gemm_search=False, objective="energy")
    assert built


def test_corrupt_plan_file_reads_as_cold(plan_env):
    cfg = _port_cfg(QWEN2, True)
    store = PlanStore(plan_env)
    plan, _ = store.get_or_build(cfg, (("model", 2),), "prefill",
                                 gemm_search=False)
    for text in ("{not json", "[1, 2]", json.dumps({"schema":
                                                    plan_schema_hash()})):
        store.path_for(plan.key).write_text(text)
        assert store.load(plan.key) is None
        _, built = store.get_or_build(cfg, (("model", 2),), "prefill",
                                      gemm_search=False)
        assert built


def test_reference_plan_reads_as_cold(plan_env):
    """A reference plan never answers a port lookup: the key, the schema
    tag, the directory and its environment variable all differ, and a
    reference plan file put at the port's path loads as cold."""
    mesh = (("model", 2),)
    key = plan_key(QWEN2, mesh, "decode", "bfloat16")
    assert key != jplan_key(QWEN2, mesh, "decode", "bfloat16")
    assert plan_schema_hash() != jplan_schema_hash()
    assert JPLAN_DIR_ENV != "REPRO_TORCH_PLAN_DIR"
    assert Path(jdefault_plan_dir()) != Path(PlanStore().dir)
    ref = JExecutionPlan(model=QWEN2, mesh=mesh, phase="decode",
                         dtype="bfloat16")
    store = PlanStore(plan_env)
    store.dir.mkdir(parents=True, exist_ok=True)
    store.path_for(key).write_text(ref.to_json())
    assert store.load(key) is None


def test_save_refuses_a_plan_with_findings(plan_env):
    bad = TileChoice(2, 1536, 1536, "bfloat16", "wide", 64, 64, 1, 64)
    plan = ExecutionPlan(model=QWEN2, mesh=(("model", 1),), phase="decode",
                         dtype="bfloat16", tiles=(bad,))
    store = PlanStore(plan_env)
    with pytest.raises(VerificationError, match="not instantiated"):
        store.save(plan)
    assert not store.path_for(plan.key).exists()


# --------------------------------------------------------------------------- #
# consumers
# --------------------------------------------------------------------------- #
def test_resolve_auto_mode_plan_hit_and_miss():
    costs = tuple((m, 1, 1.0) for m in cost.AUTO_CANDIDATES)
    plan = ExecutionPlan(
        model=QWEN2, mesh=(("model", 4),), phase="decode", dtype="float32",
        objective="energy",
        psum=(PsumDecision(4, 4096, "eject_inject", ("psum",), 2, costs),))
    assert C.resolve_auto_mode("psum", 4, 4096, plan) == "eject_inject"
    _cold()
    for nbytes in (8192, 2 ** 28):
        got = C.resolve_auto_mode("psum", 4, nbytes, plan)
        assert got == cost.choose_psum_mode(4, nbytes, objective="energy")
        assert got == C._fallback_choice(4, nbytes, "energy")
    assert C.resolve_auto_mode("psum", 4, 4096) == \
        C._fallback_choice(4, 4096)
    with C.record_psum_sites() as sites:
        assert C.resolve_auto_mode("psum", 4, 4096, plan) == "ina"
    assert len(sites) == 1


def _planned(m, k, n, dtype):
    launch = choose_tiles(m, k, n, dtype)
    return ExecutionPlan(model="t", mesh=(("model", 1),), phase="decode",
                         dtype=dtype,
                         tiles=(TileChoice(m, k, n, dtype, *launch),))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ops_matmul_takes_the_planned_launch(dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 256, generator=g).to(dt)
    w = torch.randn(256, 192, generator=g).to(dt)
    plan = _planned(2, 256, 192, dtype)
    im.plan_tiles.update(hit=0, miss=0)
    got = ops.matmul(x, w, plan)
    assert im.plan_tiles == {"hit": 1, "miss": 0}
    assert torch.equal(got, ops.matmul(x, w))
    assert torch.equal(got, im.ina_matmul(x, w, plan.tile_for(2, 256, 192,
                                                              dtype)))
    # another shape, and the other dtype's tile, miss
    ops.matmul(x[:1], w, plan)
    other = _planned(2, 256, 192,
                     "float32" if dtype == "bfloat16" else "bfloat16")
    ops.matmul(x, w, other)
    assert im.plan_tiles == {"hit": 1, "miss": 2}
    # the autograd path asks the plan too
    xg = x.clone().requires_grad_()
    ops.matmul(xg, w, plan).float().sum().backward()
    assert im.plan_tiles == {"hit": 2, "miss": 2} and xg.grad is not None


def test_ops_matmul_keeps_unaligned_operands_off_the_plan():
    """A row stride off the 8-element grid is not one TMA describes: the
    plan's tile is not used, and the launch is the planless one."""
    g = torch.Generator().manual_seed(1)
    big = torch.randn(2, 257, generator=g).to(torch.bfloat16)
    x = big[:, :256]
    w = torch.randn(256, 192, generator=g).to(torch.bfloat16)
    assert im.plan_for(x, w).regime == "generic"
    im.plan_tiles.update(hit=0, miss=0)
    got = ops.matmul(x, w, _planned(2, 256, 192, "bfloat16"))
    assert im.plan_tiles == {"hit": 0, "miss": 1}
    assert torch.equal(got, ops.matmul(x, w))


def test_meta_path_computes_nothing():
    """A meta call takes the CUDA path up to the launch: a shape-only
    output, the kernel's work recorded where a count is open, and no
    launch counted."""
    from repro_torch.core import cost as work
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6 as wk
    x = torch.empty(3, 4, 64, device="meta", dtype=torch.bfloat16)
    w = torch.empty(64, 32, device="meta", dtype=torch.bfloat16)
    q = torch.empty(1, 5, 4, 16, device="meta")
    launches = (im.launches, fa.launches, wk.launches)
    with work.counting() as c:
        y = ops.matmul(x, w, _planned(12, 64, 32, "bfloat16"))
        assert y.device.type == "meta" and tuple(y.shape) == (3, 4, 32)
        assert ops.attention_heads(q, q[:, :, :2], q[:, :, :2]).shape \
            == q.shape
        assert ops.wkv(q, q, q, q, torch.empty(4, 16, device="meta")).shape \
            == q.shape
    assert (im.launches, fa.launches, wk.launches) == launches
    assert c.launches == {"ina_matmul": 1, "flash_attention": 1, "wkv6": 1}
    assert c.kernels["ina_matmul"]["flops"] == im.cost(12, 32, 64, 2)[0]
    assert c.kernels["flash_attention"]["flops"] == \
        fa.cost(1, 5, 5, 4, 2, 16, 4)[0]
    assert c.kernels["wkv6"]["bytes"] == wk.cost(1, 5, 4, 16, 4)[1]
    assert im.ina_matmul(x[0], w).shape == (4, 32)
    assert c.launches["ina_matmul"] == 1        # the count is closed


def _serve_argv(*extra):
    return ["--arch", QWEN2, "--reduced", "--device", "cpu", "--batch", "3",
            "--slots", "2", "--prompt-len", "6", "--gen", "5",
            "--prefill-chunk", "4", "--block-size", "4", *extra]


def test_planned_serve_equals_planless_at_world_1(plan_env):
    cfg = _port_cfg(QWEN2, True)
    planless = launch_serve.main(_serve_argv("--psum-mode", "ina"))
    args = launch_serve.build_parser().parse_args(
        _serve_argv("--psum-mode", "auto", "--plan-dir",
                    str(plan_env / "p")))
    im.plan_tiles.update(hit=0, miss=0)
    report = launch_serve.run_engine(args, cfg)
    assert [report.tokens()[f"req{i}"] for i in range(3)] == planless
    per_pass = 7 * cfg.n_layers
    assert im.plan_tiles == {
        "hit": per_pass * report.decode_steps,
        "miss": (per_pass + 1) * report.prefill_chunks + report.decode_steps}
    assert len(list((plan_env / "p").glob("*.json"))) == 2
    assert launch_serve.main(_serve_argv("--psum-mode", "auto", "--no-plan",
                                         "--plan-dir",
                                         str(plan_env / "q"))) == planless
    assert not (plan_env / "q").exists()
    assert launch_serve.main(_serve_argv("--psum-mode", "auto", "--plan-dir",
                                         str(plan_env / "p"),
                                         "--legacy-loop")) == \
        launch_serve.main(_serve_argv("--legacy-loop"))


#: The cases of the one world-2 spawn of planned serving, each on
#: ``_serve_argv`` and the seeded weights: label -> its ``--plan-dir``
#: (None: ``--no-plan``), where a ``c-<package>`` one holds plans over 2
#: chips of that package (``_torch_dist_workers.plans_across``).
WORLD_2_CASES = {"planless": None, "planned": "p", "chips-mesh": "c-mesh",
                 "chips-express": "c-express"}


@pytest.fixture(scope="module")
def planned_world_2(tmp_path_factory):
    """One gloo spawn of 2 ranks serving every :data:`WORLD_2_CASES` case
    under ``--psum-mode auto`` (``_torch_dist_workers.planned_serve_rank``)
    through ``launch.serve.spawn_ranks``, as ``launch.serve.main`` spawns
    them (the ranks return the same tokens, psums and calls); returns (the
    directory, each rank's results)."""
    import _torch_dist_workers as W
    root = tmp_path_factory.mktemp("planned_world_2")
    cases = {label: _serve_argv(
        "--model-parallel", "2", "--psum-mode", "auto",
        *(("--no-plan",) if d is None else ("--plan-dir", str(root / d))))
        for label, d in WORLD_2_CASES.items()}
    launches = [(args, launch_serve.config(args)) for args in
                map(launch_serve.build_parser().parse_args, cases.values())]
    across = {str(root / f"c-{pk}"): {"chips": 2, "package": pk}
              for pk in ("mesh", "express")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_PLAN_DIR", str(root / "default"))
        mp.setenv("REPRO_TORCH_SIMCACHE_DIR", str(root / "sims"))
        mp.setattr(simcache.SIM_CACHE, "_persist_dir", None)
        mp.setattr(launch_serve, "plan_for_launch", W.plans_across(across))
        ranks = launch_serve.spawn_ranks(
            W.planned_serve_rank, 2, "cpu", launches,
            {"cases": cases, "across": across})
    return root, ranks


def _plans(path: Path) -> list:
    return [ExecutionPlan.from_json(p.read_text())
            for p in sorted(path.glob("*.json"))]


def test_planned_serve_equals_planless_at_world_2(planned_world_2):
    root, ranks = planned_world_2
    assert ranks[0]["planned"]["tokens"] == ranks[0]["planless"]["tokens"]
    plans = _plans(root / "p")
    assert [p.phase.split("-")[0] for p in plans] == ["decode", "prefill"]
    for p in plans:
        assert p.mesh == (("model", 2),) and p.psum and p.chips == 1
        assert all(d.p == 2 for d in p.psum)


@pytest.mark.parametrize("package", ["mesh", "express"])
def test_serving_across_chips_at_world_2(planned_world_2, package):
    """The reduced qwen2 served at 2 ranks through plans over 2 chips:
    every ``auto`` psum resolved through the decode plan runs the plan's
    mode (the hierarchy's choice: ``ina_ring`` under the mesh package,
    ``ina`` under express, where the flat cost model takes ``ina_ring``),
    every other runs the mode it resolved to (or ``ina`` where the ring's
    scatter axis does not divide: a prefill chunk of one slot), the
    vocab-parallel embedding's sum is no ``auto`` site, every psum is one
    ``CALLS`` counts, and the tokens are the planless run's."""
    from repro_torch.core.noc.collective.cost import choose_psum_mode
    from repro_torch.core.noc.hierarchy import choose_hier_psum_mode
    root, ranks = planned_world_2
    suffix = "__c2" + ("e" if package == "express" else "") + "__"
    plans = _plans(root / f"c-{package}")
    assert all(suffix in p.key for p in plans)
    (decode,) = [p for p in plans if p.phase.startswith("decode")]
    assert (decode.chips, decode.package) == (2, package)
    planned = {d.nbytes: d.mode for d in decode.psum}
    for nbytes, mode in planned.items():
        assert mode == choose_hier_psum_mode(2, nbytes, chips=2,
                                             package=package)
        assert (mode == choose_psum_mode(2, nbytes)) == (package == "mesh")
    for rank in ranks:
        run = rank[f"chips-{package}"]
        assert run["tokens"] == rank["planless"]["tokens"]
        hits = 0
        for (phase, nbytes, resolved, mode), n in run["psums"].items():
            if resolved is None:        # the embedding's native sum
                assert (phase, mode) == (None, "ina")
            elif phase == "decode":
                assert resolved == mode == planned[nbytes]
                hits += n
            else:
                assert mode == resolved or (resolved, mode) == \
                    ("ina_ring", "ina")
        assert hits > 0
        assert sum(run["psums"].values()) == run["calls"]["psum"]


def test_train_launcher_plans_under_auto(plan_env):
    argv = ["--arch", QWEN2, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--lr", "1e-2", "--ckpt-every",
            "100"]
    planned = launch_train.main(argv + [
        "--ckpt-dir", str(plan_env / "a"), "--psum-mode", "auto",
        "--plan-dir", str(plan_env / "p")])
    keys = [p.name for p in (plan_env / "p").glob("*.json")]
    assert keys == [plan_key(QWEN2, (("data", 1), ("model", 1)),
                             "train-cli-16x2", "float32") + ".json"]
    planless = launch_train.main(argv + [
        "--ckpt-dir", str(plan_env / "b"), "--psum-mode", "auto",
        "--no-plan", "--plan-dir", str(plan_env / "q")])
    assert planned["losses"] == planless["losses"]
    assert not (plan_env / "q").exists()


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
def test_planned_decode_step_on_card():
    """qwen2 at 2 layers, full width, bf16: the decode step under its plan
    launches the planned tiles (7 a layer hit, the head misses) and gives
    the planless step's logits to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    cfg = dataclasses.replace(ARCHS[QWEN2], n_layers=2)
    model = get_model(cfg)
    plan = build_plan(cfg, (("model", 1),), "decode", gemm_search=False,
                      tokens=2)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = {"tokens": torch.full((2, 1), 11, device="cuda"),
             "pos": torch.tensor([3, 5], device="cuda")}
    out = []
    for p in (None, plan):
        cache = model.init_cache(2, 16, device="cuda")
        im.plan_tiles.update(hit=0, miss=0)
        with torch.no_grad():
            logits, _ = model.decode_step(params, batch, cache,
                                          ParallelCtx(plan=p))
        out.append(logits)
    torch.cuda.synchronize()
    assert im.plan_tiles == {"hit": 7 * cfg.n_layers, "miss": 1}
    assert torch.equal(out[0], out[1])
