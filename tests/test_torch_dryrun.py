"""The port's dry-run (``repro_torch.launch.dryrun``) and its work counter
(``repro_torch.core.cost``) against the reference and against counts
derived here.

* ``depth_scaled`` and ``depth_units`` equal the reference's, field by
  field, for every arch;
* at each family's reduced config, depth 1, B 2 x S 64, on a 1 x 1 mesh:
  the port's product FLOPs (products and kernels, without the
  elementwise count) against the reference's ``_cost_point`` (XLA's count,
  on an ``AxisType.Auto`` mesh): within 5% of the ratio measured for each
  family and kind (XLA counts the elementwise ops too, and the ssm and
  hybrid families' scans are written differently in the two packages), so
  a lost recompute or backward term fails; the dense family's equal an
  analytic count exactly;
* a full-depth trace equals ``fixed + units x per_unit`` exactly, in
  FLOPs and collective bytes, at a depth of 3 units;
* on span meshes: all-reduce bytes equal the ``PsumSite``s
  ``plan.builder.collect_psum_sites`` records (and the vocab-parallel
  embedding's sum), reduce-scatter bytes the sites of a sequence-sharded
  stream, all-gather bytes the FSDP pieces' gathers, argument bytes the
  rank's parameters, AdamW state, batch and cache, exactly;
* at 16 x 16: llama3-8b's train and decode cells complete (the train
  cell's launches the derived ones, its collectives the FSDP gathers and
  the gradient reductions); qwen2-1.5b's cells (12 query heads at a model
  span of 16) complete under the uneven head cut, rank 0's launches and
  argument bytes those of one query and one KV head a rank; qwen3-14b's
  decode (rank 0: 3 query heads, 1 KV head) and zamba2-2.7b's
  ``long_500k`` at 2 x 16 x 16 (its one row replicated over the 32
  hosts) complete; the CLI writes results and a failure (a train batch
  the hosts do not divide, which the port still refuses);
* memory: each kernel's output (an ``empty`` buffer on ``meta``) is live
  from its creation, and a prefill's peak holds its logits;
* a trace leaves nothing behind: a CPU train step after it equals one
  before it, bit for bit.
"""
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import depth_scaled as jdepth_scaled
from repro.configs.base import depth_units as jdepth_units
from repro.parallel.tp import ParallelCtx as JParallelCtx

from repro_torch.configs import ARCHS
from repro_torch.configs.base import (SHAPES, ShapeConfig, depth_scaled,
                                      depth_units)
from repro_torch.core import collectives as C
from repro_torch.core import cost, remat
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ina_matmul as im
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankMesh, make_production_mesh
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import fsdp, sharding
from repro_torch.parallel.steps import build_train_step
from repro_torch.plan.builder import collect_psum_sites

FAMILIES = {"dense": "qwen2-1.5b", "ssm": "rwkv6-7b",
            "moe": "llama4-scout-17b-16e", "mla_moe": "deepseek-v2-lite-16b",
            "hybrid": "zamba2-2.7b", "vlm": "llama-3.2-vision-11b",
            "encdec": "whisper-medium"}
KINDS = ("train", "prefill", "decode")
#: the product FLOPs over the reference's XLA count, by family, as measured
#: for train, prefill and decode (``python tests/test_torch_dryrun.py``)
RATIOS = {"dense": (0.976, 0.904, 0.824), "encdec": (0.975, 0.907, 0.950),
          "hybrid": (0.926, 0.900, 0.832), "mla_moe": (0.965, 0.969, 0.961),
          "moe": (0.946, 0.906, 0.883), "ssm": (0.916, 0.900, 0.907),
          "vlm": (0.950, 0.930, 0.857)}
RATIO_TOL = 0.05
B, S = 2, 64
ONE = RankMesh((1, 1), ("data", "model"))
MESHES = {"model2": RankMesh((2,), ("model",)),
          "model4": RankMesh((4,), ("model",)),
          "data2_model2": RankMesh((2, 2), ("data", "model")),
          "pod2_data2_model1": RankMesh((2, 2, 1), ("pod", "data", "model"))}
QWEN2 = "qwen2-1.5b"


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_depth_helpers_match_reference(arch):
    for u in (1, 2, 3):
        assert _fields(depth_scaled(ARCHS[arch], u)) == \
            _fields(jdepth_scaled(JARCHS[arch], u))
    assert depth_units(ARCHS[arch]) == jdepth_units(JARCHS[arch])
    reduced = ARCHS[arch].reduced()
    assert depth_units(reduced) == jdepth_units(JARCHS[arch].reduced())


# --------------------------------------------------------------------------- #
# the reference's XLA count
# --------------------------------------------------------------------------- #
@functools.cache
def _reference_dryrun():
    """``repro.launch.dryrun``, imported once the backend is up (its import
    sets a 512-device ``XLA_FLAGS`` for a fresh process; restored here)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jdryrun


@functools.cache
def _reference_flops(arch: str, kind: str) -> float:
    jdryrun = _reference_dryrun()
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))
    return jdryrun._cost_point(jdepth_scaled(JARCHS[arch].reduced(), 1),
                               JShapeConfig("x", S, B, kind), mesh,
                               JParallelCtx(mesh=mesh))["flops"]


@functools.cache
def _trace(arch: str, kind: str, units: int = 1, mesh: RankMesh = ONE,
           batch: int = B) -> cost.Cost:
    cfg = depth_scaled(ARCHS[arch].reduced(), units)
    return dryrun.trace_step(cfg, ShapeConfig("x", S, batch, kind), mesh)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_product_flops_against_reference(family, kind):
    """The ratios are written into PERF.md."""
    arch = FAMILIES[family]
    got = _trace(arch, kind).products
    ratio = got / _reference_flops(arch, kind)
    want = RATIOS[family][KINDS.index(kind)]
    assert abs(ratio / want - 1) <= RATIO_TOL, (arch, kind, got, ratio)


def _dense_products(cfg, kind: str) -> int:
    """The dense family's product FLOPs from its config: seven projections
    a layer and the head (2 M N K each), flash attention's causal pairs
    (``kernels.flash_attention.cost``); in training each layer's
    projections and flash run again in the recompute, every projection
    takes dX and dW, and flash's backward is the plain f32 VJP: six
    [S, S] products a layer.  A decode step's attention over the cache is
    a broadcast product and sum (``layers.attn_full`` outside autograd),
    no product op."""
    d, h, kv, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.resolved_head_dim, cfg.d_ff, cfg.vocab)
    t = B if kind == "decode" else B * S
    proj = 2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d \
        + 3 * 2 * t * d * f
    head = 2 * t * d * v
    flash = fa.cost(B, S, S, h, kv, hd, 4)[0]
    layers = cfg.n_layers
    if kind == "decode":
        return layers * proj + head
    if kind == "prefill":
        return layers * (proj + flash) + head
    return layers * (4 * proj + 2 * flash + 6 * 2 * B * h * S * S * hd) \
        + 3 * head


@pytest.mark.parametrize("kind", KINDS)
def test_dense_products_equal_analytic_count(kind):
    cfg = depth_scaled(ARCHS[QWEN2].reduced(), 1)
    c = _trace(QWEN2, kind)
    assert c.products == _dense_products(cfg, kind)
    launches = {"train": 3 * 8 + 7, "prefill": 8, "decode": 8}[kind]
    assert c.launches["ina_matmul"] == launches
    assert c.launches.get("flash_attention", 0) == \
        {"train": 2, "prefill": 1, "decode": 0}[kind]


# --------------------------------------------------------------------------- #
# depth
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_full_depth_is_fixed_plus_units_times_per_unit(family):
    """A train step at 3 units on a model span of 2, traced whole, against
    the roofline's two shallow traces."""
    arch = FAMILIES[family]
    mesh = MESHES["model2"]
    cfg = depth_scaled(ARCHS[arch].reduced(), 3)
    shape = ShapeConfig("x", S, B, "train")
    roof = dryrun.roofline_costs(cfg, shape, mesh, dryrun.rank_ctx(mesh))
    whole = _trace(arch, "train", 3, mesh)
    assert roof["units"] == 3 == depth_units(cfg)
    assert whole.flops == roof["flops_fixed"] + 3 * roof["flops_per_unit"]
    assert whole.collective_bytes()["total"] == \
        roof["coll_fixed"] + 3 * roof["coll_per_unit"] > 0


# --------------------------------------------------------------------------- #
# collective and argument bytes on span meshes
# --------------------------------------------------------------------------- #
def _rows(mesh: RankMesh) -> int:
    return 4 // (mesh.span("pod") * mesh.span("data"))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_all_reduce_bytes_equal_psum_sites(mesh, kind):
    """Under ``xla_spmd`` every row-parallel site is one all-reduce of its
    payload; the only other one is the vocab-parallel embedding's sum of
    its [rows, S, D] (at a model span above 1).  No site reduce-scatters
    without ``rs_seq``."""
    m = MESHES[mesh]
    cfg = ARCHS[QWEN2].reduced()
    c = _trace(QWEN2, kind, 2, m, 4)
    shape = ShapeConfig("x", S, _rows(m), kind)
    sites = collect_psum_sites(depth_scaled(cfg, 2), m.pairs, shape)
    seq = S if kind == "prefill" else 1
    embed = _rows(m) * seq * cfg.d_model * 4 if m.span("model") > 1 else 0
    got = c.collective_bytes()
    assert got.get("all-reduce", 0) == \
        sum(s.nbytes for s in sites if s.op == "psum") + embed
    assert got.get("reduce-scatter", 0) == \
        sum(s.nbytes // s.p for s in sites if s.op == "reduce_scatter") == 0
    assert bool(sites) == (m.span("model") > 1)


@pytest.mark.parametrize("mode", ["xla_spmd", "ina_ring"])
def test_sequence_sharded_sites_reduce_scatter(mode):
    """Under ``rs_seq`` each row site of a prefill (a psum the builder
    records) reduce-scatters its payload n over S: n / p out natively, or
    p - 1 ring hops of n / p under ``ina_ring``.  Beside them: each block's
    input and the head's gathered by the ring (2 L + 1 gathers of p - 1
    hops of n / p), the vocabulary's logits gathered by the ring, and the
    embedding's sum."""
    m = MESHES["model4"]
    cfg = depth_scaled(ARCHS[QWEN2].reduced(), 2)
    shape = ShapeConfig("x", S, B, "prefill")
    pctx = dataclasses.replace(dryrun.rank_ctx(m, mode), rs_seq=True)
    got = dryrun.trace_step(cfg, shape, m, pctx).collective_bytes()
    sites = collect_psum_sites(cfg, m.pairs, shape)
    p, n = 4, B * S * cfg.d_model * 4
    assert len(sites) == 2 * cfg.n_layers
    assert {s.nbytes for s in sites} == {n}
    permutes = (2 * cfg.n_layers + 1) * (p - 1) * n // p \
        + (p - 1) * B * S * (cfg.vocab // p) * 4
    if mode == "xla_spmd":
        assert got["reduce-scatter"] == sum(s.nbytes // p for s in sites)
    else:
        assert "reduce-scatter" not in got
        permutes += sum((p - 1) * s.nbytes // p for s in sites)
    assert got["collective-permute"] == permutes
    assert got["all-reduce"] == n


def _fsdp_bytes(cfg, m: RankMesh) -> tuple[int, int]:
    """(bytes a train step all-gathers, bytes it reduce-scatters): each
    FSDP piece's whole model shard (float32 masters, the cut from
    ``sharding.data_cut``) gathered once for the leaves outside the
    layers and twice for a layer's (its forward and its recompute), and
    each gradient reduce-scattered once to the piece."""
    dd, mm = m.span("data"), m.span("model")
    shard = sharding.shard_params(get_model(cfg).init(device="meta",
                                                      masters=True),
                                  cfg, 0, mm)
    gathered = scattered = 0
    for names, leaf in _named(shard):
        if sharding.data_cut(names, cfg, (dd, mm)) is None:
            continue
        n = leaf.numel() * leaf.element_size()
        gathered += n * (2 if names[0] == "layers" else 1)
        scattered += n // dd
    return gathered, scattered


def _named(tree, names=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, names + (k,))
        else:
            yield names + (k,), v


@pytest.mark.parametrize("mesh", ["data2_model2", "pod2_data2_model1"])
def test_fsdp_gathers_and_train_arguments(mesh):
    m = MESHES[mesh]
    cfg = depth_scaled(ARCHS[QWEN2].reduced(), 2)
    c = _trace(QWEN2, "train", 2, m, 4)
    gathered, scattered = _fsdp_bytes(cfg, m)
    got = c.collective_bytes()
    assert got["all-gather"] == gathered > 0
    assert got["reduce-scatter"] == scattered
    assert got["all-reduce"] > 0            # the data-parallel reductions
    params = sharding.shard_params(
        get_model(cfg).init(device="meta", masters=True), cfg, (0, 0),
        (m.span("data"), m.span("model")))
    rows = _rows(m)
    # params, AdamW's m and v (float32) and step (int32); tokens, labels
    assert c.argument_bytes == 3 * _nbytes(params) + 4 + 2 * rows * S * 4


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_serving_arguments_are_the_ranks(mesh, kind):
    """A serving rank holds its FSDP pieces, its rows and (decode) its
    cache of its KV heads."""
    m = MESHES[mesh]
    cfg = depth_scaled(ARCHS[QWEN2].reduced(), 2)
    model = get_model(cfg)
    c = _trace(QWEN2, kind, 2, m, 4)
    pieces = sharding.shard_params(model.init(device="meta"), cfg, (0, 0),
                                   (m.span("data"), m.span("model")))
    rows = _rows(m)
    want = _nbytes(pieces) + rows * (S if kind == "prefill" else 2) * 4
    if kind == "decode":
        want += _nbytes(model.init_cache(rows, S, device="meta",
                                         world=m.span("model")))
    assert c.argument_bytes == want
    assert c.peak_bytes == c.argument_bytes + c.temp_bytes > want


# --------------------------------------------------------------------------- #
# memory held by the kernels' outputs
# --------------------------------------------------------------------------- #
def test_kernel_outputs_are_live_memory():
    """On ``meta`` each kernel's output is an ``empty`` buffer that no
    later op writes: the three held together are the whole temp, to the
    byte, and each launch's work is its ``cost``."""
    bf16 = torch.bfloat16

    def meta(*shape, dtype=bf16):
        return torch.empty(*shape, dtype=dtype, device="meta")
    x, w = meta(256, 128), meta(128, 384)
    q, k, v = meta(2, 64, 4, 64), meta(2, 64, 2, 64), meta(2, 64, 2, 64)
    r, kk, vv = meta(2, 64, 4, 64), meta(2, 64, 4, 64), meta(2, 64, 4, 64)
    logw = meta(2, 64, 4, 64, dtype=torch.float32)
    u = meta(4, 64, dtype=torch.float32)
    from repro_torch.kernels import ops
    with cost.counting() as c:
        c.arguments(x, w, q, k, v, r, kk, vv, logw, u)
        held = (ops.matmul(x, w), ops.attention_heads(q, k, v),
                ops.wkv(r, kk, vv, logw, u))
    assert c.temp_bytes == sum(t.numel() * t.element_size() for t in held) \
        == (256 * 384 + 2 * 2 * 64 * 4 * 64) * 2
    assert c.launches == {"ina_matmul": 1, "flash_attention": 1, "wkv6": 1}
    assert c.kernels["ina_matmul"]["flops"] == im.cost(256, 384, 128, 2)[0]
    assert c.kernels["wkv6"]["bytes"] == wk.cost(2, 64, 4, 64, 2)[1]


@pytest.mark.parametrize("arch", [QWEN2, "rwkv6-7b"])
def test_prefill_peak_holds_its_logits(arch):
    """A prefill's logits are the head's ``ina_matmul`` output: the rank's
    peak is at least its arguments and the logits [B, S, V] it returns (a
    vocabulary of 32768, so that the logits outweigh every other buffer
    of the step)."""
    cfg = dataclasses.replace(depth_scaled(ARCHS[arch].reduced(), 2),
                              vocab=32768)
    c = dryrun.trace_step(cfg, ShapeConfig("x", S, B, "prefill"), ONE)
    logits = B * S * cfg.vocab * getattr(torch, cfg.dtype).itemsize
    assert c.output_bytes == logits
    assert c.peak_bytes >= c.argument_bytes + logits


def test_a_cpu_tensor_on_a_span_raises():
    span = C.AxisSpan(2)
    for fn in (lambda: C.all_reduce_(torch.zeros(4), span),
               lambda: C.all_gather_into_(torch.empty(8), torch.zeros(4),
                                          span),
               lambda: C.ppermute_next(torch.zeros(4), span),
               lambda: C.psum_with_mode(torch.zeros(4), span, "xla")):
        with pytest.raises(ValueError, match="meta tensors only"):
            fn()


# --------------------------------------------------------------------------- #
# the production mesh and the CLI
# --------------------------------------------------------------------------- #
def test_llama3_cells_complete_at_16x16():
    mesh = make_production_mesh()
    train = dryrun.run_cell("llama3-8b", "train_4k", mesh, roofline=False,
                            verbose=False)
    layers = ARCHS["llama3-8b"].n_layers
    assert train["kernels"]["ina_matmul"]["launches"] == \
        3 * (7 * layers + 1) + 7 * layers
    assert train["kernels"]["flash_attention"]["launches"] == 2 * layers
    coll = train["collective_bytes_per_device"]
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert coll[kind] > 0, kind
    assert train["memory"]["peak_bytes"] == \
        train["memory"]["argument_bytes"] + train["memory"]["temp_bytes"]
    decode = dryrun.run_cell("llama3-8b", "decode_32k", mesh,
                             roofline=False, verbose=False)
    assert decode["flops_per_device"] > 0 and decode["devices"] == 256
    assert decode["mesh"] == {"data": 16, "model": 16}


def _arguments(cfg, shape: ShapeConfig, mesh: RankMesh, rows: int) -> int:
    """Rank 0's argument bytes: its pieces of the parameters (with
    AdamW's m, v and step for train) and its rows of the batch (int32
    tokens; labels for train), and for decode its cache."""
    model = get_model(cfg)
    world = (mesh.span("data"), mesh.span("model"))
    train = shape.kind == "train"
    pieces = sharding.shard_params(model.init(device="meta", masters=train),
                                   cfg, (0, 0), world)
    # a storage a leaf: a piece of zamba2's w_in is a view of rows padded
    # to a multiple of 8 elements (sharding._take_segments)
    stored = sum(t.untyped_storage().nbytes()
                 for t in torch.utils._pytree.tree_leaves(pieces))
    if train:
        return 3 * stored + 4 + 2 * rows * shape.seq_len * 4
    want = stored + rows * (shape.seq_len if shape.kind ==
                                     "prefill" else 2) * 4
    if shape.kind == "decode":
        want += _nbytes(model.init_cache(rows, shape.seq_len, device="meta",
                                         world=world[1]))
    return want


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_qwen2_cells_fail_with_the_head_cut(shape):
    """qwen2-1.5b's 12 query and 2 KV heads at a model span of 16 used to
    refuse the cut; under the uneven head cut rank 0 holds one query head
    and the KV head it reads (ranks 12-15 none), and the cell completes:
    its launches are one step's of the derived count (7 products a layer
    and the head; flash once a layer, twice in training) and its argument
    bytes its pieces, AdamW state of real heads only."""
    cfg, mesh = ARCHS[QWEN2], make_production_mesh()
    assert sharding.local_heads(cfg, 16) == (1, 1)
    assert [sharding.local_heads(cfg, 16, rank=r)[0] for r in range(16)] \
        == [1] * 12 + [0] * 4
    r = dryrun.run_cell(QWEN2, shape, mesh, roofline=False, verbose=False)
    layers, kind = cfg.n_layers, SHAPES[shape].kind
    launches = {k: v["launches"] for k, v in r["kernels"].items()}
    products = 7 * layers + 1
    want = {"train": {"ina_matmul": 3 * products + 7 * layers,
                      "flash_attention": 2 * layers},
            "prefill": {"ina_matmul": products, "flash_attention": layers},
            "decode": {"ina_matmul": products}}[kind]
    assert launches == want
    rows = SHAPES[shape].global_batch // 16
    assert r["memory"]["argument_bytes"] == \
        _arguments(cfg, SHAPES[shape], mesh, rows)
    pieces = sharding.shard_params(get_model(cfg).init(device="meta"), cfg,
                                   (0, 0), (16, 16))
    hd = cfg.resolved_head_dim
    attn = pieces["layers"]["attn"]
    assert attn["wq"].shape[-1] == attn["wk"].shape[-1] == hd
    assert attn["wo"].shape[-2] == hd


@pytest.mark.parametrize("arch,shape,multi", [
    ("qwen3-14b", "decode_32k", False), ("zamba2-2.7b", "long_500k", True)])
def test_uneven_cells_complete(arch, shape, multi):
    """qwen3-14b's decode at 16 x 16: rank 0 holds query heads 0-2 and
    the one KV head they read (3:1), its cache that KV head; zamba2-2.7b's
    ``long_500k`` (one row) at 2 x 16 x 16: the row replicated over the
    32 hosts, rank 0's arguments its FSDP pieces, the whole row and a
    cache of that row."""
    cfg, mesh = ARCHS[arch], make_production_mesh(multi_pod=multi)
    r = dryrun.run_cell(arch, shape, mesh, roofline=False, verbose=False)
    assert r["flops_per_device"] > 0
    assert r["memory"]["argument_bytes"] == \
        _arguments(cfg, SHAPES[shape], mesh, 1 if multi else 8)
    launches = {k: v["launches"] for k, v in r["kernels"].items()}
    if arch == "qwen3-14b":
        assert sharding.head_split(cfg, 0, 16) == (range(3), range(1))
        assert sharding.kv_index(cfg, 1, 16) == (0, 0, 1)
        assert sharding.cache_heads(cfg, 1, 16) == 3
        assert launches == {"ina_matmul": 7 * cfg.n_layers + 1}
    else:
        assert r["devices"] == 512


def test_cli_writes_results_and_failures(tmp_path, monkeypatch):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                        "--no-roofline", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["failures"] == [] and len(doc["results"]) == 1
    r = doc["results"][0]
    for key in ("arch", "shape", "kind", "mesh", "devices", "psum_mode",
                "trace_s", "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "memory", "kernels"):
        assert key in r, key
    bad = tmp_path / "bad.json"
    # a train batch the 16 hosts do not divide: the train step still
    # refuses it (the reference's fit_specs would move data to the
    # sequence)
    monkeypatch.setitem(SHAPES, "train_8", ShapeConfig("train_8", 4096, 8,
                                                       "train"))
    assert dryrun.main(["--arch", QWEN2, "--shape", "train_8",
                        "--no-roofline", "--out", str(bad)]) == 1
    fail = json.loads(bad.read_text())["failures"]
    assert len(fail) == 1 and "does not divide over 16" in fail[0]["error"]


# --------------------------------------------------------------------------- #
# nothing left behind
# --------------------------------------------------------------------------- #
def _cpu_step():
    cfg = ARCHS[QWEN2].reduced()
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(3)
    params = model.init(gen, device="cpu", masters=True)
    opt = adamw_init(params)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    ts = build_train_step(model, ShapeConfig("t", 16, 2, "train"),
                          base_lr=1e-2, warmup=1)
    params, opt, stats = ts.fn(params, opt, batch)
    return float(stats["loss"]), params


def test_a_trace_leaves_nothing_behind():
    loss, params = _cpu_step()
    launches = (im.launches, fa.launches, wk.launches)
    c = dryrun.trace_step(ARCHS[QWEN2].reduced(), ShapeConfig("x", S, 4,
                                                             "train"),
                          MESHES["data2_model2"])
    assert c.flops > 0 and c.collective_bytes()["total"] > 0
    assert _get_current_dispatch_mode() is None and not cost._ACTIVE
    assert not remat._STACK and not fsdp._ACTIVE and C._TRACE_SITES is None
    assert (im.launches, fa.launches, wk.launches) == launches
    loss2, params2 = _cpu_step()
    assert loss2 == loss
    for (names, a), (_, b) in zip(_named(params), _named(params2)):
        assert torch.equal(a, b), names


if __name__ == "__main__":
    # The ratio table PERF.md reports:
    # JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_dryrun.py
    for family in sorted(FAMILIES):
        arch = FAMILIES[family]
        print(f"{family:8s} {arch:22s} " + "  ".join(
            f"{kind} {_trace(arch, kind).products}/"
            f"{_reference_flops(arch, kind):.0f} = "
            f"{_trace(arch, kind).products / _reference_flops(arch, kind):.3f}"
            for kind in KINDS))
