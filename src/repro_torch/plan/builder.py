"""The planning pass: one shape-only trace + one resolution sweep per plan
(counterpart of ``repro.plan.builder``).

:func:`build_plan` runs once per (model config, mesh shape, phase, dtype)
and produces an :class:`~.plan.ExecutionPlan` in three steps:

1. *Site collection*: the port's model runs on the ``meta`` device (shapes,
   no data, no device) with
   :func:`repro_torch.core.collectives.record_psum_sites` active, so every
   ``mode="auto"`` psum site reports its (axis span, payload) instead of
   resolving itself.  The reference traces with ``jax.eval_shape`` over an
   ``AbstractMesh``; here a model axis of any span is an
   :class:`~repro_torch.core.collectives.AxisSpan`, a group without
   processes.  The reference traces its ``lax.scan`` body once, so it
   records one site a layer body; the port's Python loop records every
   layer's, so a decision's ``count`` is the reference's times the depth.
2. *Resolution*: the deduplicated site shapes are costed once each through
   the NoC collective cost model (riding the persistent sim store, so a
   warm store resolves with no engine run) and the winning strategy
   recorded beside the full candidate comparison.
3. *Mapper + tiles*: the config's decoder-block GEMMs get a mapping-search
   verdict (through the same sim store) and a Hopper launch
   (:mod:`.tiles`, pure arithmetic).

The trace runs the whole weights, not a rank's shard.  A row-parallel
site's payload is its output, ``[..., d_model]``, whatever slice of the
contraction a rank holds, and the port's explicit shards cut whole heads
(``parallel/sharding.py``), which cannot cut qwen2-1.5b's 12 heads 16
ways; the reference's GSPMD never needs to.  The MoE combine is the same:
with the whole experts the trace's partial is the [T, D] every rank's is,
one site a layer beside the shared experts' own.  RWKV6's output norm
takes its statistic over the group only where a rank holds part of the
heads, so the trace (whole heads) runs no collective for it, and a sharded
rank's native all-reduce there is no site either; Mamba2's gate norm is
the same.  Every family traces at any model span: zamba2 records its
Mamba2 layers' ``w_out`` ([..., d_model]) and its shared block's ``wo``
and MLP ``w_down`` ([..., 2 x d_model]), vlm and whisper both
attentions' ``wo`` and the MLPs' ``w_down`` (whisper's encoder over the
frames), each row-parallel product one site.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.noc import NocConfig

from .plan import (ExecutionPlan, GemmVerdict, PsumDecision, TileChoice,
                   config_digest, plan_schema_hash)
from .tiles import choose_tiles

#: Phase -> the canonical ShapeConfig traced for it.
PHASES = ("train", "prefill", "decode")
PHASE_SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
                "decode": "decode_32k"}

#: The mesh axis whose span the model's row-parallel sites reduce over.
MODEL_AXIS = "model"


def normalize_mesh(mesh_shape) -> tuple[tuple[str, int], ...]:
    """((axis, span), ...) from a dict, a pair list, or anything with a
    ``shape`` mapping."""
    shape = getattr(mesh_shape, "shape", mesh_shape)
    if hasattr(shape, "items"):
        return tuple((str(a), int(s)) for a, s in shape.items())
    return tuple((str(a), int(s)) for a, s in shape)


def model_span(mesh_shape) -> int:
    """The span of the mesh's ``model`` axis (1 where it has none)."""
    return dict(normalize_mesh(mesh_shape)).get(MODEL_AXIS, 1)


def phase_shape(phase: str, shape: Optional[ShapeConfig] = None,
                ) -> ShapeConfig:
    if shape is not None:
        return shape
    if phase not in PHASE_SHAPES:
        raise ValueError(f"unknown phase {phase!r}; pick from {PHASES}")
    return SHAPES[PHASE_SHAPES[phase]]


def collect_psum_sites(cfg: ModelConfig, mesh, shape: ShapeConfig) -> list:
    """Run one phase on the ``meta`` device and return its recorded
    ``PsumSite`` list (see the module docstring).  At a model span of 1
    there is no group, so no site, as the reference records none."""
    from repro_torch.core.collectives import AxisSpan, record_psum_sites
    from repro_torch.models.api import get_model
    from repro_torch.parallel.tp import ParallelCtx

    model = get_model(cfg)
    p = model_span(mesh)
    pctx = ParallelCtx(group=AxisSpan(p) if p > 1 else None, psum_mode="auto")
    params = model.init(device="meta")
    batch = model.input_specs(shape)
    with record_psum_sites() as sites, torch.no_grad():
        if shape.kind == "train":
            model.loss(params, batch, pctx)
        elif shape.kind == "prefill":
            model.forward(params, batch, pctx)
        else:
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     device="meta")
            model.decode_step(params, batch, cache, pctx)
    return sites


def resolve_sites(sites: Sequence, objective: str = "latency",
                  noc_cfg: NocConfig = NocConfig(), *,
                  chips: int = 1, package: str = "mesh",
                  ) -> tuple[PsumDecision, ...]:
    """Dedup recorded sites and cost each distinct shape exactly once.

    Resolution calls the same ``choose_psum_mode`` the planless path uses
    (same defaults, same tie-breaks), so a plan-driven run picks the
    strategies the per-call-site auto path picks.  With ``chips`` > 1 the
    TP axis spans chips and every site is priced through the package
    hierarchy (:mod:`repro_torch.core.noc.hierarchy`): intra-chip rows plus
    a package-level allreduce, the same candidates and tie-breaks."""
    from repro_torch.core.noc.collective.cost import AUTO_CANDIDATES
    if chips > 1:
        from repro_torch.core.noc.hierarchy import (choose_hier_psum_mode,
                                                    hier_psum_mode_costs)

        def _costs(p, nbytes):
            return hier_psum_mode_costs(p, nbytes, noc_cfg, chips=chips,
                                        package=package)

        def _choose(p, nbytes):
            return choose_hier_psum_mode(p, nbytes, noc_cfg, chips=chips,
                                         package=package,
                                         objective=objective)
    else:
        from repro_torch.core.noc.collective.cost import (choose_psum_mode,
                                                          psum_mode_costs)

        def _costs(p, nbytes):
            return psum_mode_costs(p, nbytes, noc_cfg)

        def _choose(p, nbytes):
            return choose_psum_mode(p, nbytes, noc_cfg, objective=objective)

    groups: dict[tuple[int, int], dict] = {}
    for s in sites:
        g = groups.setdefault((s.p, s.nbytes), {"count": 0, "ops": set()})
        g["count"] += 1
        g["ops"].add(s.op)
    out = []
    for (p, nbytes), g in sorted(groups.items()):
        costs = _costs(p, nbytes)
        mode = _choose(p, nbytes)
        out.append(PsumDecision(
            p=p, nbytes=nbytes, mode=mode,
            ops=tuple(sorted(g["ops"])), count=g["count"],
            costs=tuple((m, costs[m].latency_cycles, costs[m].energy_pj)
                        for m in AUTO_CANDIDATES)))
    return tuple(out)


#: (cfg, tokens, mapper_space) -> gemm_verdicts result.  Verdicts are a
#: pure function of those three (deterministic search; ``jobs`` only
#: parallelizes), and train/prefill phases share tokens=256: without the
#: memo every full plan sweep would run the same search once per phase.
_GEMM_MEMO: dict = {}


def gemm_verdicts(cfg: ModelConfig, tokens: int, mapper_space: str = "quick",
                  jobs: int = 1,
                  ) -> tuple[tuple[GemmVerdict, ...],
                             Optional[tuple[int, int, int]]]:
    """Mapper search over the config's decoder-block GEMMs: the quick
    mapper (``mapper_space="quick"``, the default) or the full space."""
    from repro_torch.mapper import MapperConfig, QUICK_MAPPER, search_network
    from repro_torch.models.api import get_model

    memo_key = (cfg, tokens, mapper_space)
    hit = _GEMM_MEMO.get(memo_key)
    if hit is not None:
        return hit
    layers = get_model(cfg).gemm_layers(tokens)
    mcfg = QUICK_MAPPER if mapper_space == "quick" else MapperConfig()
    out = search_network(f"{cfg.name}:gemm", layers, mcfg, jobs=jobs)
    by_name = {l.name: l for l in layers}
    verdicts = []
    for a, b in zip(out.best.assignments, out.baseline.assignments):
        layer = by_name[a.layer]
        verdicts.append(GemmVerdict(
            layer=a.layer, M=layer.M, K=layer.K, N=layer.N,
            mapping=a.mapping.label(), dataflow=a.mapping.dataflow,
            semantics=a.mapping.semantics,
            latency_cycles=a.latency_cycles, energy_pj=a.total_energy_pj,
            baseline_latency_cycles=b.latency_cycles,
            baseline_energy_pj=b.total_energy_pj))
    _GEMM_MEMO[memo_key] = (tuple(verdicts), out.best.hardware)
    return _GEMM_MEMO[memo_key]


def tile_choices(cfg: ModelConfig, tokens: int,
                 dtype: str) -> tuple[TileChoice, ...]:
    """Deduplicated Hopper launches over the config's GEMM shapes."""
    from repro_torch.models.api import get_model
    out, seen = [], set()
    for layer in get_model(cfg).gemm_layers(tokens):
        key = (layer.M, layer.K, layer.N, dtype)
        if key in seen:
            continue
        seen.add(key)
        launch = choose_tiles(layer.M, layer.K, layer.N, dtype)
        out.append(TileChoice(m=layer.M, k=layer.K, n=layer.N, dtype=dtype,
                              regime=launch.regime, tile_m=launch.tile_m,
                              tile_n=launch.tile_n, cluster=launch.cluster,
                              bk=launch.bk))
    return tuple(sorted(out, key=lambda t: (t.m, t.k, t.n)))


def build_plan(cfg: ModelConfig, mesh_shape, phase: str, *,
               objective: str = "latency",
               mapper_space: str = "quick",
               gemm_search: bool = True,
               tokens: Optional[int] = None,
               shape: Optional[ShapeConfig] = None,
               noc_cfg: NocConfig = NocConfig(),
               chips: int = 1,
               package: str = "mesh") -> ExecutionPlan:
    """One planning pass -> a frozen, serializable :class:`ExecutionPlan`.

    ``mesh_shape`` is a dict or (axis, span) pairs; ``tokens`` defaults to
    the mapper's 256-token M tile for train/prefill and the batch width
    for decode (a decode GEMM runs one token per sequence).
    ``mapper_space`` picks the quick mapper or the full space for the
    verdicts; ``gemm_search=False`` skips them (tile and psum planning
    keep working).  ``chips`` > 1 prices the psum sites as a TP axis split
    across that many chips joined by a ``package`` network
    (:func:`resolve_sites`); the GEMM verdicts and tiles are one chip's.
    """
    shape = phase_shape(phase, shape)
    mesh = normalize_mesh(mesh_shape)
    if tokens is None:
        tokens = shape.global_batch if shape.kind == "decode" else 256
    dtype = str(cfg.dtype)

    sites = collect_psum_sites(cfg, mesh, shape)
    psum = resolve_sites(sites, objective=objective, noc_cfg=noc_cfg,
                         chips=chips, package=package)
    if gemm_search:
        gemms, hardware = gemm_verdicts(cfg, tokens, mapper_space)
    else:
        gemms, hardware = (), None
    tiles = tile_choices(cfg, tokens, dtype)

    return ExecutionPlan(
        model=cfg.name, mesh=mesh, phase=phase, dtype=dtype,
        schema=plan_schema_hash(), objective=objective,
        psum=psum, gemms=gemms, tiles=tiles,
        mapper_hardware=hardware, mapper_space=mapper_space, tokens=tokens,
        noc=repr(noc_cfg), config=config_digest(cfg),
        chips=chips, package=package)
