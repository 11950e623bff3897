"""Static verification of execution plans (the ``verify_plan`` part of
``repro.analysis.verify``).

The psum checks are the reference's: a decision's mode is one of
``AUTO_CANDIDATES`` and the argmin of its recorded costs under the plan's
objective.  The tile checks are the H100's in place of the reference's
(exact divisibility, the VMEM budget): each :class:`~repro_torch.plan.
TileChoice` must be a launch ``csrc/ina_matmul.cu`` can make
(:mod:`repro_torch.plan.tiles`).  The reference's packet-program,
schedule and fault verifiers are not copied (``ROADMAP.md`` Queue 1, item
3.2).
"""
from __future__ import annotations

from .findings import Finding


def verify_plan(plan, *, check_layers: bool = False) -> list[Finding]:
    """ExecutionPlan invariants (structural; ``check_layers=True`` also
    re-derives the model's GEMM layers from the registry config)."""
    from repro_torch.core.noc.collective.cost import AUTO_CANDIDATES
    from repro_torch.plan.plan import plan_schema_hash
    out: list[Finding] = []
    where = f"plan {plan.key}"
    current = plan_schema_hash()
    if plan.schema != current:
        out.append(Finding("plan-schema", where,
                           f"schema hash {plan.schema} is stale "
                           f"(current {current})"))
    if plan.objective not in ("latency", "energy"):
        out.append(Finding("plan-mode", where,
                           f"unknown objective {plan.objective!r}"))
    rank = {m: j for j, m in enumerate(AUTO_CANDIDATES)}
    for d in plan.psum:
        dwhere = f"{where} psum(p={d.p}, nbytes={d.nbytes})"
        if d.mode not in AUTO_CANDIDATES:
            out.append(Finding(
                "plan-mode", dwhere,
                f"resolved mode {d.mode!r} not in AUTO_CANDIDATES "
                f"{AUTO_CANDIDATES}"))
            continue
        if d.p < 1 or d.nbytes < 0 or d.count < 1:
            out.append(Finding("plan-mode", dwhere,
                               "non-positive span/payload/count"))
        if not d.costs:
            continue
        modes = tuple(m for m, _, _ in d.costs)
        if modes != AUTO_CANDIDATES:
            out.append(Finding(
                "plan-mode", dwhere,
                f"recorded cost candidates {modes} != AUTO_CANDIDATES"))
            continue
        col = 1 if plan.objective == "latency" else 2
        best = min(d.costs, key=lambda row: (row[col], rank[row[0]]))[0]
        if best != d.mode:
            out.append(Finding(
                "plan-mode", dwhere,
                f"stored mode {d.mode!r} is not the {plan.objective} "
                f"argmin of its recorded costs (that is {best!r})"))
    for t in plan.tiles:
        out.extend(_tile_findings(t, f"{where} tile({t.m}x{t.k}x{t.n}, "
                                     f"{t.dtype})"))
    if check_layers:
        out.extend(_plan_layer_findings(plan))
    return out


def _tile_findings(t, where: str) -> list[Finding]:
    """Can ``csrc/ina_matmul.cu`` launch ``t`` on one H100?"""
    from repro_torch.kernels.ina_matmul import (BK, GENERIC_BK, MAX_CLUSTER,
                                                SMS, TMA_TILES)
    from repro_torch.plan.tiles import SMEM_LIMIT, tile_working_set
    tiles = {"generic": {(64, 64)}, "f32": {(64, 64)}}
    for regime, tm, tn in TMA_TILES:
        tiles.setdefault(regime, set()).add((tm, tn))
    if t.regime not in tiles:
        return [Finding("plan-tile", where,
                        f"regime {t.regime!r}: the kernel has "
                        f"{sorted(tiles)}")]
    if (t.regime == "f32") != (t.dtype == "float32"):
        return [Finding("plan-tile", where,
                        f"regime {t.regime!r} does not take {t.dtype}")]
    if (t.tile_m, t.tile_n) not in tiles[t.regime]:
        return [Finding("plan-tile", where,
                        f"{t.regime} tile {t.tile_m}x{t.tile_n} is not "
                        f"instantiated (the kernel has "
                        f"{sorted(tiles[t.regime])})")]
    out = []
    bk = {"generic": GENERIC_BK, "f32": 1}.get(t.regime, BK)
    if t.bk != bk:
        out.append(Finding("plan-tile", where,
                           f"K tile {t.bk}, the {t.regime} kernel's is {bk}"))
    c = t.cluster
    if c < 1 or c > MAX_CLUSTER or c & (c - 1):
        out.append(Finding("plan-tile", where,
                           f"cluster {c} is not a power of two <= "
                           f"{MAX_CLUSTER}"))
    elif c > 1:
        n_tiles = -(-t.m // t.tile_m) * -(-t.n // t.tile_n)
        k_tiles = -(-t.k // t.bk)
        if t.regime not in ("wide", "narrow"):
            out.append(Finding("plan-tile", where,
                               f"the {t.regime} kernel splits no K"))
        if n_tiles * c > SMS:
            out.append(Finding(
                "plan-tile", where,
                f"{n_tiles} tiles x cluster {c} CTAs > {SMS} SMs (one CTA "
                f"an SM)"))
        if k_tiles < 2 * c:
            out.append(Finding(
                "plan-tile", where,
                f"{k_tiles} K tiles over {c} CTAs leave a CTA fewer than "
                f"2"))
    smem = tile_working_set(t.matmul_plan)
    if smem > SMEM_LIMIT:
        out.append(Finding("plan-tile", where,
                           f"{smem} bytes of shared memory a CTA > "
                           f"{SMEM_LIMIT}"))
    return out


def _plan_layer_findings(plan) -> list[Finding]:
    from repro_torch.configs import ARCHS
    from repro_torch.models.api import get_model
    from repro_torch.plan.plan import config_digest
    where = f"plan {plan.key}"
    cfg = ARCHS.get(plan.model)
    if cfg is None:
        return [Finding("plan-gemm", where,
                        f"model {plan.model!r} not in the config registry")]
    out: list[Finding] = []
    if plan.config and plan.config != config_digest(cfg):
        out.append(Finding(
            "plan-schema", where,
            "recorded config digest differs from the registry config "
            "(plan was built from different model contents)"))
        return out
    layers = get_model(cfg).gemm_layers(plan.tokens)
    by_name = {l.name: l for l in layers}
    for g in plan.gemms:
        gwhere = f"{where} gemm {g.layer}"
        layer = by_name.get(g.layer)
        if layer is None:
            out.append(Finding("plan-gemm", gwhere,
                               "verdict references a layer the model "
                               "does not produce"))
        elif (g.M, g.K, g.N) != (layer.M, layer.K, layer.N):
            out.append(Finding(
                "plan-gemm", gwhere,
                f"verdict shape {(g.M, g.K, g.N)} != model layer shape "
                f"{(layer.M, layer.K, layer.N)}"))
    covered = {(t.m, t.k, t.n) for t in plan.tiles
               if t.dtype == plan.dtype}
    for layer in layers:
        if (layer.M, layer.K, layer.N) not in covered:
            out.append(Finding(
                "plan-tile", f"{where} gemm {layer.name}",
                f"no tile choice covers GEMM shape "
                f"{(layer.M, layer.K, layer.N)} at dtype {plan.dtype}"))
    return out
