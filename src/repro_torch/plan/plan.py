"""The :class:`ExecutionPlan` artifact: every launch-time decision, decided
once (counterpart of ``repro.plan.plan``).

An ``ExecutionPlan`` carries the three decisions of one (model config, mesh
shape, phase, dtype):

* ``psum``   — per-site accumulation strategy (Fig. 4 in-network vs
  eject/inject), resolved through the collective cost model once per
  distinct (axis span, payload) shape;
* ``gemms``  — per-GEMM mapper verdicts (searched mapping vs the paper's
  fixed placement, through the mapper search and the sim store);
* ``tiles``  — per-shape ``ina_matmul`` launches on the H100 (regime,
  output tile, cluster, K tile: :mod:`.tiles`), which the projections
  read through ``kernels.ops.matmul(plan=...)``.

Plans are frozen, hashable, and serialize to byte-deterministic JSON, so
they are cacheable (``plan.store``), diffable, and safe to hand to
``ParallelCtx`` (itself a frozen dataclass).  A schema hash over the field
layout plus the cost-model surface guards persisted plans as the sim store
guards its rows.  The port's plans differ from the reference's in two
places: a :class:`TileChoice` is a Hopper launch, not Pallas blocks, and
the schema tag and key are the port's own, so a port plan never answers
a reference plan lookup (and a reference plan file loads as cold).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

#: Bump when plan semantics change in a way field lists cannot see.
PLAN_SCHEMA_VERSION = 1

#: The port's tag: in every schema hash and plan key, so the two packages'
#: plans never share either.
PLAN_TAG = "torch"


def plan_schema_hash() -> str:
    """Hash of everything a persisted plan structurally depends on.

    Covers the port's tag, the plan field layout, the auto-candidate set,
    the NoC config surface the decisions were costed under, the sim-store
    schema (plans and simulation rows must invalidate together — a
    cost-model change re-keys both), the Hopper tile policy's constants,
    and the quick mapper's search space (changing any of them changes plan
    *content*, so stale stores must go cold, never serve old decisions).
    """
    from repro_torch.core.noc.collective.cost import (AUTO_CANDIDATES,
                                                      PSUM_MODE_LOWERING)
    from repro_torch.core.noc.router import NocConfig
    from repro_torch.core.noc.simcache import schema_hash as sim_schema_hash
    from repro_torch.mapper import QUICK_MAPPER
    from .tiles import tile_policy_signature
    parts = (PLAN_TAG, PLAN_SCHEMA_VERSION,
             tuple(PsumDecision.__dataclass_fields__),
             tuple(GemmVerdict.__dataclass_fields__),
             tuple(TileChoice.__dataclass_fields__),
             tuple(ExecutionPlan.__dataclass_fields__),
             AUTO_CANDIDATES,
             tuple(sorted(PSUM_MODE_LOWERING.items())),
             tuple(NocConfig.__dataclass_fields__),
             sim_schema_hash(),
             tile_policy_signature(),
             repr(QUICK_MAPPER))
    return hashlib.sha1(repr(parts).encode()).hexdigest()[:16]


def config_digest(cfg) -> str:
    """Content digest of a ModelConfig (frozen dataclass: repr is total).

    Stored in the plan and checked by ``PlanStore._compatible``: editing a
    registry config (d_ff, n_heads, ...) changes every traced site, so the
    old plan must go cold — the filename key stays readable (model name),
    the digest carries the content identity.
    """
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:12]


def plan_key(model: str, mesh: tuple[tuple[str, int], ...], phase: str,
             dtype: str, chips: int = 1, package: str = "mesh") -> str:
    """Filesystem-safe identity of one plan's inputs (the store filename).

    Multi-chip plans get a ``__cN[e]`` suffix (``e`` = express package) so
    they store alongside — never shadow — the single-chip plan for the
    same (model, mesh, phase, dtype) cell; every key ends in the port's tag
    (``__torch``), which no reference key has.
    """
    mesh_s = "x".join(f"{a}{s}" for a, s in mesh)
    raw = f"{model}__{mesh_s}__{phase}__{dtype}"
    if chips > 1:
        raw += f"__c{chips}" + ("e" if package == "express" else "")
    raw += f"__{PLAN_TAG}"
    return "".join(c if c.isalnum() or c in "._-" else "-" for c in raw)


@dataclass(frozen=True)
class PsumDecision:
    """Resolved strategy for one distinct psum-site shape.

    ``costs`` carries the full simulated candidate comparison —
    ``((mode, latency_cycles, energy_pj), ...)`` in candidate order — so a
    plan documents *why* a site chose its mode, not just the answer.
    """

    p: int                        # axis span
    nbytes: int                   # per-device payload
    mode: str                     # resolved PsumMode (pre divisibility guard)
    ops: tuple[str, ...]          # site kinds mapped here ("psum", ...)
    count: int                    # how many call sites share this shape
    costs: tuple[tuple[str, int, float], ...] = ()

    @property
    def cost_of(self) -> dict:
        return {m: (lat, en) for m, lat, en in self.costs}


@dataclass(frozen=True)
class GemmVerdict:
    """One GEMM's mapper verdict: searched mapping vs the paper placement."""

    layer: str
    M: int
    K: int
    N: int
    mapping: str                  # Mapping.label() of the chosen placement
    dataflow: str                 # "ws" | "os"
    semantics: str                # "ina" | "eject_inject"
    latency_cycles: float
    energy_pj: float
    baseline_latency_cycles: float
    baseline_energy_pj: float

    @property
    def latency_x(self) -> float:
        return self.baseline_latency_cycles / max(self.latency_cycles, 1.0)

    @property
    def energy_x(self) -> float:
        return self.baseline_energy_pj / max(self.energy_pj, 1.0)


@dataclass(frozen=True)
class TileChoice:
    """The ``ina_matmul`` launch for one problem shape on TMA-aligned
    operands: regime, output tile (``tile_m`` x ``tile_n``), cluster size
    (CTAs splitting K) and K tile, as
    :class:`~repro_torch.kernels.ina_matmul.MatmulPlan` holds them."""

    m: int
    k: int
    n: int
    dtype: str
    regime: str
    tile_m: int
    tile_n: int
    cluster: int
    bk: int

    @property
    def matmul_plan(self):
        from repro_torch.kernels.ina_matmul import MatmulPlan
        return MatmulPlan(self.regime, self.tile_m, self.tile_n,
                          self.cluster, self.bk)


@dataclass(frozen=True)
class ExecutionPlan:
    """One planning pass over (model config, mesh shape, phase, dtype)."""

    model: str
    mesh: tuple[tuple[str, int], ...]      # ((axis, span), ...) in mesh order
    phase: str                             # "train" | "prefill" | "decode"
    dtype: str                             # activation/compute dtype
    schema: str = field(default_factory=plan_schema_hash)
    objective: str = "latency"
    psum: tuple[PsumDecision, ...] = ()
    gemms: tuple[GemmVerdict, ...] = ()
    tiles: tuple[TileChoice, ...] = ()
    mapper_hardware: Optional[tuple[int, int, int]] = None
    mapper_space: str = "quick"
    tokens: int = 256                      # GEMM M tile the verdicts/tiles use
    noc: str = ""                          # repr(NocConfig) decisions cost under
    config: str = ""                       # config_digest(cfg) traced from
    #: Chip topology the psum decisions were costed on (DESIGN.md S14):
    #: ``chips`` > 1 means every TP axis is split across that many chips
    #: and the decisions price intra-chip + package levels.
    chips: int = 1
    package: str = "mesh"                  # package variant ("mesh"|"express")

    # ------------------------------------------------------------------ #
    # Consumer lookups (the hot path: O(1) dict probes, indexes built once)
    # ------------------------------------------------------------------ #
    @cached_property
    def _psum_index(self) -> dict:
        return {(d.p, d.nbytes): d.mode for d in self.psum}

    @cached_property
    def _tile_index(self) -> dict:
        return {(t.m, t.k, t.n, t.dtype): t.matmul_plan for t in self.tiles}

    def psum_mode(self, p: int, nbytes: int) -> Optional[str]:
        """Strategy for a (span, payload) site; None = site not planned
        (the caller falls back to trace-time resolution)."""
        return self._psum_index.get((p, int(nbytes)))

    def tile_for(self, m: int, k: int, n: int, dtype: str):
        """The planned ``MatmulPlan`` for an ``ina_matmul`` shape of
        ``dtype`` (the plain name: ``"bfloat16"``, ``"float32"``); None =
        not planned."""
        return self._tile_index.get((m, k, n, dtype))

    @property
    def key(self) -> str:
        """Filesystem-safe identity of this plan's inputs (store filename)."""
        return plan_key(self.model, self.mesh, self.phase, self.dtype,
                        self.chips, self.package)

    @property
    def site_count(self) -> int:
        return sum(d.count for d in self.psum)

    def psum_summary(self) -> dict:
        """Histogram + predicted deltas vs the Fig. 4(a) baseline.

        ``latency_delta_x`` / ``energy_delta_x`` weight each distinct site
        by its call-site count: what the whole model's accumulation traffic
        gains over running every site eject/inject.
        """
        modes: dict[str, int] = {}
        chosen_lat = base_lat = chosen_en = base_en = 0.0
        for d in self.psum:
            modes[d.mode] = modes.get(d.mode, 0) + d.count
            cost = d.cost_of
            if d.mode in cost and "eject_inject" in cost:
                chosen_lat += cost[d.mode][0] * d.count
                chosen_en += cost[d.mode][1] * d.count
                base_lat += cost["eject_inject"][0] * d.count
                base_en += cost["eject_inject"][1] * d.count
        return {
            "sites": self.site_count,
            "distinct": len(self.psum),
            "modes": dict(sorted(modes.items())),
            "latency_delta_x": base_lat / chosen_lat if chosen_lat else 1.0,
            "energy_delta_x": base_en / chosen_en if chosen_en else 1.0,
        }

    # ------------------------------------------------------------------ #
    # Serialization (byte-deterministic: sorted keys, fixed separators)
    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=1)

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionPlan":
        return cls(
            model=d["model"],
            mesh=tuple((a, s) for a, s in d["mesh"]),
            phase=d["phase"], dtype=d["dtype"], schema=d["schema"],
            objective=d["objective"],
            psum=tuple(PsumDecision(
                p=r["p"], nbytes=r["nbytes"], mode=r["mode"],
                ops=tuple(r["ops"]), count=r["count"],
                costs=tuple((m, lat, en) for m, lat, en in r["costs"]))
                for r in d["psum"]),
            gemms=tuple(GemmVerdict(**r) for r in d["gemms"]),
            tiles=tuple(TileChoice(**r) for r in d["tiles"]),
            mapper_hardware=tuple(d["mapper_hardware"])
            if d.get("mapper_hardware") else None,
            mapper_space=d["mapper_space"], tokens=d["tokens"],
            noc=d.get("noc", ""), config=d.get("config", ""),
            chips=d.get("chips", 1), package=d.get("package", "mesh"))

    @classmethod
    def from_json(cls, text: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(text))
