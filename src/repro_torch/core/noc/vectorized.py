"""Vectorized array-kernel simulation backend (a copy of
``repro.core.noc.vectorized``).

The compiled engine (:mod:`repro_torch.core.noc.compiled`) removed the heap
engine's per-op *Python object* cost but kept its per-*event* cost: every
flit grant is still one ``heappop``.  This module removes the event loop
itself for the program families that dominate full-space search, by
lowering :class:`~repro_torch.core.noc.collective.schedule.PacketOp`
programs into array kernels whose dependency structure is resolved **once
at lowering time**:

K1 — *window pipeline closed form* (``ws_ina`` / ``os_gather`` /
    ``ws_noina`` with P#=1).  A window of ``k`` rounds is ``k*W``
    identical, dependency-free column gather packets.  Columns are
    resource-disjoint and each column is a uniform tandem pipeline, so
    every grant time has the exact solution ``g(r, j) = r*F + ni + R +
    j*(R+L)`` and the window makespan is **linear in k**::

        latency(k) = (k-1)*F + 2*ni + R + n_links*(R+L) + F - 1

    which evaluates *all window lengths of all stacked plan shapes* in
    one batched array pass (the two outer batching axes the event loop
    cannot express: windows x candidate mappings).

K2 — *column-factored replay* (``ws_noina`` with P# > 1).  Relay chains
    make per-round timing genuinely contention-coupled, but columns stay
    exactly resource-disjoint and identical, so the full ``W``-column
    window is priced by replaying **one column** on the compiled engine
    (latency is the column's; the ledger scales by ``W``): ``W``x fewer
    events with bit-identical results.

K3 — *contention-free DAG wavefront kernel* (tree collectives).  When
    every link/port is used by at most one op (single-tree INA reduce /
    multicast / gather: segments are edge-disjoint, leaves inject on
    distinct ports, one root ejection), plus the one benign exception
    of sibling root-fanout segments sharing the root's injection port,
    grant times degenerate to a pure longest-path over the dependency
    DAG.  Dependency levels are resolved at lowering; each wavefront is
    one batched ``maximum.at`` array step instead of thousands of heap
    pops.

Bit-exactness contract (the heap engine stays the oracle): every kernel
reproduces the event engines' integer grant arithmetic *exactly*, and
ledgers are only ever produced through the dyadic-exactness gate
(:func:`_scale_exact`): a float total is scaled/multiplied only when every
partial sum of the event engines' sequential accumulation is provably
exact (all components are dyadic rationals of bounded magnitude), so any
summation order, a multiplication included, yields the identical float.
Programs outside these families (eject-inject relays, rs_ag chunk trees,
express-lane paths, non-dyadic payloads) raise
:class:`UnvectorizableProgram` and fall back to the compiled/heap engines
with an attributable :data:`VECTOR_STATS` counter.

numpy is optional: the closed forms and column replay are scalar-exact
without it; the batched window pass and the K3 wavefront kernel require
it and fall back cleanly when it is absent.  The batched window pass can
run in PyTorch on a device instead (``set_array_backend("torch",
device=...)``, the counterpart of the reference's x64 ``jax.numpy``
backend): ``int64`` and ``float64`` tensors, each ledger component one
float64 multiply and the latency one int64-to-float64 cast, which IEEE
rounds the same on a GPU as in numpy.  It never falls back: a device that
cannot be had raises.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Iterable, Optional, Sequence

from .compiled import (CompiledProgram, UncompilableProgram, compile_program)
from .router import EnergyLedger, NocConfig
from .simulator import effective_vcs

try:                                    # soft dependency: kernels degrade
    import numpy as _np                 # to scalar closed forms without it
except ImportError:                     # pragma: no cover - env dependent
    _np = None

#: Observable lowering/execution effort, in the style of
#: ``topology.ROUTE_STATS`` / ``collective.cost.COST_STATS``.  The
#: ``fallback_*`` counters attribute every refusal to its reason, so a
#: sweep can prove which families ran vectorized (surfaced next to
#: ``SimCache.stats()`` in benchmark snapshots and sweep summaries).
VECTOR_STATS = {
    "programs_lowered": 0,      # K3 DAG programs lowered + run
    "wavefronts_batched": 0,    # dependency levels executed as one step
    "windows_closed_form": 0,   # K1 window results (incl. batched)
    "windows_batched": 0,       # K1 results produced by a batched pass
    "columns_replayed": 0,      # K2 column-factored window replays
    "fallback_contention": 0,   # resource shared outside the known forms
    "fallback_route": 0,        # unencodable route/port (compiled refuses)
    "fallback_energy": 0,       # non-dyadic energy component (order matters)
    "fallback_backend": 0,      # numpy missing / backend unavailable
}

_STATE = {"enabled": True, "backend": "numpy", "device": None}


def vectorized_enabled() -> bool:
    return _STATE["enabled"]


@contextmanager
def vectorized_disabled():
    """Force the compiled/heap engines everywhere."""
    prev = _STATE["enabled"]
    _STATE["enabled"] = False
    try:
        yield
    finally:
        _STATE["enabled"] = prev


def set_array_backend(name: str, device=None) -> str:
    """Select the array module for the batched window pass: ``numpy``
    (default) or ``torch`` on ``device`` (default ``"cuda"``).  The torch
    backend computes in int64 and float64 only (float32 would break the
    bit-exactness contract) and raises where its device cannot be had; it
    never falls back to numpy.  Returns the backend in effect."""
    if name == "torch":
        from repro_torch._device import resolve
        dev = resolve("cuda" if device is None else device)
        _STATE["backend"], _STATE["device"] = "torch", dev
        return "torch"
    _STATE["backend"], _STATE["device"] = "numpy", None
    return "numpy"


def _pipeline_rows(pipeline: list) -> list:
    """``[latency, 7 ledger components]`` of each pipeline-family key, in
    one array pass on the selected backend: ``latency = ((k-1)*F + d1)``
    cast once to float64, and each component the per-op float64 energy
    times the op count, one multiply.  The rows come back to the host as
    Python floats in one transfer."""
    if _STATE["backend"] == "torch":
        import torch
        int64, float64 = torch.int64, torch.float64

        def col(values, dtype):
            return torch.tensor(values, dtype=dtype, device=_STATE["device"])

        def cast(x, dtype):
            return x.to(dtype)
        cat = torch.cat
    else:
        int64, float64, cat = _np.int64, _np.float64, _np.concatenate

        def col(values, dtype):
            return _np.asarray(values, dtype=dtype)

        def cast(x, dtype):
            return x.astype(dtype)
    ws = col([window for _, window, _ in pipeline], int64)
    f = col([c[1] for _, _, c in pipeline], int64)
    d1 = col([c[2] for _, _, c in pipeline], int64)
    n_ops = cast(ws * col([c[0] for _, _, c in pipeline], int64), float64)
    lat = cast((ws - 1) * f + d1, float64)
    comps = col([c[3] for _, _, c in pipeline], float64) * n_ops[:, None]
    return cat([lat[:, None], comps], 1).tolist()


class UnvectorizableProgram(ValueError):
    """The program is outside every family the lowering can express."""


def vector_stats() -> dict:
    """A ``SimCache.stats()``-style summary snapshot (private copy)."""
    out = dict(VECTOR_STATS)
    out["enabled"] = _STATE["enabled"]
    out["fallbacks"] = sum(v for k, v in VECTOR_STATS.items()
                           if k.startswith("fallback_"))
    return out


def reset_vector_stats() -> None:
    for k in VECTOR_STATS:
        VECTOR_STATS[k] = 0


# --------------------------------------------------------------------------- #
# Dyadic-exactness gate
# --------------------------------------------------------------------------- #
#: Energy components are gated as m * 2^-16 with |total| < 2^53: every
#: partial sum of the engines' sequential accumulation is then exactly
#: representable, so sum order is irrelevant and N*v == v+v+...+v bit for
#: bit.  (Default configs produce small ints and n/4 dyadics —
#: gather_payload_bits 32 over flit_bits 128; an exotic flit_bits makes
#: the check fail and the program fall back.)
_DYADIC_SCALE = 65536.0
_EXACT_BOUND = float(2 ** 53)


def _scale_exact(value: float, count: float) -> bool:
    """True iff ``count`` sequential float adds of ``value`` are provably
    exact (equivalently: ``count * value`` equals the sequential sum)."""
    scaled = value * _DYADIC_SCALE
    return scaled == int(scaled) and abs(scaled) * count < _EXACT_BOUND


# --------------------------------------------------------------------------- #
# K1 — window pipeline closed form
# --------------------------------------------------------------------------- #
def window_family(mode: str, p: int) -> str:
    """``"pipeline"`` (K1) or ``"chain"`` (K2) for a WS/OS window key."""
    return "chain" if (mode == "ws_noina" and p > 1) else "pipeline"


def _pipeline_consts(cfg: NocConfig, mode: str, g: int, p: int,
                     gather_flits: int, e_pes: int):
    """Per-round constants of the K1 closed form, or None if the shape is
    outside the family's guarantees (then: compiled/heap fallback).

    Returns ``(width, flits, d1, energy_tuple)`` where a ``k``-round
    window has latency ``(k-1)*flits + d1`` and ledger ``k*width *
    energy_tuple`` (per-op static contributions, identical to
    ``compile_program``'s lowering of the single gather op).
    """
    if window_family(mode, p) != "pipeline":
        return None
    if effective_vcs(cfg) < 2:          # gather rides VC1
        return None
    w, h = cfg.width, cfg.height
    if w < 1 or h < 1 or gather_flits < 1:
        return None
    f = gather_flits
    n_links = h - 1
    r_cyc, l_cyc, ni = cfg.router_cycles, cfg.link_cycles, cfg.ni_cycles
    d1 = 2 * ni + r_cyc + n_links * (r_cyc + l_cyc) + f - 1
    ina = mode == "ws_ina"
    extra = float(f - 1)
    reduce_words = g * (p - 1) if ina else 0
    if ina:
        extra += (reduce_words * e_pes * cfg.gather_payload_bits
                  / cfg.flit_bits)
    energy = (0.0,                              # pe_adds
              extra + f * 2,                    # ni flits (inject + eject)
              float(f * (n_links + 1)),         # flit x router
              float(f * n_links),               # flit x link
              float(n_links),                   # packet hops
              float(reduce_words),              # INA adds
              2.0)                              # packets built (inj + ej)
    return w, f, d1, energy


def _ledger_from_components(counts_x_energy: Sequence[float]) -> EnergyLedger:
    pe, ni, routers, links, hops, radds, pkts = counts_x_energy
    return EnergyLedger(pe_adds=pe, ni_flits=ni, flit_routers=routers,
                        flit_links=links, packet_hops=hops,
                        router_adds=radds, packets_built=pkts)


def _pipeline_window(cfg: NocConfig, mode: str, window: int, g: int, p: int,
                     gather_flits: int, e_pes: int
                     ) -> Optional[tuple[float, EnergyLedger]]:
    consts = _pipeline_consts(cfg, mode, g, p, gather_flits, e_pes)
    if consts is None:
        return None
    w, f, d1, energy = consts
    n_ops = window * w
    if not all(_scale_exact(e, n_ops) for e in energy if e):
        VECTOR_STATS["fallback_energy"] += 1
        return None
    latency = float((window - 1) * f + d1)
    VECTOR_STATS["windows_closed_form"] += 1
    return latency, _ledger_from_components([e * n_ops for e in energy])


# --------------------------------------------------------------------------- #
# K2 — column-factored replay (ws_noina, P# > 1)
# --------------------------------------------------------------------------- #
#: (cfg, mode, g, p, gather_flits, unicast_flits, e_pes) -> compiled
#: one-round column-0 program (windows replicate it, as _ROUND_PROGRAMS).
_COLUMN_PROGRAMS: dict = {}


def clear_vector_caches() -> None:
    _COLUMN_PROGRAMS.clear()


def _column_round(cfg: NocConfig, mode: str, g: int, p: int,
                  gather_flits: int, unicast_flits: int, e_pes: int
                  ) -> Optional[CompiledProgram]:
    """One round of column 0 only, compiled (deps reindexed).

    ``ws_round_program`` emits per-column op groups whose resources and
    dependencies never cross columns, and every column is the same
    pattern shifted in x — so the W-column window's latency is column
    0's and its ledger is W x column 0's (gated by :func:`_scale_exact`).
    """
    key = (cfg, mode, g, p, gather_flits, unicast_flits, e_pes)
    hit = _COLUMN_PROGRAMS.get(key)
    if hit is not None:
        return hit
    from .collective.schedule import ws_round_program
    prog = ws_round_program(cfg, mode, 1, g=g, p=p,
                            gather_flits=gather_flits,
                            unicast_flits=unicast_flits, e_pes=e_pes)
    col, remap = [], {}
    for i, op in enumerate(prog):
        if op.src[0] != 0:
            continue
        if op.dst[0] != 0 or any(d not in remap for d in op.deps):
            VECTOR_STATS["fallback_contention"] += 1    # cross-column op
            return None
        remap[i] = len(col)
        if op.deps:
            op = dataclasses.replace(op,
                                     deps=tuple(remap[d] for d in op.deps))
        col.append(op)
    if not col or len(col) * cfg.width != len(prog):
        VECTOR_STATS["fallback_contention"] += 1        # asymmetric columns
        return None
    try:
        base = compile_program(col, cfg)
    except UncompilableProgram:
        VECTOR_STATS["fallback_route"] += 1
        return None
    _COLUMN_PROGRAMS[key] = base
    return base


def _chain_window(cfg: NocConfig, mode: str, window: int, g: int, p: int,
                  gather_flits: int, unicast_flits: int, e_pes: int
                  ) -> Optional[tuple[float, EnergyLedger]]:
    base = _column_round(cfg, mode, g, p, gather_flits, unicast_flits, e_pes)
    if base is None:
        return None
    latency, ledger, _, _ = base.replicate(window).run()
    w = cfg.width
    comps = ledger.as_tuple()
    if not all(_scale_exact(c, w) for c in comps if c):
        VECTOR_STATS["fallback_energy"] += 1
        return None
    VECTOR_STATS["columns_replayed"] += 1
    return float(latency), EnergyLedger.from_tuple([c * w for c in comps])


# --------------------------------------------------------------------------- #
# Window entry points (traffic._sim_rounds_window + mapper prefetch)
# --------------------------------------------------------------------------- #
def window_result(cfg: NocConfig, mode: str, window: int, g: int, p: int,
                  gather_flits: int, unicast_flits: int, e_pes: int
                  ) -> Optional[tuple[float, EnergyLedger]]:
    """Exact (latency, ledger) of one WS/OS window, or None (fallback)."""
    if not _STATE["enabled"]:
        return None
    if window_family(mode, p) == "pipeline":
        return _pipeline_window(cfg, mode, window, g, p, gather_flits, e_pes)
    return _chain_window(cfg, mode, window, g, p, gather_flits,
                         unicast_flits, e_pes)


def prefetch_windows(keys: Iterable[tuple]) -> int:
    """Batch-evaluate window keys and fill ``SIM_CACHE``; returns the
    number of keys answered.

    ``keys`` use the ``_sim_rounds_window`` layout ``(cfg, mode, window,
    g, p, gather_flits, unicast_flits, e_pes)``.  Pipeline-family keys
    are stacked into one array pass — this is the mapper's candidate-
    mapping batching axis: all (hardware, dataflow, E, G, window) shapes
    of a layer's keep set price in one vectorized step.  Chain-family
    keys replay their column programs individually.
    """
    from .simcache import SIM_CACHE

    if not (_STATE["enabled"] and SIM_CACHE.enabled):
        return 0
    pipeline, chain, answered = [], [], 0
    seen = set()
    for key in keys:
        if key in seen or key in SIM_CACHE:
            continue
        seen.add(key)
        cfg, mode, window, g, p, gather_flits, unicast_flits, e_pes = key
        if window_family(mode, p) == "pipeline":
            consts = _pipeline_consts(cfg, mode, g, p, gather_flits, e_pes)
            if consts is not None:
                pipeline.append((key, window, consts))
                continue
        chain.append(key)

    batched = _np is not None or _STATE["backend"] == "torch"
    if pipeline and batched and len(pipeline) > 1:
        rows = _pipeline_rows(pipeline)
        for (key, window, consts), row in zip(pipeline, rows):
            if not all(_scale_exact(e, window * consts[0])
                       for e in consts[3] if e):
                VECTOR_STATS["fallback_energy"] += 1
                continue                # compiled path answers this key
            SIM_CACHE.put(key, row[0], _ledger_from_components(row[1:]))
            VECTOR_STATS["windows_closed_form"] += 1
            VECTOR_STATS["windows_batched"] += 1
            answered += 1
    else:
        chain = [key for key, _, _ in pipeline] + chain

    for key in chain:
        cfg, mode, window, g, p, gather_flits, unicast_flits, e_pes = key
        hit = window_result(cfg, mode, window, g, p, gather_flits,
                            unicast_flits, e_pes)
        if hit is not None:
            SIM_CACHE.put(key, hit[0], hit[1])
            answered += 1
    return answered


# --------------------------------------------------------------------------- #
# K3 — contention-free DAG wavefront kernel
# --------------------------------------------------------------------------- #
class VectorProgram:
    """One PacketOp program lowered to per-wavefront arrays.

    Lowering proves zero resource contention (or the sibling root-fanout
    form), precomputes every op's completion *duration* and the exact
    (order-free) ledger totals; :meth:`run` is then a pure longest-path
    propagation: per dependency level, one batched ``maximum.at`` step.
    """

    __slots__ = ("n", "levels", "t_of", "delay_of", "dur", "ledger_totals",
                 "delivers")

    def __init__(self, n: int, levels: list, t_of, delay_of, dur,
                 ledger_totals: tuple, delivers: list):
        self.n = n
        self.levels = levels            # [(idx, edge_src, edge_dst)]
        self.t_of = t_of
        self.delay_of = delay_of        # 0 where the op has no deps
        self.dur = dur
        self.ledger_totals = ledger_totals
        self.delivers = delivers        # [(op_index, node, offset)]

    def run(self, t0: int = 0) -> tuple[int, EnergyLedger, list, dict]:
        # The wavefront kernel needs in-place scatter-max (numpy ufunc
        # ``.at``); the torch backend only serves the elementwise batched
        # window pass, as the reference's jax backend does.
        n = self.n
        done = _np.zeros(n, dtype=_np.int64)
        issue = _np.zeros(n, dtype=_np.int64)
        ready = self.t_of + t0
        for idx, edge_src, edge_dst in self.levels:
            if edge_src.size:
                _np.maximum.at(ready, edge_dst, done[edge_src])
            lv_issue = ready[idx] + self.delay_of[idx]
            issue[idx] = lv_issue
            done[idx] = lv_issue + self.dur[idx]
            VECTOR_STATS["wavefronts_batched"] += 1
        delivered: dict = {}
        for i, node, off in self.delivers:
            t = int(issue[i]) + off
            if node not in delivered or t < delivered[node]:
                delivered[node] = t
        latency = int(done.max()) if n else 0
        VECTOR_STATS["programs_lowered"] += 1
        return (latency, _ledger_from_components(self.ledger_totals),
                [int(d) for d in done], delivered)


def lower_program(prog: Sequence, cfg: NocConfig) -> VectorProgram:
    """Lower ``prog`` for wavefront replay or raise UnvectorizableProgram.

    Rides ``compile_program`` for route/port encoding and the per-op
    static energy tuples, then statically discharges the two obligations
    the event engines resolve dynamically:

    * **occupancy** — every link and ejection port is used by at most one
      op; an injection port is either exclusive or shared by sibling ops
      with identical (deps, t, delay, flits), whose grants provably
      serialize in program order at ``issue + rank*flits``;
    * **ledger order** — every energy component passes the dyadic gate,
      so the engines' dynamic issue-order accumulation equals the static
      program-order total bit for bit.
    """
    if _np is None and _STATE["backend"] == "numpy":
        VECTOR_STATS["fallback_backend"] += 1
        raise UnvectorizableProgram("numpy unavailable")
    try:
        cp = compile_program(prog, cfg)
    except UncompilableProgram as e:
        VECTOR_STATS["fallback_route"] += 1
        raise UnvectorizableProgram(str(e)) from e
    n = cp.n
    ops = cp.ops
    r_cyc, l_cyc, ni = cp.router_cycles, cp.link_cycles, cp.ni_cycles

    # --- occupancy census -------------------------------------------------- #
    link_user = {}
    ej_user = {}
    inj_groups: dict[int, list[int]] = {}
    for i, op in enumerate(ops):
        (_, _, _, virtual, flits, inject, eject, link_ids,
         inj_pid, ej_pid, _, _, _) = op
        if virtual:
            continue
        for lid in link_ids:
            if lid in link_user:
                VECTOR_STATS["fallback_contention"] += 1
                raise UnvectorizableProgram(f"link {lid} shared")
            link_user[lid] = i
        if eject:
            if ej_pid in ej_user:
                VECTOR_STATS["fallback_contention"] += 1
                raise UnvectorizableProgram(f"eject port {ej_pid} shared")
            ej_user[ej_pid] = i
        if inject:
            inj_groups.setdefault(inj_pid, []).append(i)
    inj_rank = [0] * n
    for pid, members in inj_groups.items():
        if len(members) == 1:
            continue
        # Sibling root-fanout form: same deps/t/delay/flits => equal issue
        # times, grants serialize in program order spaced by flits.
        sig = {(ops[i][0], ops[i][1], ops[i][2], ops[i][4]) for i in members}
        if len(sig) != 1:
            VECTOR_STATS["fallback_contention"] += 1
            raise UnvectorizableProgram(f"inject port {pid} shared "
                                        "by non-sibling ops")
        for rank, i in enumerate(members):
            inj_rank[i] = rank

    # --- exact ledger totals ----------------------------------------------- #
    totals = [0.0] * 7
    for op in ops:
        e = op[12]
        comps = e[:2] if op[3] else e           # virtual: pe + ni only
        for j, v in enumerate(comps):
            if v and not _scale_exact(v, n):
                VECTOR_STATS["fallback_energy"] += 1
                raise UnvectorizableProgram("non-dyadic energy component")
            totals[j] += v

    # --- per-op durations + deliveries ------------------------------------- #
    dur = [0] * n
    delivers: list[tuple[int, object, int]] = []
    for i, op in enumerate(ops):
        (t, delay, deps, virtual, flits, inject, eject, link_ids,
         inj_pid, ej_pid, hop_deliver, completion, _) = op
        if not virtual:
            inj_off = inj_rank[i] * flits + ni if inject else 0
            n_links = len(link_ids)
            d = inj_off + n_links * (r_cyc + l_cyc)
            d += (r_cyc + ni + flits - 1) if eject else (flits - 1)
            dur[i] = d
            if hop_deliver is not None:
                for st, node in enumerate(hop_deliver):
                    if node is not None:
                        delivers.append(
                            (i, node, inj_off + (st + 1) * (r_cyc + l_cyc)
                             + flits - 1))
        for node in completion:
            delivers.append((i, node, dur[i]))

    # --- dependency levels -------------------------------------------------- #
    level = [0] * n
    for i, op in enumerate(ops):
        if op[2]:
            level[i] = 1 + max(level[d] for d in op[2])
    n_levels = (max(level) + 1) if n else 0
    levels = []
    for lv in range(n_levels):
        idx = [i for i in range(n) if level[i] == lv]
        esrc, edst = [], []
        for i in idx:
            for d in ops[i][2]:
                esrc.append(d)
                edst.append(i)
        levels.append((_np.asarray(idx, dtype=_np.int64),
                       _np.asarray(esrc, dtype=_np.int64),
                       _np.asarray(edst, dtype=_np.int64)))
    t_of = _np.asarray([op[0] for op in ops], dtype=_np.int64)
    delay_of = _np.asarray([op[1] if op[2] else 0 for op in ops],
                           dtype=_np.int64)
    return VectorProgram(n, levels, t_of, delay_of,
                         _np.asarray(dur, dtype=_np.int64),
                         tuple(totals), delivers)


def run_vectorized(prog: Sequence, cfg: NocConfig, t0: int = 0
                   ) -> tuple[int, EnergyLedger, list, dict]:
    """Lower + run in one call (raises UnvectorizableProgram on fallback)."""
    return lower_program(prog, cfg).run(t0)
