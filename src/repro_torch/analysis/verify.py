"""Static artifact verification: every check runs without the event loop
(the port's ``repro.analysis.verify``).

The checks (ids are the ``Finding.check`` vocabulary):

``dep-dag``
    Dependency indices are prior-op indices (program order is topological,
    so dangling or forward deps and cycles are impossible when this holds);
    duplicates are flagged.
``route``
    Every non-virtual op's route is a unit-step path inside the mesh (a
    path override must start at ``src`` and end at ``dst``), the VC is
    within ``effective_vcs``, and every ``delivers`` target is reachable
    (the destination or a link head of the route): a target off the route
    would silently never fire in the engine.
``cdg-deadlock``
    The per-VC channel dependency graph (edges between consecutive links
    of each op's route) is acyclic.  XY routes only turn X->Y and cannot
    cycle; tree-embedding path overrides are sub-paths of XY routes and
    inherit that, so a cyclic override (a ring of turning paths on one VC)
    is what this flags.
``collective-fold`` / ``collective-deliver``
    Collective algebra from the ``contribs``/``delivers`` metadata: per
    reduce op the merged dependency contributions are pairwise disjoint and
    kept, every participant's operand enters exactly once per chunk;
    reduce phases deliver only the chunk root, multicast phases deliver
    every destination exactly once; the union of delivered contributions
    matches the op's semantics end to end.
``ledger``
    Static-ledger conservation for a CompiledProgram
    (:func:`verify_compiled`): each op's energy tuple equals the
    path-determined counts recomputed from its route (flits x links, hops,
    NI crossings, adds), against the source PacketOps when available; its
    ``children``/``dep_count`` agree with the dep edges.
``hier-route`` / ``hier-fold``
    The package hierarchy's schedules (:func:`verify_hier_schedule`):
    chip-boundary legality, express channels, and fold exactly once per
    level and across levels.
``plan-schema`` / ``plan-mode`` / ``plan-tile`` / ``plan-gemm``
    ExecutionPlan invariants.  The psum checks are the reference's: a
    decision's mode is one of ``AUTO_CANDIDATES`` and the argmin of its
    recorded costs under the plan's objective.  The tile checks are the
    H100's in place of the reference's (exact divisibility, the VMEM
    budget): each :class:`~repro_torch.plan.TileChoice` must be a launch
    ``csrc/ina_matmul.cu`` can make (:mod:`repro_torch.plan.tiles`).
``kvcache``
    Paged-KV free-list invariants: no block both free and mapped, no
    aliasing across tables, free + live == total, every request's length
    covered by its block table.
``fault-route`` / ``fault-turn`` / ``fault-remap``
    Fault-repaired programs (:func:`verify_faulted`): no route crosses a
    failed link or router; every detour path is legal under a *single*
    turn rule for the whole program (west-first or up*/down*: mixing
    rules voids the per-rule deadlock argument); no dead or
    fabric-stranded PE appears in the contribution algebra, and the
    repaired collective folds/delivers exactly once over the usable
    participant set.

The port's ``route_link_ids`` / ``path_link_ids`` return ``(link_ids,
links)``, each id a flat int or an overflow key; a route is strict (in the
mesh, unit steps) when every id is an int.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, Optional, Sequence

from repro_torch.core.noc.router import NocConfig
from repro_torch.core.noc.simulator import (effective_vcs, path_link_ids,
                                            route_link_ids)

from .findings import Finding, VerificationError

__all__ = [
    "verify_program", "verify_collective", "verify_compiled",
    "verify_schedule", "verify_hier_schedule", "verify_plan",
    "verify_allocator", "verify_kvcache", "verify_faulted",
    "check_program",
]


# --------------------------------------------------------------------------- #
# Packet programs: DAG shape, route legality, CDG deadlock freedom
# --------------------------------------------------------------------------- #
def _op_route(op, width: int, height: int):
    """``(strict_link_ids, links)`` for an op's route; the strict ids are
    None when any hop is not an in-mesh unit step."""
    if op.path is not None:
        ids, links = path_link_ids(width, height, tuple(op.path))
    else:
        ids, links = route_link_ids(width, height, op.src, op.dst)
    strict = ids if all(type(x) is int for x in ids) else None
    return strict, links


def _is_virtual(op) -> bool:
    return op.flits == 0 and not op.inject and not op.eject


def verify_program(prog: Sequence, cfg: Optional[NocConfig] = None
                   ) -> list[Finding]:
    """Statically check one PacketOp program (no simulation)."""
    cfg = NocConfig() if cfg is None else cfg
    width, height = cfg.width, cfg.height
    vcs = effective_vcs(cfg)
    out: list[Finding] = []
    chains: list[tuple[int, tuple]] = []      # (vc, link ids) per routed op
    for i, op in enumerate(prog):
        where = f"op {i}" + (f" [{op.tag}]" if op.tag else "")
        seen_deps = set()
        for d in op.deps:
            if not (isinstance(d, int) and 0 <= d < i):
                out.append(Finding(
                    "dep-dag", where,
                    f"dep {d!r} is not a prior op index (program order "
                    f"must be topological)"))
            elif d in seen_deps:
                out.append(Finding("dep-dag", where, f"duplicate dep {d}"))
            seen_deps.add(d)
        if op.flits < 0:
            out.append(Finding("route", where,
                               f"negative flit count {op.flits}"))
        if _is_virtual(op):
            continue                           # no network resources touched
        if not 0 <= op.vc < vcs:
            out.append(Finding(
                "route", where,
                f"vc {op.vc} outside the config's 0..{vcs - 1}"))
        if op.path is not None:
            p = tuple(op.path)
            if not p or p[0] != tuple(op.src) or p[-1] != tuple(op.dst):
                out.append(Finding(
                    "route", where,
                    f"path override runs {p[0] if p else None}->"
                    f"{p[-1] if p else None}, op says {op.src}->{op.dst}"))
                continue
        strict, links = _op_route(op, width, height)
        if strict is None:
            out.append(Finding(
                "route", where,
                f"route {op.src}->{op.dst} takes a non-unit step or "
                f"leaves the {width}x{height} mesh"))
            continue
        reachable = {op.dst} | {b for _, b in links}
        if op.flits == 0:                      # completion delivers everything
            reachable |= set(op.delivers)
        for node in op.delivers:
            if node not in reachable:
                out.append(Finding(
                    "route", where,
                    f"delivers to {node}, which is neither the destination "
                    f"nor on the route {op.src}->{op.dst} (the engine "
                    f"would silently never deliver it)"))
        chains.append((op.vc, strict))
    out.extend(_cdg_findings(chains))
    return out


def _cdg_findings(chains: list) -> list[Finding]:
    """Channel-dependency-graph deadlock check: one channel per (vc, link);
    each op's route adds edges between its consecutive links; any cycle is
    a potential wormhole deadlock (the Dally/Seitz condition)."""
    adj: dict = {}
    for vc, link_ids in chains:
        for a, b in zip(link_ids, link_ids[1:]):
            adj.setdefault((vc, a), set()).add((vc, b))
    adj = {k: sorted(v) for k, v in sorted(adj.items())}
    color: dict = {}                 # 1 = on stack, 2 = finished
    out: list[Finding] = []
    seen_msgs = set()
    for start in adj:
        if color.get(start):
            continue
        stack = [(start, iter(adj[start]))]
        path = [start]
        color[start] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                c = color.get(nxt, 0)
                if c == 1:           # back edge: reconstruct the cycle
                    cyc = path[path.index(nxt):]
                    msg = (f"channel dependency cycle on vc {nxt[0]}: links "
                           + " -> ".join(str(l) for _, l in cyc + [nxt]))
                    if msg not in seen_msgs:
                        seen_msgs.add(msg)
                        out.append(Finding("cdg-deadlock",
                                           f"vc {nxt[0]}", msg))
                elif c == 0 and nxt in adj:
                    color[nxt] = 1
                    stack.append((nxt, iter(adj[nxt])))
                    path.append(nxt)
                    advanced = True
                    break
                elif c == 0:
                    color[nxt] = 2   # sink channel, no out-edges
            if not advanced:
                color[node] = 2
                stack.pop()
                path.pop()
    return out


# --------------------------------------------------------------------------- #
# Collective algebra from contribs/delivers metadata
# --------------------------------------------------------------------------- #
def _phase_of_tag(tag: str) -> Optional[str]:
    t = tag
    for suffix in (":self", ":eject", ":root"):
        if t.endswith(suffix):
            t = t[: -len(suffix)]
    if t in ("reduce", "ar:reduce", "gather") or t.startswith("rs["):
        return "reduce"
    if t in ("bcast", "ar:bcast") or t.startswith("ag["):
        return "multicast"
    return None


def verify_collective(prog: Sequence, *, op: str,
                      participants: Iterable, root=None,
                      algorithm: str = "reduce_bcast",
                      semantics: str = "ina") -> list[Finding]:
    """Check a ``plan_collective`` program's algebra without running it:
    fold exactly once per reduce chunk, deliver exactly once per multicast
    destination, and end-to-end delivered-contribution completeness."""
    from repro_torch.core.noc.collective.schedule import delivered_contribs
    parts = sorted(set(tuple(p) for p in participants))
    pset = frozenset(parts)
    root = parts[0] if root is None else tuple(root)
    rs_ag = op == "allreduce" and algorithm == "rs_ag"
    chunks = tuple(range(len(parts))) if rs_ag else (0,)
    chunk_root = {c: (parts[c] if rs_ag else root) for c in chunks}
    out: list[Finding] = []

    groups: dict[tuple[str, int], list[int]] = {}
    for i, o in enumerate(prog):
        phase = _phase_of_tag(o.tag)
        if phase is None:
            out.append(Finding("collective-fold", f"op {i}",
                               f"unrecognised collective tag {o.tag!r}"))
            continue
        groups.setdefault((phase, o.chunk), []).append(i)

    # -- reduce phases: every participant's operand folded exactly once -- #
    if op != "broadcast":
        for c in chunks:
            where = f"chunk {c}"
            idxs = groups.get(("reduce", c), [])
            if not idxs:
                out.append(Finding("collective-fold", where,
                                   "no reduce-phase ops for this chunk"))
                continue
            in_group = set(idxs)
            first = Counter()
            for i in idxs:
                o = prog[i]
                dep_sets = [prog[d].contribs for d in o.deps
                            if d in in_group]
                union = frozenset().union(*dep_sets) if dep_sets \
                    else frozenset()
                if sum(len(s) for s in dep_sets) != len(union):
                    out.append(Finding(
                        "collective-fold", f"op {i}",
                        "merged dependency contributions overlap: an "
                        "operand would be folded twice"))
                if not union <= o.contribs:
                    lost = sorted(union - o.contribs)
                    out.append(Finding(
                        "collective-fold", f"op {i}",
                        f"contributions {lost} arriving via deps are "
                        f"dropped by the merge"))
                for p in sorted(o.contribs - union):
                    first[p] += 1
            for p in parts:
                k = first.get(p, 0)
                if k != 1:
                    out.append(Finding(
                        "collective-fold", where,
                        f"participant {p} operand folded {k} times "
                        f"(expected exactly once)"))
            for p in sorted(set(first) - pset):
                out.append(Finding("collective-fold", where,
                                   f"non-participant {p} contributes"))
            deliv = Counter()
            for i in idxs:
                for node in prog[i].delivers:
                    deliv[node] += 1
            r = chunk_root[c]
            for node in sorted(set(deliv) - {r}):
                out.append(Finding(
                    "collective-deliver", where,
                    f"reduce phase delivers to {node}; only the chunk "
                    f"root {r} may receive it"))
            got = deliv.get(r, 0)
            # The gather-unicast lowering delivers the root one packet per
            # participant by design; everything else is exactly-once.
            if (got != 1 if op != "gather" else got < 1):
                out.append(Finding(
                    "collective-deliver", where,
                    f"root {r} receives the reduced value {got} times"))

    # -- multicast phases: every destination delivered exactly once ------ #
    if op in ("broadcast", "allreduce"):
        expected = frozenset({root}) if op == "broadcast" else pset
        for c in chunks:
            where = f"chunk {c}"
            idxs = groups.get(("multicast", c), [])
            if not idxs:
                out.append(Finding("collective-deliver", where,
                                   "no multicast-phase ops for this chunk"))
                continue
            deliv = Counter()
            for i in idxs:
                o = prog[i]
                if o.contribs != expected:
                    out.append(Finding(
                        "collective-fold", f"op {i}",
                        f"multicast payload carries contributions "
                        f"{sorted(o.contribs)}, expected "
                        f"{sorted(expected)}"))
                for node in o.delivers:
                    deliv[node] += 1
            receivers = (pset - {chunk_root[c]}) or {chunk_root[c]}
            for node in sorted(receivers):
                k = deliv.get(node, 0)
                if k != 1:
                    out.append(Finding(
                        "collective-deliver", where,
                        f"destination {node} delivered {k} times "
                        f"(expected exactly once)"))
            for node in sorted(set(deliv) - set(receivers)):
                out.append(Finding(
                    "collective-deliver", where,
                    f"unexpected multicast delivery to {node}"))

    # -- end-to-end completeness ---------------------------------------- #
    got = delivered_contribs(prog)

    def want(node, chunk, contribs, role):
        have = got.get(node, {}).get(chunk, frozenset())
        if have != contribs:
            out.append(Finding(
                "collective-deliver", f"chunk {chunk}",
                f"{role} {node} ends with contributions "
                f"{sorted(have)}, expected {sorted(contribs)}"))

    if op in ("reduce", "gather"):
        want(root, 0, pset, "root")
    elif op == "broadcast":
        for p in parts:
            if p != root or len(parts) == 1:
                want(p, 0, frozenset({root}), "destination")
    else:                                       # allreduce
        for c in chunks:
            for p in parts:
                want(p, c, pset, "participant")
    return out


# --------------------------------------------------------------------------- #
# Compiled programs: static-ledger conservation
# --------------------------------------------------------------------------- #
def verify_compiled(cp, prog: Optional[Sequence] = None,
                    cfg: Optional[NocConfig] = None) -> list[Finding]:
    """Check a CompiledProgram's flat encoding against itself and, when
    the source PacketOps are given, against a fresh route derivation."""
    out: list[Finding] = []
    n = cp.n
    if not (len(cp.ops) == len(cp.children) == len(cp.dep_count) == n):
        out.append(Finding(
            "ledger", "compiled",
            f"array lengths disagree: n={n}, ops={len(cp.ops)}, "
            f"children={len(cp.children)}, dep_count={len(cp.dep_count)}"))
        return out
    derived_children: list[list[int]] = [[] for _ in range(n)]
    for i, top in enumerate(cp.ops):
        deps = top[2]
        if cp.dep_count[i] != len(deps):
            out.append(Finding("dep-dag", f"op {i}",
                               f"dep_count {cp.dep_count[i]} != "
                               f"{len(deps)} encoded deps"))
        for d in deps:
            if not (isinstance(d, int) and 0 <= d < i):
                out.append(Finding("dep-dag", f"op {i}",
                                   f"dep {d!r} is not a prior op index"))
            else:
                derived_children[d].append(i)
    for i in range(n):
        if tuple(derived_children[i]) != tuple(cp.children[i]):
            out.append(Finding(
                "dep-dag", f"op {i}",
                f"children {tuple(cp.children[i])} != "
                f"{tuple(derived_children[i])} derived from dep edges"))
    for i, top in enumerate(cp.ops):
        flits, inject, eject = top[4], top[5], top[6]
        n_links = len(top[7])
        e = tuple(top[12])
        # energy = (pe_adds, ni_flits, flit_routers, flit_links,
        #           packet_hops, router_adds, packets_built)
        shape = (e[0], e[1], flits * (n_links + 1), flits * n_links,
                 n_links, e[5], int(inject) + int(eject))
        if e != shape:
            out.append(Finding(
                "ledger", f"op {i}",
                f"energy tuple {e} inconsistent with its own route "
                f"({n_links} links, {flits} flits): expected {shape}"))
        if e[1] < flits * (int(inject) + int(eject)) - 1e-9:
            out.append(Finding(
                "ledger", f"op {i}",
                f"NI flits {e[1]} below the inject/eject floor "
                f"{flits * (int(inject) + int(eject))}"))
    if prog is None:
        return out
    if len(prog) != n:
        out.append(Finding("ledger", "compiled",
                           f"{n} compiled ops for {len(prog)} source ops"))
        return out
    cfg = NocConfig() if cfg is None else cfg
    for i, (op, top) in enumerate(zip(prog, cp.ops)):
        where = f"op {i}" + (f" [{op.tag}]" if op.tag else "")
        if tuple(top[2]) != tuple(op.deps):
            out.append(Finding("dep-dag", where,
                               f"compiled deps {top[2]} != source "
                               f"{tuple(op.deps)}"))
        virtual = _is_virtual(op)
        if top[3] != virtual:
            out.append(Finding("ledger", where,
                               f"virtual flag {top[3]} != {virtual}"))
        want_links: tuple = ()
        if not virtual:
            strict, _ = _op_route(op, cfg.width, cfg.height)
            if strict is None:
                out.append(Finding(
                    "route", where,
                    f"source route {op.src}->{op.dst} is not encodable in "
                    f"the {cfg.width}x{cfg.height} mesh, yet it compiled"))
                continue
            want_links = strict
        if tuple(top[7]) != tuple(want_links):
            out.append(Finding(
                "ledger", where,
                f"compiled link ids {top[7]} != {tuple(want_links)} "
                f"re-derived from the route"))
        nl = len(want_links)
        want_e = (op.pe_adds,
                  op.extra_ni_flits
                  + op.flits * (int(op.inject) + int(op.eject)),
                  op.flits * (nl + 1) if not virtual else 0,
                  op.flits * nl,
                  nl,
                  op.reduce_words,
                  int(op.inject) + int(op.eject))
        if tuple(top[12]) != want_e:
            out.append(Finding(
                "ledger", where,
                f"energy tuple {tuple(top[12])} != {want_e} recomputed "
                f"from the source op's path-determined counts"))
    return out


# --------------------------------------------------------------------------- #
# Mapper schedules
# --------------------------------------------------------------------------- #
def verify_schedule(sched, layers: Sequence,
                    base_cfg: Optional[NocConfig] = None) -> list[Finding]:
    """Re-emit every layer's packet program from a NetworkSchedule and
    verify each one (routes, DAG, CDG) under its own NocConfig."""
    base_cfg = NocConfig() if base_cfg is None else base_cfg
    by_name = {l.name: l for l in layers}
    out: list[Finding] = []
    missing = [a.layer for a in sched.assignments if a.layer not in by_name]
    for name in missing:
        out.append(Finding("plan-gemm", f"schedule:{name}",
                           "assignment references a layer not in the "
                           "workload"))
    if missing:
        return out
    for layer_name, cfg, prog in sched.programs(layers, base_cfg):
        for f in verify_program(prog, cfg):
            out.append(Finding(f.check, f"{layer_name}: {f.where}",
                               f.message))
    return out


# --------------------------------------------------------------------------- #
# Hierarchical schedules (mesh of meshes, ``core/noc/hierarchy``)
# --------------------------------------------------------------------------- #
#: Level name -> the collective op its chip lanes run.
_HIER_LEVEL_OPS = {"intra-reduce": "reduce", "intra-bcast": "broadcast"}


def _hier_lane_meta(prog: Sequence, op: str):
    """``(participants, root)`` of a lane program, from its metadata.

    Participants come from the contribution algebra the planners stamp on
    every op; the root is whoever the reduce phase delivers (broadcast
    lanes: whoever the payload's single contribution names)."""
    contrib_union: frozenset = frozenset()
    deliver_union: frozenset = frozenset()
    reduce_delivers: list = []
    for o in prog:
        contrib_union |= frozenset(o.contribs)
        deliver_union |= frozenset(o.delivers)
        if _phase_of_tag(o.tag) == "reduce":
            reduce_delivers.extend(o.delivers)
    if op == "broadcast":
        parts = sorted(deliver_union | contrib_union)
        root = sorted(contrib_union)[0] if contrib_union else \
            (parts[0] if parts else None)
    else:
        parts = sorted(contrib_union)
        root = reduce_delivers[0] if reduce_delivers else \
            (parts[0] if parts else None)
    return parts, root


def _verify_express_lane(lane, hmesh) -> tuple[list[Finding], list]:
    """Route legality of an express package lane, and its CDG chains.

    Express channels are dedicated 2-node chip-root links: every routed op
    must carry a ``[src, dst]`` path override between valid chip-grid
    coordinates (that is what the heap engine resolves to per-channel
    overflow resources; anything else would alias on-die links)."""
    out: list[Finding] = []
    chains: list = []
    cx, cy = hmesh.chips_x, hmesh.chips_y
    width, height = lane.cfg.width, lane.cfg.height
    for i, o in enumerate(lane.prog):
        where = f"op {i}" + (f" [{o.tag}]" if o.tag else "")
        for d in o.deps:
            if not (isinstance(d, int) and 0 <= d < i):
                out.append(Finding(
                    "dep-dag", where,
                    f"dep {d!r} is not a prior op index"))
        if _is_virtual(o):
            continue
        for node in (tuple(o.src), tuple(o.dst)):
            if not (0 <= node[0] < cx and 0 <= node[1] < cy):
                out.append(Finding(
                    "hier-route", where,
                    f"{node} is not a chip coordinate of the "
                    f"{cx}x{cy} package grid"))
        if tuple(o.src) == tuple(o.dst):
            continue                     # root-local fold/eject, no channel
        p = tuple(tuple(n) for n in o.path) if o.path is not None else None
        if p is None or len(p) != 2 or p[0] != tuple(o.src) \
                or p[-1] != tuple(o.dst):
            out.append(Finding(
                "hier-route", where,
                f"express package op {o.src}->{o.dst} must ride a "
                f"dedicated 2-node channel (path override [src, dst]), "
                f"got {p}"))
            continue
        ids, _ = path_link_ids(width, height, p)
        chains.append((("package", None, o.vc), ids))
    return out, chains


def verify_hier_schedule(sched) -> list[Finding]:
    """Hierarchy invariants of a ``HierarchicalSchedule``.

    ``hier-route``
        Chip-boundary legality: intra-chip lanes route strictly inside
        their chip's W x H mesh, mesh-package lanes inside the CX x CY
        chip grid, and express package lanes only over dedicated 2-node
        chip-root channels with valid chip-grid endpoints.
    ``hier-fold``
        Fold exactly once per level: each chip lane folds its own
        participants exactly once into the chip root, the package level
        folds exactly the set of chips that produced partials (and
        broadcast levels deliver exactly the chips that continue
        intra-chip): a dropped or duplicated chip lane is an algebra
        error, not a performance detail.
    ``cdg-deadlock``
        Deadlock freedom over the two-level channel graph: channels are
        namespaced per (scope, chip), so concurrent chip lanes cannot
        alias each other's links and package channels never alias on-die
        wires.
    """
    out: list[Finding] = []
    hmesh = sched.hmesh
    chains: list = []
    lane_meta: dict = {}                 # (level, label) -> (parts, root, chip)
    for level, lane in sched.all_lanes():
        where = f"{level.name}/{lane.label}"
        express_pkg = lane.scope == "package" and hmesh.package == "express"
        if express_pkg:
            fs, lane_chains = _verify_express_lane(lane, hmesh)
            chains.extend(lane_chains)
        else:
            # A lane is an ordinary flat program under its own config;
            # out-of-mesh coords are chip-boundary violations here.  Its
            # CDG findings are dropped: the namespaced two-level pass below
            # covers them without reporting twice.
            fs = [Finding("hier-route" if f.check == "route" else f.check,
                          f.where, f.message)
                  for f in verify_program(lane.prog, lane.cfg)
                  if f.check != "cdg-deadlock"]
            ns = (lane.scope, lane.chip)
            for o in lane.prog:
                if _is_virtual(o):
                    continue
                strict, _ = _op_route(o, lane.cfg.width, lane.cfg.height)
                if strict is not None:
                    chains.append(((*ns, o.vc), strict))
        out.extend(Finding(f.check, f"{where}: {f.where}", f.message)
                   for f in fs)

        # per-lane fold/deliver algebra
        lane_op = sched.op if level.name in ("flat", "package") \
            else _HIER_LEVEL_OPS.get(level.name)
        if lane_op not in ("reduce", "broadcast", "allreduce", "gather"):
            continue
        parts, root = _hier_lane_meta(lane.prog, lane_op)
        lane_meta[(level.name, lane.label)] = (parts, root, lane.chip)
        if not parts:
            out.append(Finding("hier-fold", where,
                               "lane carries no contribution metadata"))
            continue
        algorithm = sched.algorithm
        if express_pkg:
            algorithm = "reduce_bcast"   # the star degenerates rs_ag
        fs = verify_collective(lane.prog, op=lane_op, participants=parts,
                               root=root, algorithm=algorithm,
                               semantics=sched.semantics)
        out.extend(Finding("hier-fold", f"{where}: {f.where}", f.message)
                   for f in fs)

    # cross-level consistency: the package level must fold/deliver exactly
    # the chips whose lanes produced partials / continue the broadcast.
    if len(sched.levels) > 1:
        pkg = next((m for (lv, _), m in lane_meta.items()
                    if lv == "package"), None)
        if pkg is not None:
            pkg_chips = sorted(tuple(p) for p in pkg[0])
            for lv_name in ("intra-reduce", "intra-bcast"):
                lanes = [(label, m) for (lv, label), m in lane_meta.items()
                         if lv == lv_name]
                if not lanes:
                    continue
                intra = sorted(hmesh.chip_coord(m[2]) for _, m in lanes)
                if intra != pkg_chips:
                    out.append(Finding(
                        "hier-fold", f"{lv_name}<->package",
                        f"intra level covers chips {intra} but the "
                        f"package level names {pkg_chips}: a chip's "
                        f"partial would be dropped or double-counted"))
                for label, (parts, root, chip) in lanes:
                    if root != hmesh.chip_root_xy:
                        out.append(Finding(
                            "hier-fold", f"{lv_name}/{label}",
                            f"chip lane root {root} is not the chip root "
                            f"{hmesh.chip_root_xy} fronting the package "
                            f"link"))
    out.extend(_cdg_findings(chains))
    return out


# --------------------------------------------------------------------------- #
# Execution plans
# --------------------------------------------------------------------------- #
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


# --------------------------------------------------------------------------- #
# Fault-repaired programs (core/noc/faults.py)
# --------------------------------------------------------------------------- #
def verify_faulted(prog: Sequence, faults, cfg: Optional[NocConfig] = None,
                   *, op: Optional[str] = None,
                   participants: Optional[Iterable] = None,
                   root=None, algorithm: str = "reduce_bcast",
                   semantics: str = "ina") -> list[Finding]:
    """Check a fault-repaired program against its FaultModel.

    Runs the structural pass (:func:`verify_program`, including the CDG
    deadlock check over the actual detour paths) and adds the fault
    classes: ``fault-route`` (no failed link/router on any route — an op
    without a path override is checked on the XY route the engines would
    derive), ``fault-turn`` (one turn rule covers every path), and, when
    collective metadata is supplied, ``fault-remap`` (the algebra closes
    over the usable participant set: dead or stranded PEs appear nowhere)
    plus the full fold/deliver-exactly-once pass over that set.
    """
    from repro_torch.core.noc.faults import (path_is_updown,
                                             path_is_west_first,
                                             remap_participants, remap_root)
    from repro_torch.core.noc.topology import xy_route_tuple
    cfg = NocConfig() if cfg is None else cfg
    width, height = cfg.width, cfg.height
    out = verify_program(prog, cfg)
    if faults.transient:
        out.append(Finding(
            "fault-route", "model",
            "FaultModel still carries transient faults — resolve a window "
            "with at_window() before planning/verifying"))
    routed: list[tuple[str, tuple]] = []
    for i, o in enumerate(prog):
        if _is_virtual(o):
            continue
        where = f"op {i}" + (f" [{o.tag}]" if o.tag else "")
        if o.path is not None:
            path = tuple(tuple(n) for n in o.path)
        else:
            path = xy_route_tuple(tuple(o.src), tuple(o.dst))
        for node in path:
            if not faults.router_ok(node):
                out.append(Finding("fault-route", where,
                                   f"route visits failed router {node}"))
        for a, b in zip(path, path[1:]):
            if not faults.link_ok(a, b):
                out.append(Finding("fault-route", where,
                                   f"route crosses failed link {a}<->{b}"))
        if len(path) > 2:            # 1-hop paths are legal under any rule
            routed.append((where, path))
    wf = {w for w, p in routed if path_is_west_first(p)}
    ud = {w for w, p in routed
          if path_is_updown(p, faults, width, height)}
    every = {w for w, _ in routed}
    if not (wf >= every or ud >= every):
        for where, _ in routed:
            if where not in wf and where not in ud:
                out.append(Finding(
                    "fault-turn", where,
                    "detour path is legal under neither the west-first "
                    "nor the up*/down* turn rule"))
        if every - wf and every - ud and not (every - wf - ud):
            out.append(Finding(
                "fault-turn", "program",
                "paths mix west-first-only and updown-only detours — no "
                "single turn rule covers the program, so the per-rule "
                "deadlock argument does not apply"))
    if op is None or participants is None:
        return out
    healthy, _ = remap_participants(participants, faults, width, height)
    usable = frozenset(healthy)
    for i, o in enumerate(prog):
        where = f"op {i}" + (f" [{o.tag}]" if o.tag else "")
        for p in sorted(frozenset(o.contribs) - usable):
            out.append(Finding(
                "fault-remap", where,
                f"dead/stranded PE {p} still contributes — its operand "
                f"was not remapped to a healthy neighbor"))
        for p in sorted(frozenset(o.delivers) - usable):
            out.append(Finding(
                "fault-remap", where,
                f"delivery targets dead/stranded PE {p}"))
    parts0 = sorted(set(tuple(p) for p in participants))
    r = remap_root(parts0[0] if root is None else tuple(root),
                   healthy, faults)
    out.extend(verify_collective(prog, op=op, participants=healthy,
                                 root=r, algorithm=algorithm,
                                 semantics=semantics))
    return out


# --------------------------------------------------------------------------- #
# Paged-KV free list
# --------------------------------------------------------------------------- #
def verify_allocator(alloc) -> list[Finding]:
    """BlockAllocator free-list invariants (static, host only)."""
    out: list[Finding] = []
    nb = alloc.num_blocks
    free = list(alloc._free)
    for b in free:
        if not (isinstance(b, int) and 0 <= b < nb):
            out.append(Finding("kvcache", "free-list",
                               f"free block id {b!r} out of range 0..{nb - 1}"))
    for b, k in sorted(Counter(free).items()):
        if k > 1:
            out.append(Finding("kvcache", "free-list",
                               f"block {b} appears {k} times in the free "
                               f"list"))
    owner: dict[int, object] = {}
    n_live = 0
    for rid in sorted(alloc.tables, key=repr):
        for b in alloc.tables[rid]:
            n_live += 1
            if not (isinstance(b, int) and 0 <= b < nb):
                out.append(Finding("kvcache", f"table {rid!r}",
                                   f"block id {b!r} out of range"))
                continue
            if b in owner:
                out.append(Finding(
                    "kvcache", f"table {rid!r}",
                    f"block {b} aliased (also owned by {owner[b]!r})"))
            owner[b] = rid
    for b in sorted(set(free) & set(owner)):
        out.append(Finding("kvcache", "free-list",
                           f"block {b} is both free and mapped to "
                           f"{owner[b]!r}"))
    if n_live + len(free) != nb:
        out.append(Finding(
            "kvcache", "free-list",
            f"leak: {n_live} live + {len(free)} free != {nb} total"))
    return out


def verify_kvcache(kv) -> list[Finding]:
    """PagedKVCache bookkeeping on top of the allocator invariants: the
    length and state keys match the block tables, and every length is
    covered by its blocks."""
    out = verify_allocator(kv.allocator)
    tables = set(kv.allocator.tables)
    for name, keys in (("length", set(kv._length)),
                       ("state", set(kv._state))):
        if keys != tables:
            out.append(Finding(
                "kvcache", name,
                f"{name} keys disagree with block tables (difference: "
                f"{sorted(keys ^ tables, key=repr)})"))
    for rid in sorted(kv._length, key=repr):
        length = kv._length[rid]
        if length < 0 or length > kv.max_seq:
            out.append(Finding("kvcache", f"request {rid!r}",
                               f"length {length} outside 0..{kv.max_seq}"))
            continue
        table = kv.allocator.tables.get(rid, ())
        need = kv.blocks_for(length)
        if need > len(table):
            out.append(Finding(
                "kvcache", f"request {rid!r}",
                f"length {length} needs {need} blocks but the table "
                f"holds {len(table)}"))
    return out


# --------------------------------------------------------------------------- #
# Hook entry
# --------------------------------------------------------------------------- #
def check_program(prog: Sequence, cfg: Optional[NocConfig] = None,
                  **collective_kw) -> None:
    """Raise :class:`VerificationError` if ``prog`` has any finding.

    Used by the opt-in hook (``engine.run_program(verify=True)``); pass
    collective metadata (``op=``, ``participants=``, ...) to also run the
    algebraic checks."""
    findings = verify_program(prog, cfg)
    if collective_kw:
        findings += verify_collective(prog, **collective_kw)
    if findings:
        raise VerificationError(findings)
