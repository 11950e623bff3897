"""Lower collectives into time-stamped packet programs for the NoC engine.

A *program* is a list of :class:`PacketOp` with explicit dependencies; the
:mod:`engine` replays it on the discrete-event simulator.  Every collective
is planned under one of two router semantics (the paper's Fig. 4 dichotomy,
generalised from the WS gather chain to arbitrary trees):

* ``"ina"`` — collective-capable routers: operands are folded into passing
  packets by the router ALU (per-hop reduce), packets are absorbed/forked at
  tree merge nodes without leaving the network.  One packet per tree
  *segment* (maximal non-branching path).
* ``"eject_inject"`` — plain routers: every combine/fork bounces through a
  PE (eject -> local add -> inject).  The tree degenerates to its
  participant-level contraction; every logical edge is a full packet.

Supported ops: ``reduce``, ``broadcast`` (multicast), ``gather``, and
``allreduce`` in two algorithms — ``reduce_bcast`` (reduce to a root, then
multicast) and ``rs_ag`` (reduce-scatter: one chunk-tree per participant,
then an all-gather multicast per chunk).

Ops carry ``contribs``/``delivers`` metadata (which participants' operands a
packet aggregates, who receives payload) so tests can verify algebraic
correctness of a schedule without running it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from ..router import NocConfig
from .trees import CollectiveTree, multicast_tree, reduction_tree, segments

Coord = tuple[int, int]

SEMANTICS = ("ina", "eject_inject")
ALLREDUCE_ALGORITHMS = ("reduce_bcast", "rs_ag")
COLLECTIVE_OPS = ("reduce", "broadcast", "gather", "allreduce")


@dataclass
class PacketOp:
    """One packet of a collective program.

    ``deps`` are indices of program ops that must complete before this op
    is issued (issue time = ``max(t, max(dep done) + delay)``).  ``src ==
    dst`` with ``inject=False`` models an in-router delivery (ejection of an
    already-accumulated value).  ``contribs``/``delivers`` are metadata for
    verification only and do not affect timing or energy.
    """

    src: Coord
    dst: Coord
    flits: int
    vc: int = 0
    inject: bool = True
    eject: bool = True
    reduce_words: int = 0          # in-network adds along this packet's path
    pe_adds: int = 0               # endpoint adds charged when this op issues
    extra_ni_flits: float = 0.0    # NI crossings beyond inject/eject (operand
                                   # deposits, multicast local copies)
    t: int = 0                     # earliest issue time
    deps: tuple[int, ...] = ()
    delay: int = 0                 # cycles after the last dep completes
    path: Optional[list[Coord]] = None   # route override (tree embedding)
    tag: str = ""
    chunk: int = 0
    contribs: frozenset = frozenset()
    delivers: tuple[Coord, ...] = ()


def _payload_flits(cfg: NocConfig, payload_bits: float) -> int:
    """Header + payload flits for one collective packet."""
    return 1 + cfg.payload_flits(payload_bits)


def _words(payload_bits: float, word_bits: int = 32) -> int:
    return max(1, math.ceil(payload_bits / word_bits))


# --------------------------------------------------------------------------- #
# Reduce
# --------------------------------------------------------------------------- #
def _plan_reduce_ina(prog: list[PacketOp], tree: CollectiveTree,
                     payload_bits: float, cfg: NocConfig, *, vc: int,
                     chunk: int, tag: str) -> int:
    """In-network reduce over the tree; returns the index of the final op
    (the one that ejects the fully-reduced value at the root)."""
    flits = _payload_flits(cfg, payload_bits)
    words = _words(payload_bits)
    parts = tree.participants
    segs = segments(tree)
    if not segs:                       # single-participant degenerate tree
        prog.append(PacketOp(tree.root, tree.root, 0, vc=vc,
                             inject=False, eject=False, tag=tag + ":self",
                             chunk=chunk, contribs=frozenset(parts),
                             delivers=(tree.root,)))
        return len(prog) - 1
    by_head = {s[0]: s for s in segs}
    ending_at: dict[Coord, list[Coord]] = {}
    for s in segs:
        ending_at.setdefault(s[-1], []).append(s[0])
    op_of_head: dict[Coord, int] = {}
    acc_of_head: dict[Coord, frozenset] = {}

    def emit(seg: list[Coord]) -> int:
        head, end = seg[0], seg[-1]
        if head in op_of_head:
            return op_of_head[head]
        is_leaf = head not in ending_at
        dep_idx = tuple(emit(by_head[h]) for h in ending_at.get(head, []))
        merged = frozenset().union(*(acc_of_head[h]
                                     for h in ending_at.get(head, []))) \
            if dep_idx else frozenset()
        # Adds charged to this packet: merging k absorbed child packets
        # costs k-1 adds (the first initialises the router accumulator),
        # the head's own operand costs one more, and every participant
        # router passed en route folds its operand in (the INA add).
        # Only *operand deposits* (not packet merges) cross the local NI.
        adds = deposits = 0
        acc = merged
        if is_leaf:
            acc = acc | {head}         # leaf operand seeds the packet
        else:
            adds += len(dep_idx) - 1
            if head in parts:
                adds += 1
                deposits += 1
                acc = acc | {head}
        interior = [v for v in seg[1:-1] if v in parts]
        adds += len(interior)
        deposits += len(interior)
        acc = acc | frozenset(interior)
        last = end == tree.root and len(ending_at.get(end, [])) == 1
        if last and end in parts:      # sole root arrival: root adds in-router
            adds += 1
            deposits += 1
            acc = acc | {end}
        idx = len(prog)
        prog.append(PacketOp(
            head, end, flits, vc=vc, inject=is_leaf, eject=last,
            reduce_words=adds * words,
            extra_ni_flits=deposits * payload_bits / cfg.flit_bits,
            deps=dep_idx, path=list(seg), tag=tag, chunk=chunk,
            contribs=acc, delivers=(end,) if last else ()))
        op_of_head[head] = idx
        acc_of_head[head] = acc
        return idx

    for s in segs:
        emit(s)
    root_heads = ending_at.get(tree.root, [])
    if len(root_heads) == 1:
        return op_of_head[root_heads[0]]
    # Several segments merge at the root: absorb them all, then eject the
    # accumulated value from the root router into the root PE.
    deps = tuple(op_of_head[h] for h in root_heads)
    root_contributes = tree.root in parts
    adds = len(deps) - 1 + (1 if root_contributes else 0)
    acc = frozenset().union(*(acc_of_head[h] for h in root_heads))
    if root_contributes:
        acc = acc | {tree.root}
    prog.append(PacketOp(
        tree.root, tree.root, flits, vc=vc, inject=False, eject=True,
        reduce_words=adds * words,
        extra_ni_flits=(payload_bits / cfg.flit_bits
                        if root_contributes else 0.0),
        deps=deps, tag=tag + ":eject", chunk=chunk, contribs=acc,
        delivers=(tree.root,)))
    return len(prog) - 1


def _logical_children(tree: CollectiveTree) -> dict[Coord, list[Coord]]:
    """Participant-level contraction: child participant -> nearest
    participant (or root) ancestor."""
    out: dict[Coord, list[Coord]] = {}
    for p in sorted(tree.participants | {tree.root}):
        if p == tree.root:
            continue
        v = tree.parent[p]
        while v != tree.root and v not in tree.participants:
            v = tree.parent[v]
        out.setdefault(v, []).append(p)
    return out


def _plan_reduce_eject_inject(prog: list[PacketOp], tree: CollectiveTree,
                              payload_bits: float, cfg: NocConfig, *,
                              vc: int, chunk: int, tag: str,
                              path_of=None) -> int:
    """Fig. 4(a) generalised: every logical tree edge is a full packet that
    is ejected, added at the PE, and re-injected toward the next hop.

    ``path_of(src, dst)`` (optional) supplies an explicit route override
    per logical edge — the fault-repaired planner routes every packet
    along the repaired tree instead of the default XY derivation.
    """
    flits = _payload_flits(cfg, payload_bits)
    words = _words(payload_bits)
    children = _logical_children(tree)
    parent_of = {c: par for par, kids in children.items() for c in kids}
    op_to_parent: dict[Coord, int] = {}
    acc: dict[Coord, frozenset] = {}

    def emit(v: Coord) -> Optional[int]:
        if v in op_to_parent:
            return op_to_parent[v]
        kids = children.get(v, [])
        dep_idx = tuple(i for i in (emit(c) for c in kids) if i is not None)
        a = frozenset({v} if v in tree.participants else set())
        a = a.union(*(acc[c] for c in kids)) if kids else a
        acc[v] = a
        if v == tree.root:
            return None
        # Arriving child packets are added into this PE's accumulator; the
        # last add gates the departure of the outgoing packet.
        idx = len(prog)
        prog.append(PacketOp(
            v, parent_of[v], flits, vc=vc,
            pe_adds=len(dep_idx) * words,
            deps=dep_idx, delay=cfg.pe_add_cycles if dep_idx else 0,
            path=path_of(v, parent_of[v]) if path_of else None,
            tag=tag, chunk=chunk, contribs=a))
        op_to_parent[v] = idx
        return idx

    for p in sorted(tree.participants):
        emit(p)
    root_deps = tuple(op_to_parent[c] for c in children.get(tree.root, []))
    a = acc.get(tree.root, frozenset(
        {tree.root} if tree.root in tree.participants else set()))
    a = a.union(*(acc[c] for c in children.get(tree.root, []))) \
        if children.get(tree.root) else a
    # Root-side adds: one per arriving packet, performed in the root PE.
    prog.append(PacketOp(
        tree.root, tree.root, 0, vc=vc, inject=False, eject=False,
        pe_adds=len(root_deps) * words, deps=root_deps,
        delay=cfg.pe_add_cycles, tag=tag + ":root", chunk=chunk,
        contribs=a, delivers=(tree.root,)))
    return len(prog) - 1


# --------------------------------------------------------------------------- #
# Multicast / broadcast
# --------------------------------------------------------------------------- #
def _plan_multicast_ina(prog: list[PacketOp], tree: CollectiveTree,
                        payload_bits: float, cfg: NocConfig, *, vc: int,
                        chunk: int, tag: str, contribs: frozenset,
                        deps: tuple[int, ...]) -> list[int]:
    """Tree multicast with forking routers: one packet per segment, forked
    (not ejected) at branch nodes; participants receive NI copies in
    passing.  Returns the indices of the leaf-terminal ops."""
    flits = _payload_flits(cfg, payload_bits)
    segs = segments(tree)
    parts = tree.participants
    if not segs:
        prog.append(PacketOp(tree.root, tree.root, 0, vc=vc,
                             inject=False, eject=False, deps=deps,
                             tag=tag + ":self", chunk=chunk,
                             contribs=contribs, delivers=(tree.root,)))
        return [len(prog) - 1]
    by_head = {s[0]: s for s in segs}
    op_of_head: dict[Coord, int] = {}
    finals: list[int] = []

    def emit(seg: list[Coord]) -> int:
        head, end = seg[0], seg[-1]   # flow is end -> head (root side = end)
        if head in op_of_head:
            return op_of_head[head]
        if end == tree.root:
            dep_idx = deps
            from_root = True
        else:
            dep_idx = (emit(by_head[end]),)
            from_root = False
        to_leaf = not any(s is not seg and s[-1] == head for s in segs)
        # NI copies: interior participants (and the fork node itself when it
        # participates and the packet is absorbed there) snoop the passing
        # packet through the local ejection port.
        drops = [v for v in seg[1:-1] if v in parts]
        if not to_leaf and head in parts:
            drops.append(head)
        idx = len(prog)
        prog.append(PacketOp(
            end, head, flits, vc=vc, inject=from_root,
            eject=to_leaf,
            extra_ni_flits=len(drops) * flits,
            deps=dep_idx, path=list(reversed(seg)), tag=tag, chunk=chunk,
            contribs=contribs,
            delivers=tuple(drops) + ((head,) if to_leaf else ())))
        op_of_head[head] = idx
        if to_leaf:
            finals.append(idx)
        return idx

    for s in segs:
        emit(s)
    return finals


def _plan_multicast_unicast(prog: list[PacketOp], tree: CollectiveTree,
                            payload_bits: float, cfg: NocConfig, *, vc: int,
                            chunk: int, tag: str, contribs: frozenset,
                            deps: tuple[int, ...], path_of=None) -> list[int]:
    """Multicast without router support: one unicast per destination,
    serialised through the root's injection port."""
    flits = _payload_flits(cfg, payload_bits)
    out = []
    for p in sorted(tree.participants - {tree.root}):
        prog.append(PacketOp(tree.root, p, flits, vc=vc, deps=deps,
                             path=path_of(tree.root, p) if path_of else None,
                             tag=tag, chunk=chunk, contribs=contribs,
                             delivers=(p,)))
        out.append(len(prog) - 1)
    return out


# --------------------------------------------------------------------------- #
# Gather (collection without combining; the paper's gather packet)
# --------------------------------------------------------------------------- #
def _plan_gather_ina(prog: list[PacketOp], tree: CollectiveTree,
                     result_bits: float, cfg: NocConfig, *, vc: int,
                     chunk: int, tag: str) -> int:
    """Gather-capable routers: packets collect result words in passing and
    merge at branch nodes; packet size tracks the results on board."""
    parts = tree.participants
    segs = segments(tree)
    if not segs:
        prog.append(PacketOp(tree.root, tree.root, 0, vc=vc,
                             inject=False, eject=False, tag=tag + ":self",
                             chunk=chunk, contribs=frozenset(parts),
                             delivers=(tree.root,)))
        return len(prog) - 1
    by_head = {s[0]: s for s in segs}
    ending_at: dict[Coord, list[Coord]] = {}
    for s in segs:
        ending_at.setdefault(s[-1], []).append(s[0])
    op_of_head: dict[Coord, int] = {}
    acc_of_head: dict[Coord, frozenset] = {}

    def emit(seg: list[Coord]) -> int:
        head, end = seg[0], seg[-1]
        if head in op_of_head:
            return op_of_head[head]
        dep_idx = tuple(emit(by_head[h]) for h in ending_at.get(head, []))
        acc = frozenset().union(*(acc_of_head[h]
                                  for h in ending_at.get(head, []))) \
            if dep_idx else frozenset()
        on_board = acc | frozenset(v for v in seg[:-1] if v in parts)
        # Results joining the packet cross the local NI — except the
        # root's own, which meets the payload inside its router at
        # ejection (consistent with the multi-arrival root path below).
        boarded = len(on_board) - len(acc)
        last = end == tree.root and len(ending_at.get(end, [])) == 1
        if last and end in parts:
            on_board = on_board | {end}
        flits = _payload_flits(cfg, len(on_board) * result_bits)
        idx = len(prog)
        prog.append(PacketOp(
            head, end, flits, vc=vc, inject=not dep_idx, eject=last,
            extra_ni_flits=boarded * result_bits / cfg.flit_bits,
            deps=dep_idx, path=list(seg), tag=tag, chunk=chunk,
            contribs=on_board, delivers=(end,) if last else ()))
        op_of_head[head] = idx
        acc_of_head[head] = on_board
        return idx

    for s in segs:
        emit(s)
    root_heads = ending_at.get(tree.root, [])
    if len(root_heads) == 1:
        return op_of_head[root_heads[0]]
    deps = tuple(op_of_head[h] for h in root_heads)
    acc = frozenset().union(*(acc_of_head[h] for h in root_heads))
    if tree.root in parts:
        acc = acc | {tree.root}
    flits = _payload_flits(cfg, len(acc) * result_bits)
    prog.append(PacketOp(
        tree.root, tree.root, flits, vc=vc, inject=False, eject=True,
        deps=deps, tag=tag + ":eject", chunk=chunk, contribs=acc,
        delivers=(tree.root,)))
    return len(prog) - 1


def _plan_gather_unicast(prog: list[PacketOp], tree: CollectiveTree,
                         result_bits: float, cfg: NocConfig, *, vc: int,
                         chunk: int, tag: str, path_of=None) -> int:
    """No gather support: every participant unicasts its own result packet
    to the root (the paper's ``per_chain_unicast`` baseline collection)."""
    flits = _payload_flits(cfg, result_bits)
    idxs = []
    for p in sorted(tree.participants - {tree.root}):
        prog.append(PacketOp(p, tree.root, flits, vc=vc, tag=tag,
                             path=path_of(p, tree.root) if path_of else None,
                             chunk=chunk, contribs=frozenset({p}),
                             delivers=(tree.root,)))
        idxs.append(len(prog) - 1)
    prog.append(PacketOp(tree.root, tree.root, 0, vc=vc, inject=False,
                         eject=False, deps=tuple(idxs), tag=tag + ":root",
                         chunk=chunk, contribs=frozenset(tree.participants),
                         delivers=(tree.root,)))
    return len(prog) - 1


# --------------------------------------------------------------------------- #
# Public planner
# --------------------------------------------------------------------------- #
def plan_collective(op: str, participants: Iterable[Coord],
                    payload_bits: float, cfg: NocConfig = NocConfig(), *,
                    root: Optional[Coord] = None,
                    algorithm: str = "reduce_bcast",
                    semantics: str = "ina",
                    order: str = "xy", vc: int = 0,
                    faults=None) -> list[PacketOp]:
    """Lower a collective into a packet program.

    ``payload_bits`` is the per-participant operand size (reduce/broadcast/
    allreduce) or per-participant result size (gather).  ``root`` defaults
    to the first participant.  ``algorithm`` selects the allreduce lowering;
    ``semantics`` selects router capability (see module docstring).

    ``faults`` (an optional :class:`~repro_torch.core.noc.faults.
    FaultModel`) switches to the fault-repaired planner: trees rebuilt over
    the healthy fabric, dead participants remapped to healthy neighbors,
    and every packet carrying an explicit turn-rule-legal route override.
    ``None`` or an empty model takes this exact code path: bit-identical
    programs.
    """
    assert op in COLLECTIVE_OPS, op
    assert semantics in SEMANTICS, semantics
    if faults is not None and not faults.empty:
        return _plan_faulted(op, participants, payload_bits, cfg, root=root,
                             algorithm=algorithm, semantics=semantics,
                             vc=vc, faults=faults)
    parts = sorted(set(participants))
    assert parts, "empty participant set"
    root = parts[0] if root is None else root
    prog: list[PacketOp] = []

    if op == "reduce":
        tree = reduction_tree(root, parts, order)
        if semantics == "ina":
            _plan_reduce_ina(prog, tree, payload_bits, cfg, vc=vc, chunk=0,
                             tag="reduce")
        else:
            _plan_reduce_eject_inject(prog, tree, payload_bits, cfg, vc=vc,
                                      chunk=0, tag="reduce")
        return prog

    if op == "broadcast":
        tree = multicast_tree(root, parts, order)
        plan = _plan_multicast_ina if semantics == "ina" \
            else _plan_multicast_unicast
        plan(prog, tree, payload_bits, cfg, vc=vc, chunk=0, tag="bcast",
             contribs=frozenset({root}), deps=())
        return prog

    if op == "gather":
        tree = reduction_tree(root, parts, order)
        plan = _plan_gather_ina if semantics == "ina" \
            else _plan_gather_unicast
        plan(prog, tree, payload_bits, cfg, vc=vc, chunk=0, tag="gather")
        return prog

    # allreduce
    assert algorithm in ALLREDUCE_ALGORITHMS, algorithm
    if algorithm == "reduce_bcast":
        rtree = reduction_tree(root, parts, order)
        if semantics == "ina":
            final = _plan_reduce_ina(prog, rtree, payload_bits, cfg, vc=vc,
                                     chunk=0, tag="ar:reduce")
        else:
            final = _plan_reduce_eject_inject(prog, rtree, payload_bits, cfg,
                                              vc=vc, chunk=0, tag="ar:reduce")
        btree = multicast_tree(root, parts, order)
        plan = _plan_multicast_ina if semantics == "ina" \
            else _plan_multicast_unicast
        plan(prog, btree, payload_bits, cfg, vc=vc, chunk=0, tag="ar:bcast",
             contribs=frozenset(parts), deps=(final,))
        return prog

    # rs_ag: chunk c is reduced on a tree rooted at participant c, then
    # all-gathered by a multicast from that root.  Chunk trees have distinct
    # roots, so their traffic spreads over the mesh and overlaps in time.
    chunk_bits = payload_bits / len(parts)
    for c, r in enumerate(parts):
        rtree = reduction_tree(r, parts, order)
        if semantics == "ina":
            final = _plan_reduce_ina(prog, rtree, chunk_bits, cfg, vc=vc,
                                     chunk=c, tag=f"rs[{c}]")
        else:
            final = _plan_reduce_eject_inject(prog, rtree, chunk_bits, cfg,
                                              vc=vc, chunk=c, tag=f"rs[{c}]")
        btree = multicast_tree(r, parts, order)
        plan = _plan_multicast_ina if semantics == "ina" \
            else _plan_multicast_unicast
        plan(prog, btree, chunk_bits, cfg, vc=vc, chunk=c, tag=f"ag[{c}]",
             contribs=frozenset(parts), deps=(final,))
    return prog


# --------------------------------------------------------------------------- #
# Fault-repaired planning (core/noc/faults.py)
# --------------------------------------------------------------------------- #
def _tree_path(tree: CollectiveTree, child: Coord,
               ancestor: Coord) -> list[Coord]:
    """Nodes from ``child`` up the repaired tree to ``ancestor``
    (inclusive) — the explicit route override for a logical edge."""
    path = [child]
    v = child
    while v != ancestor:
        v = tree.parent[v]
        path.append(v)
    return path


def _plan_faulted(op: str, participants: Iterable[Coord],
                  payload_bits: float, cfg: NocConfig, *,
                  root: Optional[Coord], algorithm: str, semantics: str,
                  vc: int, faults) -> list[PacketOp]:
    """The fault-repaired lowering: same op/semantics/algorithm matrix as
    the clean planner, but trees come from a turn-restricted repair BFS,
    dead participants are remapped to healthy neighbors, and *every* packet
    (including the eject-inject unicasts that normally ride implicit XY)
    carries an explicit tree-path override — the simulator never derives a
    route that could cross a failed link.

    The whole program plans under one detour rule: west-first preferred
    (XY-compatible, minimal perturbation), falling back to up*/down* —
    which routes any connected fault pattern — when west-first's partial
    adaptivity leaves some participant unreachable.  Rules never mix
    within a program (mixing would break the per-rule deadlock argument).
    """
    from ..faults import UnroutableError
    try:
        return _plan_faulted_rule(op, participants, payload_bits, cfg,
                                  root=root, algorithm=algorithm,
                                  semantics=semantics, vc=vc, faults=faults,
                                  rule="west_first")
    except UnroutableError:
        return _plan_faulted_rule(op, participants, payload_bits, cfg,
                                  root=root, algorithm=algorithm,
                                  semantics=semantics, vc=vc, faults=faults,
                                  rule="updown")


def _plan_faulted_rule(op: str, participants: Iterable[Coord],
                       payload_bits: float, cfg: NocConfig, *,
                       root: Optional[Coord], algorithm: str,
                       semantics: str, vc: int, faults,
                       rule: str) -> list[PacketOp]:
    from ..faults import (remap_participants, remap_root,
                          repair_multicast_tree, repair_reduction_tree)
    assert not faults.transient, ("resolve transient faults with "
                                  "FaultModel.at_window() before planning")
    parts_all = sorted(set(participants))
    assert parts_all, "empty participant set"
    w, h = cfg.width, cfg.height
    healthy, _ = remap_participants(parts_all, faults, w, h)
    root = remap_root(parts_all[0] if root is None else root,
                      healthy, faults)
    prog: list[PacketOp] = []

    def up_path(tree):                    # leaf -> ancestor (reduce/gather)
        return lambda a, b: _tree_path(tree, a, b)

    def down_path(tree):                  # root -> leaf (multicast)
        return lambda a, b: list(reversed(_tree_path(tree, b, a)))

    if op == "reduce":
        tree = repair_reduction_tree(root, healthy, faults, w, h, rule)
        if semantics == "ina":
            _plan_reduce_ina(prog, tree, payload_bits, cfg, vc=vc, chunk=0,
                             tag="reduce")
        else:
            _plan_reduce_eject_inject(prog, tree, payload_bits, cfg, vc=vc,
                                      chunk=0, tag="reduce",
                                      path_of=up_path(tree))
        return prog

    if op == "broadcast":
        tree = repair_multicast_tree(root, healthy, faults, w, h, rule)
        if semantics == "ina":
            _plan_multicast_ina(prog, tree, payload_bits, cfg, vc=vc,
                                chunk=0, tag="bcast",
                                contribs=frozenset({root}), deps=())
        else:
            _plan_multicast_unicast(prog, tree, payload_bits, cfg, vc=vc,
                                    chunk=0, tag="bcast",
                                    contribs=frozenset({root}), deps=(),
                                    path_of=down_path(tree))
        return prog

    if op == "gather":
        tree = repair_reduction_tree(root, healthy, faults, w, h, rule)
        if semantics == "ina":
            _plan_gather_ina(prog, tree, payload_bits, cfg, vc=vc, chunk=0,
                             tag="gather")
        else:
            _plan_gather_unicast(prog, tree, payload_bits, cfg, vc=vc,
                                 chunk=0, tag="gather",
                                 path_of=up_path(tree))
        return prog

    # allreduce
    assert algorithm in ALLREDUCE_ALGORITHMS, algorithm
    if algorithm == "reduce_bcast":
        rtree = repair_reduction_tree(root, healthy, faults, w, h, rule)
        if semantics == "ina":
            final = _plan_reduce_ina(prog, rtree, payload_bits, cfg, vc=vc,
                                     chunk=0, tag="ar:reduce")
        else:
            final = _plan_reduce_eject_inject(prog, rtree, payload_bits,
                                              cfg, vc=vc, chunk=0,
                                              tag="ar:reduce",
                                              path_of=up_path(rtree))
        btree = repair_multicast_tree(root, healthy, faults, w, h, rule)
        if semantics == "ina":
            _plan_multicast_ina(prog, btree, payload_bits, cfg, vc=vc,
                                chunk=0, tag="ar:bcast",
                                contribs=frozenset(healthy), deps=(final,))
        else:
            _plan_multicast_unicast(prog, btree, payload_bits, cfg, vc=vc,
                                    chunk=0, tag="ar:bcast",
                                    contribs=frozenset(healthy),
                                    deps=(final,), path_of=down_path(btree))
        return prog

    # rs_ag over the *healthy* set: chunk c reduces on a repaired tree
    # rooted at healthy participant c, then all-gathers from that root.
    chunk_bits = payload_bits / len(healthy)
    for c, r in enumerate(healthy):
        rtree = repair_reduction_tree(r, healthy, faults, w, h, rule)
        if semantics == "ina":
            final = _plan_reduce_ina(prog, rtree, chunk_bits, cfg, vc=vc,
                                     chunk=c, tag=f"rs[{c}]")
        else:
            final = _plan_reduce_eject_inject(prog, rtree, chunk_bits, cfg,
                                              vc=vc, chunk=c, tag=f"rs[{c}]",
                                              path_of=up_path(rtree))
        btree = repair_multicast_tree(r, healthy, faults, w, h, rule)
        if semantics == "ina":
            _plan_multicast_ina(prog, btree, chunk_bits, cfg, vc=vc,
                                chunk=c, tag=f"ag[{c}]",
                                contribs=frozenset(healthy), deps=(final,))
        else:
            _plan_multicast_unicast(prog, btree, chunk_bits, cfg, vc=vc,
                                    chunk=c, tag=f"ag[{c}]",
                                    contribs=frozenset(healthy),
                                    deps=(final,), path_of=down_path(btree))
    return prog


# --------------------------------------------------------------------------- #
# Verification helpers (algebraic, no simulation)
# --------------------------------------------------------------------------- #
def delivered_contribs(prog: Sequence[PacketOp]) -> dict[Coord, dict[int, frozenset]]:
    """For every node that receives payload: chunk -> union of participant
    contributions delivered.  An allreduce is correct iff every participant
    maps every chunk to the full participant set."""
    out: dict[Coord, dict[int, frozenset]] = {}
    for op in prog:
        for node in op.delivers:
            cur = out.setdefault(node, {})
            cur[op.chunk] = cur.get(op.chunk, frozenset()) | op.contribs
    return out


def program_reduce_words(prog: Sequence[PacketOp]) -> int:
    return sum(op.reduce_words for op in prog)


def program_pe_adds(prog: Sequence[PacketOp]) -> int:
    return sum(op.pe_adds for op in prog)


# --------------------------------------------------------------------------- #
# The paper's WS dataflow as planner-emitted schedules (Figs. 4a/4b).
# --------------------------------------------------------------------------- #
def ws_round_program(cfg: NocConfig, mode: str, window: int, *, g: int,
                     p: int, gather_flits: int, unicast_flits: int,
                     e_pes: int = 1) -> list[PacketOp]:
    """Emit ``window`` back-to-back WS accumulation/gather rounds.

    This is the paper's fixed per-column flow expressed as a collective
    program: ``ws_ina`` / ``os_gather`` rounds are one south-riding column
    gather packet per column (with in-network accumulation of every chain
    for ``ws_ina``); ``ws_noina`` rounds run the Fig. 4(a) eject->add->
    inject relay chains first and collect the results per
    ``cfg.baseline_collection``.  Op order matches the legacy traffic
    generator exactly so link arbitration (and therefore latency/energy)
    is reproduced cycle-for-cycle.

    Rectangular meshes (mapper search space): columns are ``cfg.width``
    gather flows of ``cfg.height`` routers each; chain placement requires
    ``g * p <= cfg.height`` (the traffic planner guarantees it).
    """
    width = cfg.width
    port_row = cfg.height - 1          # per-column memory port at south edge
    prog: list[PacketOp] = []

    def gather_op(x: int, deps: tuple[int, ...]) -> PacketOp:
        ina = mode == "ws_ina"
        # Result words enter the gather payload through the tails' NIs in
        # both modes; chain operands additionally reach the INA block
        # through the local NI in the INA mode.
        extra = float(gather_flits - 1)
        if ina:
            words = g * (p - 1) * e_pes
            extra += words * cfg.gather_payload_bits / cfg.flit_bits
        return PacketOp((x, 0), (x, port_row), gather_flits, vc=1,
                        reduce_words=g * (p - 1) if ina else 0,
                        extra_ni_flits=extra, deps=deps, tag="ws:gather")

    for _ in range(window):
        for x in range(width):
            if mode == "ws_noina" and p > 1:
                tails = []
                for gi in range(g):
                    chain = [(x, gi * p + r) for r in range(p)]
                    prev: Optional[int] = None
                    for s, d in zip(chain[:-1], chain[1:]):
                        idx = len(prog)
                        prog.append(PacketOp(
                            s, d, unicast_flits, vc=0, pe_adds=1,
                            deps=(prev,) if prev is not None else (),
                            delay=cfg.pe_add_cycles if prev is not None else 0,
                            tag="ws:chain"))
                        prev = idx
                    tails.append(prev)
                deps = tuple(t for t in tails if t is not None)
                # A chain completes pe_add_cycles after its last relay
                # packet lands (the tail PE's final add); the collection
                # departs only then.
                if cfg.baseline_collection == "per_chain_unicast":
                    for gi in range(g):
                        tail = (x, gi * p + p - 1)
                        prog.append(PacketOp(tail, (x, port_row),
                                             unicast_flits, vc=1, deps=deps,
                                             delay=cfg.pe_add_cycles,
                                             tag="ws:unicast"))
                else:
                    op = gather_op(x, deps)
                    op.delay = cfg.pe_add_cycles
                    prog.append(op)
            else:
                prog.append(gather_op(x, ()))
    return prog
