"""The port's NoC fault layer (``repro_torch.core.noc.faults`` and what
waits for it) against the reference's (``repro.core.noc.faults``), on the
CPU and with no tolerance: the two are exact.

* ``seeded_faults`` over mesh sizes, rates, windows and seeds: links,
  routers, PEs, transients, ``key()``, ``at_window`` and
  ``Mesh.seeded_faults``;
* ``detour_route`` under both turn rules for every (src, dst) pair of the
  corpus mesh, ``path_is_west_first`` / ``path_is_updown``, ``updown_keys``,
  the repaired reduction and multicast trees, ``remap_participants`` /
  ``remap_root``: equal paths, trees and refusals (``UnroutableError``);
* every program of ``faulted_collective_programs`` and
  ``faulted_hier_schedules``: op for op, and ``verify_faulted`` finds
  nothing in either;
* ``collective_cost(..., faults=)``: latency, energy, packets and the
  store key; an empty model takes the unfaulted path;
* ``verify_faulted``'s findings on the reference's mutations;
* ``fault_slowdown`` / ``DegradedCostModel``, and ``run_faults(QUICK_SWEEP)``
  with its CSV rows and the report's faults table.
"""
import dataclasses
import itertools

import pytest

from repro.analysis import corpus as jcorpus
from repro.analysis import verify as jverify
from repro.core.noc import faults as jf
from repro.core.noc.collective import cost as jcost
from repro.core.noc.collective import schedule as jschedule
from repro.core.noc.hierarchy import HierarchicalMesh as JHierarchicalMesh
from repro.core.noc.hierarchy import plan_hier_collective as jplan_hier
from repro.core.noc.router import NocConfig as JNocConfig
from repro.core.noc.topology import Mesh as JMesh
from repro.experiments import report as jreport
from repro.experiments import sweeps as jsweeps
from repro.serve import costs as jcosts

import _torch_ref_plans as R
from repro_torch.analysis import corpus
from repro_torch.analysis import verify
from repro_torch.core.noc import SIM_CACHE
from repro_torch.core.noc import faults as tf
from repro_torch.core.noc.collective import cost as tcost
from repro_torch.core.noc.collective import schedule as tschedule
from repro_torch.core.noc.collective.trees import full_mesh
from repro_torch.core.noc.hierarchy import (HierarchicalMesh,
                                            plan_hier_collective)
from repro_torch.core.noc.router import NocConfig
from repro_torch.core.noc.topology import Mesh
from repro_torch.experiments import report, sweeps
from repro_torch.serve import costs

N = corpus.FAULT_MESH_N
CFG, JCFG = NocConfig(n=N), JNocConfig(n=N)
FULL = [(x, y) for x in range(N) for y in range(N)]
SCATTERED = [(0, 0), (N - 1, 1), (1, N - 1), (N - 2, N - 2)]

#: (width, height, rates) of the seeded models; the corpus's densities
#: come on top, through ``fault_models``.
SEEDED = [
    (4, 4, dict(link_rate=0.1, seed=0)),
    (6, 6, dict(link_rate=0.08, router_rate=0.02, pe_rate=0.05, seed=11)),
    (8, 8, dict(link_rate=0.15, router_rate=0.05, pe_rate=0.08, seed=23)),
    (8, 4, dict(link_rate=0.2, pe_rate=0.1, seed=7)),
    (5, 7, dict(transient_rate=0.05, windows=3, link_rate=0.04, seed=5)),
    (6, 6, dict(link_rate=0.12, seed=0)),
]


def _model(m) -> tuple:
    return (m.links, m.routers, m.pes, m.transient, m.seed, m.key(),
            m.empty)


def _pair(w, h, **rates):
    return (tf.seeded_faults(w, h, **rates), jf.seeded_faults(w, h, **rates))


def _models():
    """``(label, port model, reference model)`` on the corpus mesh: the
    corpus densities, the hierarchy corpus's links-only model, and the
    reference's up*/down* fallback case (seed 0 at 12% links)."""
    out = [(spec["label"], tf.seeded_faults(N, N, **{
        k: v for k, v in spec.items() if k != "label"}),
        jf.seeded_faults(N, N, **{k: v for k, v in spec.items()
                                  if k != "label"}))
        for spec in corpus.FAULT_SPECS]
    out.append(("hier", *_pair(N, N, link_rate=0.08, seed=5)))
    out.append(("updown", *_pair(N, N, link_rate=0.12, seed=0)))
    return out


MODELS = _models()


def _outcome(fn, *args, **kw):
    """``fn``'s value, or the name of the exception it raised."""
    try:
        return fn(*args, **kw)
    except (tf.UnroutableError, jf.UnroutableError, ValueError,
            AssertionError) as e:
        return type(e).__name__


def _tree(t):
    if isinstance(t, str):
        return t
    return (t.root, t.participants, sorted(t.parent.items()))


def _ops(prog):
    return [dataclasses.asdict(o) for o in prog]


def _found(findings):
    return [(f.check, f.where, f.message) for f in findings]


# --------------------------------------------------------------------------- #
# The fault model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("w,h,rates", SEEDED)
def test_seeded_faults_match_reference(w, h, rates):
    got, want = _pair(w, h, **rates)
    assert _model(got) == _model(want)
    assert _model(Mesh(w, h).seeded_faults(**rates)) == \
        _model(JMesh(w, h).seeded_faults(**rates))
    for window in range(rates.get("windows", 0) + 1):
        assert _model(got.at_window(window)) == \
            _model(want.at_window(window))
    for path in ([(0, 0), (1, 0), (1, 1)], [(w - 1, h - 1), (w - 2, h - 1)]):
        assert got.path_clear(path) == want.path_clear(path)
    assert _model(tf.EMPTY_FAULTS) == _model(jf.EMPTY_FAULTS)
    assert tf.mesh_links(w, h) == jf.mesh_links(w, h)


# --------------------------------------------------------------------------- #
# Detour routes, turn rules, repaired trees, remapping
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("label,got,want", MODELS, ids=[m[0] for m in MODELS])
def test_detour_routes_match_reference(label, got, want):
    """Every (src, dst) pair under both rules: the same path hop for hop,
    or the same refusal; each path's rule checks agree too."""
    assert _outcome(tf.updown_keys, got, N, N) == \
        _outcome(jf.updown_keys, want, N, N)
    for src, dst in itertools.product(FULL, FULL):
        for rule in tf.DETOUR_RULES:
            path = _outcome(tf.detour_route, src, dst, got, N, N, rule)
            assert path == _outcome(jf.detour_route, src, dst, want, N, N,
                                    rule), (src, dst, rule)
            if isinstance(path, str):
                continue
            assert tf.path_is_west_first(path) == \
                jf.path_is_west_first(path)
            assert tf.path_is_updown(path, got, N, N) == \
                jf.path_is_updown(path, want, N, N)


@pytest.mark.parametrize("label,got,want", MODELS, ids=[m[0] for m in MODELS])
def test_repaired_trees_and_remap_match_reference(label, got, want):
    """Both trees under both rules for the corpus's participant sets, from
    the remapped root: the same parent map, or the same refusal."""
    for parts in (FULL, SCATTERED):
        healthy = _outcome(tf.remap_participants, parts, got, N, N)
        assert healthy == _outcome(jf.remap_participants, parts, want, N, N)
        assert tf.remap_participants(parts, got) == \
            jf.remap_participants(parts, want)
        if isinstance(healthy, str):
            continue
        healthy = healthy[0]
        for root in (parts[0], parts[-1], (N // 2, N // 2)):
            r = tf.remap_root(root, healthy, got)
            assert r == jf.remap_root(root, healthy, want)
            for rule in tf.DETOUR_RULES:
                for port, ref in ((tf.repair_reduction_tree,
                                   jf.repair_reduction_tree),
                                  (tf.repair_multicast_tree,
                                   jf.repair_multicast_tree)):
                    assert _tree(_outcome(port, r, healthy, got, N, N,
                                          rule)) == \
                        _tree(_outcome(ref, r, healthy, want, N, N, rule))


def test_a_cut_mesh_raises_in_both():
    """A node whose four links all failed: the detour, the tree repair and
    the repaired planner refuse it in both packages; a mesh of failed
    routers has no up*/down* orientation."""
    corner = (0, 0)
    cut = dict(links=frozenset({((0, 0), (1, 0)), ((0, 0), (0, 1))}))
    got, want = tf.FaultModel(**cut), jf.FaultModel(**cut)
    for rule in tf.DETOUR_RULES:
        with pytest.raises(tf.UnroutableError):
            tf.detour_route(corner, (3, 3), got, N, N, rule)
        with pytest.raises(jf.UnroutableError):
            jf.detour_route(corner, (3, 3), want, N, N, rule)
        with pytest.raises(tf.UnroutableError):
            tf.repair_reduction_tree((3, 3), [corner, (3, 3)], got, N, N,
                                     rule)
        with pytest.raises(jf.UnroutableError):
            jf.repair_reduction_tree((3, 3), [corner, (3, 3)], want, N, N,
                                     rule)
    # the corner is stranded, so the planner drops it and plans the rest
    assert _ops(tschedule.plan_collective("reduce", FULL, 512.0, CFG,
                                          faults=got)) == \
        _ops(jschedule.plan_collective("reduce", FULL, 512.0, JCFG,
                                       faults=want))
    dead = [(x, y) for x in range(2) for y in range(2)]
    with pytest.raises(tf.UnroutableError, match="every router failed"):
        tf.updown_keys(tf.FaultModel(routers=frozenset(dead)), 2, 2)
    with pytest.raises(jf.UnroutableError, match="every router failed"):
        jf.updown_keys(jf.FaultModel(routers=frozenset(dead)), 2, 2)
    with pytest.raises(tf.UnroutableError, match="no healthy"):
        tf.remap_participants([(0, 0)], tf.FaultModel(pes={(0, 0)}))
    transient = tf.FaultModel(transient=((0, ((0, 0), (1, 0))),))
    with pytest.raises(ValueError, match="at_window"):
        tf.detour_route((0, 0), (2, 0), transient, N, N)
    with pytest.raises(AssertionError, match="at_window"):
        tschedule.plan_collective("reduce", FULL, 512.0, CFG,
                                  faults=transient)


# --------------------------------------------------------------------------- #
# Repaired programs and their verification
# --------------------------------------------------------------------------- #
def test_faulted_collective_corpus_matches_reference():
    """Every program of the faulted corpus (all densities): op for op, and
    ``verify_faulted`` finds nothing, with and without the algebra."""
    got = list(corpus.faulted_collective_programs())
    want = list(jcorpus.faulted_collective_programs())
    assert len(got) == len(want) == 60
    assert len(list(corpus.faulted_collective_programs(quick=True))) == 20
    for (case, cfg, faults, prog), (jcase, jcfg, jfaults, jprog) in zip(
            got, want):
        assert case == jcase and _model(faults) == _model(jfaults)
        assert _ops(prog) == _ops(jprog), case
        kw = dict(op=case["op"], participants=case["participants"],
                  algorithm=case["algorithm"], semantics=case["semantics"])
        assert verify.verify_faulted(prog, faults, cfg) == []
        assert verify.verify_faulted(prog, faults, cfg, **kw) == []


def _lanes(sched):
    return [(level.name, lane.label, lane.scope, lane.chip, _ops(lane.prog))
            for level, lane in sched.all_lanes()]


def test_faulted_hier_corpus_matches_reference():
    """Every faulted hierarchical schedule (on-die link faults, one failed
    chip on the 2 x 2 grid): lane for lane, op for op, and each chip lane
    verifies clean under its faults."""
    got = list(corpus.faulted_hier_schedules())
    want = list(jcorpus.faulted_hier_schedules())
    assert len(got) == len(want) == 12
    for (case, faults, sched), (jcase, jfaults, jsched) in zip(got, want):
        assert case == jcase and _model(faults) == _model(jfaults)
        assert _lanes(sched) == _lanes(jsched), case
        assert verify.verify_hier_schedule(sched) == []
        for _, lane in sched.all_lanes():
            if lane.scope == "chip":
                assert verify.verify_faulted(list(lane.prog), faults,
                                             lane.cfg) == []
    hm = dict(chip_w=N, chip_h=N, chips_x=2, chips_y=2)
    got = plan_hier_collective("allreduce", HierarchicalMesh(**hm), 4096.0,
                               failed_chips=(3,))
    want = jplan_hier("allreduce", JHierarchicalMesh(**hm), 4096.0,
                      failed_chips=(3,))
    assert _lanes(got) == _lanes(want)
    assert 3 not in {lane.chip for _, lane in got.all_lanes()}
    clean = HierarchicalMesh(chips_x=2, chips_y=1)
    assert plan_hier_collective("allreduce", clean, 4096.0) == \
        plan_hier_collective("allreduce", clean, 4096.0,
                             faults=tf.EMPTY_FAULTS, failed_chips=())


def _first_routed(prog):
    for i, o in enumerate(prog):
        if o.flits and o.path is not None and len(o.path) > 2:
            return i, o
    raise AssertionError("no multi-hop routed op")


def _mutants(sched, faults, n):
    """The reference's mutations (tests/test_faults.py) of a repaired
    reduce on ``sched``'s package (``tschedule`` or ``jschedule``)."""
    full = [(x, y) for x in range(n) for y in range(n)]
    cfg = (NocConfig if sched is tschedule else JNocConfig)(n=n)
    base = list(sched.plan_collective("reduce", full, 512.0, cfg,
                                      faults=faults))
    i, o = _first_routed(base)
    out = {}
    a, b = sorted(faults.links)[0]
    prog = list(base)
    prog[i] = dataclasses.replace(o, src=a, dst=b, path=(a, b))
    out["failed-link"] = (prog, {})
    x, y = o.path[0]
    step = (x + 1, y) if x + 1 < n else (x - 1, y)
    prog = list(base)
    prog[i] = dataclasses.replace(o, path=(o.path[0], step, *o.path))
    out["u-turn"] = (prog, {})
    prog = list(base)
    prog[i] = dataclasses.replace(
        o, contribs=frozenset(o.contribs) | {sorted(faults.pes)[0]})
    out["dead-pe"] = (prog, dict(op="reduce", participants=full))
    out["clean"] = (base, dict(op="reduce", participants=full))
    return out


def test_verify_faulted_findings_match_reference():
    """A path across a failed link, an illegal U-turn, a dead PE's operand,
    and a transient model: the same findings, check, place and message."""
    _, got, want = MODELS[1]                     # "medium": links, PEs
    port = _mutants(tschedule, got, N)
    ref = _mutants(jschedule, want, N)
    expect = {"failed-link": "fault-route", "u-turn": "fault-turn",
              "dead-pe": "fault-remap", "clean": None}
    for name, (prog, kw) in port.items():
        jprog, jkw = ref[name]
        assert _ops(prog) == _ops(jprog)
        found = _found(verify.verify_faulted(prog, got, CFG, **kw))
        assert found == _found(jverify.verify_faulted(jprog, want, JCFG,
                                                      **jkw)), name
        assert (expect[name] in {f[0] for f in found}) if expect[name] \
            else found == []
    transient = dict(transient=((0, ((0, 0), (1, 0))),))
    prog = tschedule.plan_collective("reduce", FULL, 512.0, CFG)
    jprog = jschedule.plan_collective("reduce", FULL, 512.0, JCFG)
    found = _found(verify.verify_faulted(prog, tf.FaultModel(**transient),
                                         CFG))
    assert found and found == _found(jverify.verify_faulted(
        jprog, jf.FaultModel(**transient), JCFG))


# --------------------------------------------------------------------------- #
# Costs, degraded serving, the sweep
# --------------------------------------------------------------------------- #
def _cost(c):
    return (c.latency_cycles, c.energy_pj, c.packets)


@pytest.mark.parametrize("semantics", ["ina", "eject_inject"])
def test_faulted_collective_cost_matches_reference(semantics):
    """Every op under every corpus model on the corpus mesh: latency,
    energy and packets; the store key ends in the model's ``key()``, and
    an empty model takes the unfaulted path with its memo and key."""
    with R.fresh_state():
        for (_, got, want), op in itertools.product(
                MODELS, ("reduce", "broadcast", "gather", "allreduce")):
            for algorithm in (("reduce_bcast", "rs_ag")
                              if op == "allreduce" else ("reduce_bcast",)):
                kw = dict(semantics=semantics, algorithm=algorithm)
                assert _cost(tcost.collective_cost(op, 4096.0, CFG,
                                                   faults=got, **kw)) == \
                    _cost(jcost.collective_cost(op, 4096.0, JCFG,
                                                faults=want, **kw)), op
                parts = tuple(full_mesh(N))
                assert SIM_CACHE.get(("collective-faulted", op, parts,
                                      4096.0, CFG, None, algorithm,
                                      semantics, "xy", got.key()))
        clean = _cost(tcost.collective_cost("allreduce", 4096.0, CFG,
                                            semantics=semantics))
        memo = tcost._simulate.cache_info().hits
        assert _cost(tcost.collective_cost(
            "allreduce", 4096.0, CFG, semantics=semantics,
            faults=tf.EMPTY_FAULTS)) == clean
        assert tcost._simulate.cache_info().hits == memo + 1


def test_fault_slowdown_and_degraded_model_match_reference():
    assert costs.fault_slowdown(None) == jcosts.fault_slowdown(None) == 1.0
    assert costs.fault_slowdown(tf.EMPTY_FAULTS) == 1.0
    for _, got, want in MODELS:
        for semantics in ("ina", "eject_inject"):
            s = costs.fault_slowdown(got, CFG, semantics=semantics)
            assert s == jcosts.fault_slowdown(want, JCFG,
                                              semantics=semantics) >= 1.0
    base, jbase = costs.SyntheticCostModel(), jcosts.SyntheticCostModel()
    d = costs.DegradedCostModel(base, 1.75)
    jd = jcosts.DegradedCostModel(jbase, 1.75)
    assert d.prefill_chunk_seconds() == jd.prefill_chunk_seconds() == \
        1.75 * base.prefill_chunk_seconds()
    for n in (0, 1, 3, 8):
        assert d.decode_iter_seconds(n) == jd.decode_iter_seconds(n)


def _without_clock(fig):
    return {k: ([{c: v for c, v in r.items() if c != "elapsed_us"}
                 for r in rows] if k in ("rows", "cluster_rows") else rows)
            for k, rows in fig.items()}


def test_run_faults_quick_matches_reference():
    """``run_faults(QUICK_SWEEP)``: the rows and cluster rows (degraded
    serving under a seeded replica-failure trace) without ``elapsed_us``,
    the CSV rows without their timing column, and the report's table."""
    with R.fresh_state():
        got = sweeps.run_faults(sweeps.QUICK_SWEEP)
        want = jsweeps.run_faults(jsweeps.QUICK_SWEEP)
    assert _without_clock(got) == _without_clock(want)
    assert [r["fault"] for r in got["cluster_rows"]] == ["none", "medium"]
    assert not any("faults_error" in r
                   for r in got["rows"] + got["cluster_rows"])
    assert got["rows"][0]["ina_degraded_x"] == 1.0
    csv = [line.split(",", 2) for line in sweeps._faults_csv(got)]
    jcsv = [line.split(",", 2) for line in jsweeps._faults_csv(want)]
    assert [(r[0], r[2]) for r in csv] == [(r[0], r[2]) for r in jcsv]
    assert report._faults_table(got) == jreport._faults_table(want)
    broken = dict(got, rows=[{"workload": "alexnet", "fault": "x",
                              "faults_error": "E: a|b\nc"}],
                  cluster_rows=[{"fault": "x", "faults_error": "E: d"}])
    jbroken = dict(broken)
    assert report._faults_table(broken) == jreport._faults_table(jbroken)
    assert sweeps._faults_csv(broken) == jsweeps._faults_csv(jbroken)
