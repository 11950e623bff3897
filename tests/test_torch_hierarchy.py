"""The port's package hierarchy (``repro_torch.core.noc.hierarchy``) and its
verifier against the reference's (``repro.core.noc.hierarchy``,
``repro.analysis.verify.verify_hier_schedule``).

* every ``hier_cases()`` entry (grids (2, 1) and (2, 2), both packages,
  every op, semantics and algorithm): ``plan_hier_collective`` gives the
  reference's levels, lanes and ops field for field, ``run_hier_schedule``
  its latency, per-level latencies and ledger exactly (energy to 1e-9
  relative), and the schedule verifies clean;
* one chip lowers to the flat program and replays bit-identically;
* the express package's channels are non-unit steps that the heap engine
  takes each as its own overflow resource: a packet pays one package hop,
  two packets on two channels contend only at the root's ejection port;
* ``hier_collective_cost``, ``hier_psum_mode_costs`` /
  ``choose_hier_psum_mode`` (p in {2, 3, 4, 8, 16} x chips in {2, 3, 4}
  x both packages at qwen2-1.5b's decode and prefill payloads) and
  ``chip_round_cost`` equal the reference's exactly;
* the mutations of ``tests/test_hierarchy.py`` give the reference's
  findings (check id and where);
* the mapper's package axis: ``evaluate_mapping`` at ``chips`` 2 and 4
  and a ``chips_list=(1, 2, 4)`` search under each package equal the
  reference's, whose winner ``chip_smoke.MAPPER_CHIPS`` holds.
"""
import dataclasses
import math

import pytest

from repro.analysis import verify as jverify
from repro.analysis.corpus import collective_cases, hier_cases
from repro.configs import ARCHS as JARCHS
from repro.core.noc import hierarchy as jh
from repro.core.noc.collective import schedule as jschedule
from repro.core.noc.collective.engine import run_program as jrun_program
from repro.core.noc.router import NocConfig as JNocConfig
from repro.core.ops import transformer_gemms as jtransformer_gemms
from repro.mapper import Mapping as JMapping
from repro.mapper import QUICK_MAPPER as JQUICK_MAPPER
from repro.mapper import evaluate_mapping as jevaluate_mapping
from repro.mapper import search_network as jsearch_network

from repro_torch.analysis import verify_hier_schedule
from repro_torch.configs import ARCHS
from repro_torch.core.noc import hierarchy as th
from repro_torch.core.noc.collective.engine import run_program
from repro_torch.core.noc.collective.schedule import (PacketOp,
                                                      plan_collective)
from repro_torch.core.noc.hierarchy.cost import hier_cache_key_count
from repro_torch.core.noc.router import NocConfig
from repro_torch.core.noc.simulator import path_link_ids
from repro_torch.core.ops import transformer_gemms
from repro_torch.mapper import (QUICK_MAPPER, Mapping, evaluate_mapping,
                                search_network)

CFG4, JCFG4 = NocConfig(n=4), JNocConfig(n=4)
QWEN2 = "qwen2-1.5b"
#: qwen2-1.5b's row-parallel psum payloads at 16 x 16 (``chip_smoke.
#: PLAN_16X16``): a decode step's and a prefill's, in bytes.
PAYLOADS = {"decode": 393216, "prefill": 3221225472}


def _where(findings):
    return [(f.check, f.where) for f in findings]


def _ops(prog):
    return [dataclasses.asdict(o) for o in prog]


def _pair(op, case_kw, payload=4096.0, **kw):
    """The same hierarchical schedule planned in the port and the
    reference."""
    got = th.plan_hier_collective(op, th.HierarchicalMesh(**case_kw),
                                  payload, CFG4, **kw)
    want = jh.plan_hier_collective(op, jh.HierarchicalMesh(**case_kw),
                                   payload, JCFG4, **kw)
    return got, want


def _same_schedule(got, want) -> None:
    assert (got.op, got.semantics, got.algorithm, got.payload_bits) == \
        (want.op, want.semantics, want.algorithm, want.payload_bits)
    assert [lv.name for lv in got.levels] == [lv.name for lv in want.levels]
    for glv, wlv in zip(got.levels, want.levels):
        assert len(glv.lanes) == len(wlv.lanes)
        for g, w in zip(glv.lanes, wlv.lanes):
            assert (g.label, g.scope, g.chip) == (w.label, w.scope, w.chip)
            assert dataclasses.asdict(g.cfg) == dataclasses.asdict(w.cfg)
            assert _ops(g.prog) == _ops(w.prog)


def _same_result(got, want) -> None:
    assert got.latency_cycles == want.latency_cycles
    assert got.level_latency == want.level_latency
    assert dataclasses.asdict(got.ledger) == dataclasses.asdict(want.ledger)
    assert math.isclose(got.energy_pj, want.energy_pj, rel_tol=1e-9)


# --------------------------------------------------------------------------- #
# the corpus: lowering, replay and verifier against the reference
# --------------------------------------------------------------------------- #
HIER = list(hier_cases())           # 2 grids x 2 packages x the op space


@pytest.mark.parametrize("case", HIER, ids=[
    f"{c['grid'][0]}x{c['grid'][1]}-{c['package']}-{c['op']}-"
    f"{c['semantics']}-{c['algorithm']}" for c in HIER])
def test_hier_case_equals_the_reference(case):
    got, want = _pair(case["op"], {"chips_x": case["grid"][0],
                                   "chips_y": case["grid"][1],
                                   "package": case["package"]},
                      algorithm=case["algorithm"],
                      semantics=case["semantics"])
    _same_schedule(got, want)
    _same_result(th.run_hier_schedule(got), jh.run_hier_schedule(want))
    assert verify_hier_schedule(got) == []


def test_one_chip_lowering_is_the_flat_program():
    parts = [(x, y) for x in range(4) for y in range(4)]
    for op in th.HIER_OPS:
        sched = th.plan_hier_collective(
            op, th.HierarchicalMesh(chip_w=4, chip_h=4), 2048.0, CFG4)
        assert [lv.name for lv in sched.levels] == ["flat"]
        (lane,) = sched.levels[0].lanes
        assert lane.cfg is CFG4          # the same object: the same keys
        flat = plan_collective(op, parts, 2048.0, CFG4, root=(0, 0))
        assert list(lane.prog) == flat
        res = th.run_hier_schedule(sched)
        ref = run_program(flat, CFG4)
        assert res.latency_cycles == ref.latency_cycles
        assert res.ledger == ref.ledger
        assert res.energy_pj == ref.network_energy_pj(CFG4)


def test_flat_wrapper_replays_the_collective_corpus():
    for case in collective_cases():
        prog = plan_collective(case["op"], case["participants"], 512.0,
                               CFG4, algorithm=case["algorithm"],
                               semantics=case["semantics"])
        sched = th.flat_hier_schedule(th.HierarchicalMesh(chip_w=4,
                                                          chip_h=4),
                                      prog, CFG4)
        res, ref = th.run_hier_schedule(sched), run_program(prog, CFG4)
        assert (res.latency_cycles, res.ledger) == \
            (ref.latency_cycles, ref.ledger), case


# --------------------------------------------------------------------------- #
# express channels in the heap engine
# --------------------------------------------------------------------------- #
def test_express_channels_are_overflow_resources_of_one_hop():
    """On a 2 x 2 express package (link 4 cycles), the channels (1, 0) ->
    (0, 0) and (1, 1) -> (0, 0): (1, 0) is an in-mesh unit step, so it
    takes the flat link id, and (1, 1) is not, so it takes its own
    overflow key.  A packet pays one package hop: 2 NI crossings, 2
    router pipelines, one link and its tail; two packets into the root at
    once contend only at its ejection port (one more packet length); each
    is the reference's latency."""
    hmesh = th.HierarchicalMesh(chips_x=2, chips_y=2, package="express")
    pkg = hmesh.package_cfg(NocConfig())
    assert pkg.link_cycles == 4 and (pkg.width, pkg.height) == (2, 2)
    unit, _ = path_link_ids(2, 2, ((1, 0), (0, 0)))
    diag, links = path_link_ids(2, 2, ((1, 1), (0, 0)))
    assert type(unit[0]) is int and diag == links == (((1, 1), (0, 0)),)
    flits = 5
    one = 2 * pkg.ni_cycles + 2 * pkg.router_cycles + pkg.link_cycles \
        + flits - 1
    jpkg = jh.HierarchicalMesh(chips_x=2, chips_y=2,
                               package="express").package_cfg(JNocConfig())
    for srcs, want in ((((1, 1),), one), (((1, 0),), one),
                       (((1, 0), (1, 1)), one + flits)):
        prog = [PacketOp(s, (0, 0), flits, path=[s, (0, 0)]) for s in srcs]
        jprog = [jschedule.PacketOp(s, (0, 0), flits, path=[s, (0, 0)])
                 for s in srcs]
        got = run_program(prog, pkg)
        assert got.latency_cycles == want, srcs
        assert got.latency_cycles == jrun_program(jprog, jpkg).latency_cycles
        assert got.ledger.packet_hops == len(srcs)


# --------------------------------------------------------------------------- #
# the cost facade
# --------------------------------------------------------------------------- #
def _cost_tuple(c):
    return (c.op, c.algorithm, c.semantics, c.participants, c.payload_bits,
            c.latency_cycles, c.energy_pj, c.packets)


@pytest.mark.parametrize("package", th.PACKAGE_VARIANTS)
def test_hier_collective_cost_equals_the_reference(package):
    for grid in ((1, 1), (2, 1), (2, 2)):
        kw = {"chip_w": 4, "chip_h": 4, "chips_x": grid[0],
              "chips_y": grid[1], "package": package}
        for op in th.HIER_OPS:
            for semantics in ("ina", "eject_inject"):
                got = th.hier_collective_cost(
                    op, th.HierarchicalMesh(**kw), 4096.0, CFG4,
                    semantics=semantics)
                want = jh.hier_collective_cost(
                    op, jh.HierarchicalMesh(**kw), 4096.0, JCFG4,
                    semantics=semantics)
                assert dataclasses.astuple(got) == \
                    dataclasses.astuple(want), (grid, op, semantics)


@pytest.mark.parametrize("phase", list(PAYLOADS))
@pytest.mark.parametrize("package", th.PACKAGE_VARIANTS)
def test_hier_psum_costs_and_choice_equal_the_reference(package, phase):
    nbytes = PAYLOADS[phase]
    for p in (2, 3, 4, 8, 16):
        for chips in (2, 3, 4):
            got = th.hier_psum_mode_costs(p, nbytes, chips=chips,
                                          package=package)
            want = jh.hier_psum_mode_costs(p, nbytes, chips=chips,
                                           package=package)
            assert {m: _cost_tuple(c) for m, c in got.items()} == \
                {m: _cost_tuple(c) for m, c in want.items()}, (p, chips)
            for objective in ("latency", "energy"):
                assert th.choose_hier_psum_mode(
                    p, nbytes, chips=chips, package=package,
                    objective=objective) == jh.choose_hier_psum_mode(
                        p, nbytes, chips=chips, package=package,
                        objective=objective), (p, chips, objective)


def test_one_chip_psum_costs_are_the_flat_ones():
    from repro_torch.core.noc.collective.cost import psum_mode_costs
    assert th.hier_psum_mode_costs(8, 4096, chips=1) == \
        psum_mode_costs(8, 4096)
    assert th.choose_hier_psum_mode(1, 4096, chips=4) == "ina"


def test_chip_round_cost_equals_the_reference():
    for chips in (1, 2, 3, 4):
        for package in th.PACKAGE_VARIANTS:
            for semantics in ("ina", "eject_inject"):
                assert th.chip_round_cost(
                    65536.0, chips, package=package, semantics=semantics) \
                    == jh.chip_round_cost(65536.0, chips, package=package,
                                          semantics=semantics)
    assert th.square_hier_mesh(8) == dataclasses.replace(
        th.HierarchicalMesh(), chips_x=4, chips_y=2)
    assert hier_cache_key_count() > 0        # the express lanes, memoized


# --------------------------------------------------------------------------- #
# mutations: the reference's findings
# --------------------------------------------------------------------------- #
def _mutate_lane(sched, level_name, fn, lane_idx=0):
    levels = []
    for level in sched.levels:
        lanes = list(level.lanes)
        if level.name == level_name:
            lanes[lane_idx] = fn(lanes[lane_idx])
        levels.append(dataclasses.replace(level, lanes=tuple(lanes)))
    return dataclasses.replace(sched, levels=tuple(levels))


def _mutate_op(lane, idx, **changes):
    prog = list(lane.prog)
    prog[idx] = dataclasses.replace(prog[idx], **changes)
    return dataclasses.replace(lane, prog=tuple(prog))


def _first_routed(lane):
    return next(i for i, op in enumerate(lane.prog) if op.flits)


def _escape(sched):
    lane = sched.levels[0].lanes[0]
    i = _first_routed(lane)
    return _mutate_lane(sched, "intra-reduce",
                        lambda ln: _mutate_op(ln, i, dst=(4, 0), path=None))


def _detour(sched):
    lane = next(lv for lv in sched.levels if lv.name == "package").lanes[0]
    i = _first_routed(lane)
    op = lane.prog[i]
    detour = [tuple(op.src), (op.src[0], 1 - op.src[1]), tuple(op.dst)]
    return _mutate_lane(sched, "package",
                        lambda ln: _mutate_op(ln, i, path=detour))


def _off_grid(sched):
    lane = next(lv for lv in sched.levels if lv.name == "package").lanes[0]
    i = _first_routed(lane)
    dst = tuple(lane.prog[i].dst)
    return _mutate_lane(sched, "package",
                        lambda ln: _mutate_op(ln, i, src=(5, 5),
                                              path=[(5, 5), dst]))


def _drop_lane(sched):
    return dataclasses.replace(sched, levels=tuple(
        dataclasses.replace(lv, lanes=lv.lanes[1:])
        if lv.name == "intra-reduce" else lv for lv in sched.levels))


def _drop_contrib(sched):
    lane = sched.levels[0].lanes[0]
    last = len(lane.prog) - 1
    acc = sorted(lane.prog[last].contribs)
    return _mutate_lane(
        sched, "intra-reduce",
        lambda ln: _mutate_op(ln, last, contribs=frozenset(acc[:-1])))


#: name -> (hierarchy keywords, mutation, the check it must raise)
MUTATIONS = {
    "chip-boundary-escape": ({"package": "mesh"}, _escape, "hier-route"),
    "express-detour": ({"package": "express", "chips_y": 2}, _detour,
                       "hier-route"),
    "express-off-grid": ({"package": "express", "chips_y": 2}, _off_grid,
                         "hier-route"),
    "dropped-chip-lane": ({"package": "mesh", "chips_y": 2}, _drop_lane,
                          "hier-fold"),
    "dropped-contribution": ({"package": "mesh"}, _drop_contrib,
                             "hier-fold"),
}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_mutation_findings_equal_the_reference(name):
    kw, mutate, check = MUTATIONS[name]
    case = {"chip_w": 4, "chip_h": 4, "chips_x": 2, **kw}
    got, want = _pair("reduce", case, 2048.0)
    found = verify_hier_schedule(mutate(got))
    assert check in {f.check for f in found}
    assert _where(found) == _where(jverify.verify_hier_schedule(mutate(want)))


RING = [[(0, 0), (1, 0), (1, 1)], [(1, 0), (1, 1), (0, 1)],
        [(1, 1), (0, 1), (0, 0)], [(0, 1), (0, 0), (1, 0)]]


@pytest.mark.parametrize("split", [False, True])
def test_turning_ring_and_per_chip_channels_equal_the_reference(split):
    """The four turning ops on one chip close a channel cycle; split over
    two chips they share no link, so the two-level CDG sees none."""
    found = []
    for mod, cls, cfg in ((th, PacketOp, CFG4),
                          (jh, jschedule.PacketOp, JCFG4)):
        ops = [cls(p[0], p[-1], 4, path=list(p), tag="ring") for p in RING]
        if not split:
            sched = mod.flat_hier_schedule(
                mod.HierarchicalMesh(chip_w=4, chip_h=4), ops, cfg)
        else:
            hmesh = mod.HierarchicalMesh(chip_w=4, chip_h=4, chips_x=2)
            lanes = tuple(
                mod.HierLane(label=f"chip{c}", scope="chip",
                             cfg=hmesh.chip_cfg(cfg), prog=tuple(ops[c::2]),
                             chip=c) for c in (0, 1))
            sched = mod.HierarchicalSchedule(
                hmesh=hmesh, op="flat", semantics="ina",
                algorithm="reduce_bcast", payload_bits=0.0,
                levels=(mod.HierLevel("flat", lanes),))
        verify = verify_hier_schedule if mod is th \
            else jverify.verify_hier_schedule
        found.append(verify(sched))
    assert ("cdg-deadlock" in {f.check for f in found[0]}) is not split
    assert _where(found[0]) == _where(found[1])


# --------------------------------------------------------------------------- #
# the mapper's package axis
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("package", th.PACKAGE_VARIANTS)
def test_multichip_evaluation_equals_the_reference(package):
    layers = transformer_gemms(ARCHS[QWEN2], 2)
    jlayers = jtransformer_gemms(JARCHS[QWEN2], 2)
    for layer, jlayer in zip(layers, jlayers):
        for chips in (2, 4):
            got = evaluate_mapping(layer, Mapping(chips=chips), CFG4,
                                   sim_rounds=4, package=package)
            want = jevaluate_mapping(jlayer, JMapping(chips=chips), JCFG4,
                                     sim_rounds=4, package=package)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            flat = evaluate_mapping(layer, Mapping(), CFG4, sim_rounds=4)
            assert got.noc_energy_pj > flat.noc_energy_pj


@pytest.mark.parametrize("package", th.PACKAGE_VARIANTS)
def test_chips_list_search_equals_the_reference(package):
    mcfg = dataclasses.replace(QUICK_MAPPER, chips_list=(1, 2, 4),
                               package=package)
    jmcfg = dataclasses.replace(JQUICK_MAPPER, chips_list=(1, 2, 4),
                                package=package)
    got = search_network("q", transformer_gemms(ARCHS[QWEN2], 2), mcfg,
                         debug=True)
    want = jsearch_network("q", jtransformer_gemms(JARCHS[QWEN2], 2), jmcfg,
                           debug=True)
    assert got.best.to_dict() == want.best.to_dict()
    assert got.baseline.to_dict() == want.baseline.to_dict()
    assert [s.to_dict() for s in got.pareto] == \
        [s.to_dict() for s in want.pareto]
    assert got.stats["hardware_evaluated"] == \
        want.stats["hardware_evaluated"] == 24
    # chip_smoke.py's [plan] holds the card's search to these
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.MAPPER_CHIPS_LIST == (1, 2, 4)
    assert cs.MAPPER_CHIPS[package] == (want.best.hardware,
                                        want.best.latency_cycles,
                                        want.best.total_energy_pj)
