"""The port's static verifiers (``repro_torch.analysis.verify``) against the
reference's (``repro.analysis.verify``).

* every ``collective_cases()`` program and every quick WS plan shape that
  the port's planners emit verifies clean;
* under each seeded mutation of ``tests/test_analysis.py`` (a dropped dep
  edge, a duplicated contribution, a diagonal route step, a forward dep,
  a ring of turning overrides) the port's findings equal the reference's
  on the same mutated program, check id and where, and
  ``run_program(verify=True)`` raises where the program is broken;
* the mapper schedule: ``NetworkSchedule.to_dict``/``from_dict`` round
  trip, read by the reference's ``from_dict`` too; ``programs()`` re-emits
  the reference's ops at one and two chips; ``verify_schedule`` finds what
  the reference's finds on a tampered schedule, and
  ``search_network(debug=True)`` returns the ``debug=False`` outcome and
  raises on a winner whose programs are broken;
* the paged-KV verifiers find what the reference's find, and the
  ``check()`` methods raise the messages they raised before.
"""
import copy
import dataclasses

import pytest

from repro.analysis import verify as jverify
from repro.analysis.corpus import collective_cases, ws_plan_shapes
from repro.configs import ARCHS as JARCHS
from repro.core.noc.collective import schedule as jschedule
from repro.core.noc.router import NocConfig as JNocConfig
from repro.core.ops import transformer_gemms as jtransformer_gemms
from repro.mapper.schedule import NetworkSchedule as JNetworkSchedule

from repro_torch.analysis import (VerificationError, check_program,
                                  verify_allocator, verify_collective,
                                  verify_kvcache, verify_program,
                                  verify_schedule)
from repro_torch.analysis.verify import _phase_of_tag
from repro_torch.configs import ARCHS
from repro_torch.core.noc.collective.engine import run_program
from repro_torch.core.noc.collective.schedule import (PacketOp,
                                                      plan_collective,
                                                      ws_round_program)
from repro_torch.core.noc.router import NocConfig
from repro_torch.core.ops import transformer_gemms
from repro_torch.mapper import QUICK_MAPPER, NetworkSchedule, search_network
from repro_torch.mapper import schedule as mschedule

CFG4, JCFG4 = NocConfig(n=4), JNocConfig(n=4)
QWEN2 = "qwen2-1.5b"


def _where(findings):
    """(check, where) of each finding, in order."""
    return [(f.check, f.where) for f in findings]


def _ops(prog):
    return [dataclasses.asdict(o) for o in prog]


# --------------------------------------------------------------------------- #
# the corpora verify clean
# --------------------------------------------------------------------------- #
CASES = list(collective_cases())


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c['label']}-{c['op']}-{c['semantics']}-{c['algorithm']}"
    for c in CASES])
def test_collective_corpus_verifies_clean(case):
    prog = plan_collective(case["op"], case["participants"], 512.0, CFG4,
                           algorithm=case["algorithm"],
                           semantics=case["semantics"])
    jprog = jschedule.plan_collective(
        case["op"], case["participants"], 512.0, JCFG4,
        algorithm=case["algorithm"], semantics=case["semantics"])
    assert _ops(prog) == _ops(jprog)
    assert verify_program(prog, CFG4) == []
    assert verify_collective(
        prog, op=case["op"], participants=case["participants"],
        algorithm=case["algorithm"], semantics=case["semantics"]) == []


def test_ws_corpus_verifies_clean():
    shapes = ws_plan_shapes(quick=True)
    assert len(shapes) == 22
    cfg = NocConfig()
    for shape in shapes:
        prog = ws_round_program(
            cfg, shape["mode"], 2, g=shape["g"], p=shape["p"],
            gather_flits=shape["gather_flits"],
            unicast_flits=shape["unicast_flits"], e_pes=shape["e_pes"])
        assert verify_program(prog, cfg) == [], shape


# --------------------------------------------------------------------------- #
# seeded mutations: the reference's findings, op for op
# --------------------------------------------------------------------------- #
def _allreduce(plan):
    """The 4 x 4 allreduce of ``tests/test_analysis.py`` from ``plan``."""
    parts = [(x, y) for x in range(4) for y in range(4)]
    cfg = CFG4 if plan is plan_collective else JCFG4
    return parts, copy.deepcopy(plan("allreduce", parts, 512.0, cfg))


def _first_ws(emit, cfg):
    shape = ws_plan_shapes(quick=True)[0]
    return copy.deepcopy(emit(
        cfg, shape["mode"], 2, g=shape["g"], p=shape["p"],
        gather_flits=shape["gather_flits"],
        unicast_flits=shape["unicast_flits"], e_pes=shape["e_pes"]))


def _drop_dep(prog):
    for i, o in enumerate(prog):
        if _phase_of_tag(o.tag) != "reduce" or not o.deps:
            continue
        for d in o.deps:
            od = prog[d]
            if (_phase_of_tag(od.tag) == "reduce" and od.chunk == o.chunk
                    and od.contribs and od.contribs < o.contribs):
                prog[i].deps = tuple(x for x in o.deps if x != d)
                return
    raise AssertionError("no droppable reduce dep")


def _duplicate_contrib(prog):
    reduce_ops = [i for i, o in enumerate(prog)
                  if _phase_of_tag(o.tag) == "reduce" and o.contribs]
    donor = reduce_ops[0]
    p = min(prog[donor].contribs)
    victim = next(i for i in reduce_ops
                  if i != donor and prog[i].chunk == prog[donor].chunk
                  and p not in prog[i].contribs)
    prog[victim].contribs = prog[victim].contribs | {p}


def _diagonal(prog):
    i = next(i for i, o in enumerate(prog)
             if o.flits > 0 and abs(o.src[0] - o.dst[0])
             + abs(o.src[1] - o.dst[1]) >= 2)
    prog[i].path = [tuple(prog[i].src), tuple(prog[i].dst)]


def _forward_dep(prog):
    prog[0].deps = (len(prog) - 1,)


RING = [[(0, 0), (1, 0), (1, 1)], [(1, 0), (1, 1), (0, 1)],
        [(1, 1), (0, 1), (0, 0)], [(0, 1), (0, 0), (1, 0)]]


def _mutated(kind: str, port: bool):
    """(program, cfg, collective kw or None) of one mutation, built in the
    port (``port``) or in the reference."""
    plan = plan_collective if port else jschedule.plan_collective
    emit = ws_round_program if port else jschedule.ws_round_program
    op_cls = PacketOp if port else jschedule.PacketOp
    cfg_cls = NocConfig if port else JNocConfig
    if kind in ("dropped-dep", "duplicated-contrib"):
        parts, prog = _allreduce(plan)
        (_drop_dep if kind == "dropped-dep" else _duplicate_contrib)(prog)
        return prog, cfg_cls(n=4), {"op": "allreduce", "participants": parts}
    if kind in ("diagonal-step", "forward-dep"):
        cfg = cfg_cls()
        prog = _first_ws(emit, cfg)
        (_diagonal if kind == "diagonal-step" else _forward_dep)(prog)
        return prog, cfg, None
    assert kind == "cyclic-overrides"
    return ([op_cls(src=p[0], dst=p[-1], flits=2, path=list(p), tag="mut")
             for p in RING], cfg_cls(n=2), None)


MUTATIONS = {"dropped-dep": {"collective-fold"},
             "duplicated-contrib": {"collective-fold"},
             "diagonal-step": {"route"}, "forward-dep": {"dep-dag"},
             "cyclic-overrides": {"cdg-deadlock"}}


@pytest.mark.parametrize("kind", list(MUTATIONS))
def test_mutation_findings_equal_the_reference(kind):
    prog, cfg, coll = _mutated(kind, port=True)
    jprog, jcfg, _ = _mutated(kind, port=False)
    got = verify_program(prog, cfg)
    want = jverify.verify_program(jprog, jcfg)
    if coll is not None:
        got += verify_collective(prog, **coll)
        want += jverify.verify_collective(jprog, **coll)
    assert got and {f.check for f in got} == MUTATIONS[kind]
    assert _where(got) == _where(want)
    if kind == "duplicated-contrib":
        p = min(_allreduce(plan_collective)[1][0].contribs)
        assert any(str(p) in f.message for f in got)
    if kind == "cyclic-overrides":
        assert "cycle" in got[0].message
        for op in prog:                 # the XY twins are acyclic
            op.path = None
        assert verify_program(prog, cfg) == []


def test_broken_program_raises_before_it_runs():
    prog, cfg, _ = _mutated("forward-dep", port=True)
    with pytest.raises(VerificationError) as exc:
        check_program(prog, cfg)
    assert any(f.check == "dep-dag" for f in exc.value.findings)
    with pytest.raises(VerificationError):
        run_program(prog, cfg, verify=True)
    parts, prog = _allreduce(plan_collective)
    _drop_dep(prog)
    with pytest.raises(VerificationError, match="collective-fold"):
        check_program(prog, CFG4, op="allreduce", participants=parts)


def test_valid_program_runs_with_verify_hook():
    parts, prog = _allreduce(plan_collective)
    res = run_program(prog, CFG4, verify=True)
    assert res.latency_cycles == run_program(prog, CFG4).latency_cycles > 0


# --------------------------------------------------------------------------- #
# mapper schedules
# --------------------------------------------------------------------------- #
def _search(**kw):
    layers = transformer_gemms(ARCHS[QWEN2], 2)
    return layers, search_network("qwen2:gemm", layers, QUICK_MAPPER, **kw)


def test_search_debug_returns_the_outcome_of_no_debug():
    layers, plain = _search()
    _, checked = _search(debug=True)
    assert checked.best == plain.best and checked.baseline == plain.baseline
    assert checked.pareto == plain.pareto
    assert verify_schedule(checked.best, layers) == []


def test_schedule_round_trips_through_json_in_both_packages():
    import json
    _, out = _search()
    doc = json.loads(json.dumps(out.best.to_dict()))
    assert NetworkSchedule.from_dict(doc) == out.best
    assert JNetworkSchedule.from_dict(doc).to_dict() == out.best.to_dict()


@pytest.mark.parametrize("chips", [1, 2])
def test_programs_equal_the_reference(chips):
    """The winner's assignments at ``chips`` (every mapping's chips set to
    it) re-emit the reference's (layer, cfg, ops), one round and a window
    of 3."""
    layers, out = _search()
    sched = dataclasses.replace(out.best, assignments=tuple(
        dataclasses.replace(a, mapping=dataclasses.replace(a.mapping,
                                                           chips=chips))
        for a in out.best.assignments))
    jsched = JNetworkSchedule.from_dict(sched.to_dict())
    jlayers = jtransformer_gemms(JARCHS[QWEN2], 2)
    for window in (None, 3):
        got = list(sched.programs(layers, window=window))
        want = list(jsched.programs(jlayers, window=window))
        assert len(got) == len(want) == len(layers)
        for (name, cfg, prog), (jname, jcfg, jprog) in zip(got, want):
            assert name == jname
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert _ops(prog) == _ops(jprog)
            assert verify_program(prog, cfg) == []


def test_tampered_schedule_findings_equal_the_reference():
    layers, out = _search()
    a = out.best.assignments[0]
    bad = dataclasses.replace(out.best, assignments=(
        dataclasses.replace(a, layer="no-such-layer"),
        *out.best.assignments[1:]))
    got = verify_schedule(bad, layers)
    want = jverify.verify_schedule(JNetworkSchedule.from_dict(bad.to_dict()),
                                   jtransformer_gemms(JARCHS[QWEN2], 2))
    assert got and {f.check for f in got} == {"plan-gemm"}
    assert _where(got) == _where(want)


def test_search_debug_raises_on_a_broken_winner(monkeypatch):
    """A winner whose re-emitted programs carry a diagonal step raises
    ``VerificationError`` naming the layer; the search itself is
    unchanged."""
    def broken(*args, **kw):
        prog = ws_round_program(*args, **kw)
        _diagonal(prog)
        return prog
    monkeypatch.setattr(mschedule, "ws_round_program", broken)
    layers, _ = _search()
    with pytest.raises(VerificationError) as exc:
        _search(debug=True)
    assert {f.check for f in exc.value.findings} == {"route"}
    assert exc.value.findings[0].where.startswith(f"{layers[0].name}: op ")


# --------------------------------------------------------------------------- #
# the paged-KV free list
# --------------------------------------------------------------------------- #
def _allocators(cls):
    """Each mutation of the reference's kvcache test on an allocator of
    ``cls``: (name, allocator)."""
    clean = cls(8)
    clean.alloc("a", 3)
    aliased = cls(8)
    aliased.alloc("a", 3)
    aliased.tables["b"] = [aliased.tables["a"][0]]
    leaked = cls(8)
    leaked.alloc("a", 3)
    leaked._free.append(leaked.tables["a"][0])
    ranged = cls(8)
    ranged._free.append(99)
    twice = cls(4)
    twice._free.append(twice._free[0])
    return [("clean", clean), ("aliased", aliased), ("leaked", leaked),
            ("ranged", ranged), ("twice", twice)]


def test_allocator_findings_equal_the_reference():
    from repro.serve.kvcache import BlockAllocator as JBlockAllocator
    from repro_torch.serve.kvcache import BlockAllocator
    for (name, alloc), (_, jalloc) in zip(_allocators(BlockAllocator),
                                          _allocators(JBlockAllocator)):
        got = verify_allocator(alloc)
        assert [dataclasses.astuple(f) for f in got] == \
            [dataclasses.astuple(f) for f in
             jverify.verify_allocator(jalloc)], name
        assert (got == []) == (name == "clean")
        assert all(f.check == "kvcache" for f in got)
    with pytest.raises(AssertionError, match=r"^table 'b': block \d aliased"):
        dict(_allocators(BlockAllocator))["aliased"].check()


def test_kvcache_findings_name_the_bookkeeping():
    """Lengths and states out of step with the block tables, and a length
    its table does not cover: the messages ``check()`` raised before."""
    from repro_torch.serve.kvcache import PagedKVCache
    kv = PagedKVCache(ARCHS[QWEN2].reduced(), 8, 4, 4, device="cpu")
    kv.check()
    assert verify_kvcache(kv) == []
    kv.allocator.alloc("r", 1)
    kv._length["r"] = 6
    kv._state["r"] = {}
    found = verify_kvcache(kv)
    assert _where(found) == [("kvcache", "request 'r'")]
    with pytest.raises(AssertionError, match="^request 'r': length 6 needs 2 "
                                             "blocks but the table holds 1$"):
        kv.check()
    del kv._state["r"]
    with pytest.raises(AssertionError, match=r"^state keys disagree with "
                                             r"block tables \(difference: "
                                             r"\['r'\]\)"):
        kv.check()
