"""The port's compiled and vectorized NoC executors
(``repro_torch.core.noc.compiled`` / ``vectorized``, ``run_program``'s
``engine=``) against the reference's heap engine, on the CPU, exactly.

* ``run_program`` under ``heap``, ``compiled``, ``vectorized`` and ``auto``
  gives the reference heap engine's latency, ledger, ``done`` and
  ``delivered`` on the reference's corpora (``collective_programs``,
  ``ws_programs(quick=True)``, the lanes of ``hier_schedules(quick=True)``)
  and the faulted ones; ``UncompilableProgram`` and
  ``UnvectorizableProgram`` come on the reference's programs;
* ``VECTOR_STATS`` equals the reference's after the same calls;
* the batched window pass under ``set_array_backend("torch",
  device="cpu")`` fills the store bit for bit as numpy, the reference and
  the heap engine do (``tests/test_torch_noc_backend.py`` holds the
  backend's refusal without a card, and its run on one);
* ``verify_compiled``'s findings equal the reference's;
* ``python -m repro_torch.experiments`` writes the reference's artifacts
  under each ``--engine`` and ``--no-cache``, equal across them;
* ``chip_smoke.py``'s ``[noc]`` phase runs here on the CPU.
"""
import dataclasses
import functools
import importlib.util
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from repro.analysis import corpus as jcorpus
from repro.analysis import verify as jverify
from repro.core.noc import simcache as jsimcache
from repro.core.noc import vectorized as jvec
from repro.core.noc.collective.engine import run_program as jrun_program
from repro.core.noc.compiled import UncompilableProgram as JUncompilable
from repro.core.noc.compiled import compile_program as jcompile_program
from repro.core.noc.hierarchy import run_hier_schedule as jrun_hier
from repro.core.noc.router import NocConfig as JNocConfig
from repro.experiments import __main__ as jexperiments

import _torch_ref_plans as R
from repro_torch.analysis import corpus, verify
from repro_torch.core.noc import SIM_CACHE, simcache
from repro_torch.core.noc import vectorized as vec
from repro_torch.core.noc.collective.engine import ENGINES, run_program
from repro_torch.core.noc.compiled import (UncompilableProgram,
                                           compile_program)
from repro_torch.core.noc.hierarchy import run_hier_schedule
from repro_torch.core.noc.simulator import NocSim
from repro_torch.experiments import __main__ as experiments

ROOT = Path(__file__).resolve().parents[1]


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ops(prog):
    return [dataclasses.asdict(o) for o in prog]


def _jcfg(cfg):
    return JNocConfig(**dataclasses.asdict(cfg))


def _result(res):
    return (res.latency_cycles, res.ledger.as_tuple(), res.done,
            res.delivered)


def _lanes(sched):
    return [(f"{level.name} {lane.label}", lane.cfg, list(lane.prog))
            for level, lane in sched.all_lanes()]


def _corpus(name: str) -> list:
    """``(label, cfg, port program, reference program)`` of a corpus."""
    if name == "collective":
        pairs = zip(corpus.collective_programs(),
                    jcorpus.collective_programs())
        return [(f"{c['label']} {c['op']} {c['semantics']} "
                 f"{c['algorithm']}", cfg, p, jp)
                for (c, cfg, p), (_, _, jp) in pairs]
    if name == "ws":
        pairs = zip(corpus.ws_programs(quick=True),
                    jcorpus.ws_programs(quick=True))
        return [(f"{s['mode']} g{s['g']} p{s['p']} e{s['e_pes']}", cfg, p, jp)
                for (s, cfg, p), (_, _, jp) in pairs]
    if name == "faulted":
        pairs = zip(corpus.faulted_collective_programs(quick=True),
                    jcorpus.faulted_collective_programs(quick=True))
        return [(f"{c['label']} {c['op']} {c['semantics']} "
                 f"{c['algorithm']}", cfg, p, jp)
                for (c, cfg, _, p), (_, _, _, jp) in pairs]
    if name == "hier":
        scheds = zip(corpus.hier_schedules(quick=True),
                     jcorpus.hier_schedules(quick=True))
        scheds = [(c, s, js) for (c, s), (_, js) in scheds]
    else:
        scheds = zip(corpus.faulted_hier_schedules(quick=True),
                     jcorpus.faulted_hier_schedules(quick=True))
        scheds = [(c, s, js) for (c, _, s), (_, _, js) in scheds]
    out = []
    for case, sched, jsched in scheds:
        for (label, cfg, prog), (_, _, jprog) in zip(_lanes(sched),
                                                     _lanes(jsched)):
            out.append((f"{case} {label}", cfg, prog, jprog))
    return out


CORPORA = ("collective", "ws", "hier", "faulted", "faulted_hier")


@pytest.mark.parametrize("name", CORPORA)
def test_every_engine_gives_the_reference_heap_result(name):
    """Each program: the reference's op for op, and under every engine the
    reference heap engine's result; a forced engine refuses exactly the
    programs the reference's compiler or lowering refuses."""
    cases = _corpus(name)
    assert cases
    refused = {"compiled": 0, "vectorized": 0}
    for label, cfg, prog, jprog in cases:
        assert _ops(prog) == _ops(jprog), label
        jcfg = _jcfg(cfg)
        want = _result(jrun_program(jprog, jcfg, engine="heap"))
        try:
            jcompile_program(jprog, jcfg)
            ref_compiles = True
        except JUncompilable:
            ref_compiles = False
        try:
            jvec.lower_program(jprog, jcfg)
            ref_lowers = True
        except jvec.UnvectorizableProgram:
            ref_lowers = False
        for engine in ENGINES:
            forced = {"compiled": ref_compiles,
                      "vectorized": ref_lowers}.get(engine, True)
            if not forced:
                refused[engine] += 1
                with pytest.raises(UncompilableProgram if engine ==
                                   "compiled" else vec.UnvectorizableProgram):
                    run_program(prog, cfg, engine=engine)
                continue
            assert _result(run_program(prog, cfg, engine=engine)) == want, \
                (label, engine)
    if name == "collective":        # eject-inject trees contend: no K3
        assert refused["vectorized"] and not refused["compiled"]


@pytest.mark.parametrize("name", ["hier", "faulted_hier"])
def test_hier_schedules_replay_equal_under_every_engine(name):
    scheds = (zip(corpus.hier_schedules(quick=True),
                  jcorpus.hier_schedules(quick=True)) if name == "hier"
              else ((s[::2], j[::2]) for s, j in zip(
                  corpus.faulted_hier_schedules(quick=True),
                  jcorpus.faulted_hier_schedules(quick=True))))
    for (case, sched), (_, jsched) in scheds:
        want = jrun_hier(jsched, engine="heap")
        for engine in ("heap", "auto"):
            got = run_hier_schedule(sched, engine=engine)
            assert (got.latency_cycles, got.ledger.as_tuple(),
                    got.level_latency) == \
                (want.latency_cycles, want.ledger.as_tuple(),
                 want.level_latency), (case, engine)


def test_run_program_engine_argument():
    cfg = corpus.NocConfig(n=4)
    prog = next(corpus.collective_programs(cfg))[2]
    with pytest.raises(ValueError, match="engine"):
        run_program(prog, cfg, engine="fastest")
    for engine in ("vectorized", "compiled"):
        with pytest.raises(ValueError, match="simulator"):
            run_program(prog, cfg, sim=NocSim(cfg), engine=engine)
    # a packet off the 4 x 4 mesh: neither package compiles or lowers it,
    # and auto falls back to the heap engine's (the reference's) result
    from repro.core.noc.collective.schedule import PacketOp as JPacketOp
    from repro_torch.core.noc.collective.schedule import PacketOp
    off = [PacketOp(src=(0, 0), dst=(5, 0), flits=3)]
    joff = [JPacketOp(src=(0, 0), dst=(5, 0), flits=3)]
    with pytest.raises(JUncompilable):
        jcompile_program(joff, JNocConfig(n=4))
    for engine, refusal in (("compiled", UncompilableProgram),
                            ("vectorized", vec.UnvectorizableProgram)):
        with pytest.raises(refusal):
            run_program(off, cfg, engine=engine)
    assert _result(run_program(off, cfg)) == \
        _result(jrun_program(joff, JNocConfig(n=4), engine="heap"))
    heap = run_program(prog, cfg, engine="heap")
    for engine in ENGINES:                   # t0 shifts every engine alike
        res = run_program(prog, cfg, engine=engine, t0=7)
        assert res.latency_cycles == heap.latency_cycles + 7, engine
        assert res.done == [d + 7 for d in heap.done], engine


# --------------------------------------------------------------------------- #
# VECTOR_STATS and the batched window pass
# --------------------------------------------------------------------------- #
def _window_keys(shapes, cfg):
    return [(cfg, s["mode"], window, s["g"], s["p"], s["gather_flits"],
             s["unicast_flits"], s["e_pes"])
            for s in shapes for window in (1, 2, 8)]


def _jkey(key):
    return (_jcfg(key[0]),) + tuple(key[1:])


def test_vector_stats_match_reference():
    """The same calls in both packages (auto runs of the clean and faulted
    collective corpora, every fig shape's window results, one batched
    prefetch) leave the same counters."""
    keys = _window_keys(corpus.ws_plan_shapes(quick=True),
                        corpus.NocConfig())
    vec.reset_vector_stats()
    jvec.reset_vector_stats()
    with R.fresh_state():
        for name in ("collective", "faulted"):
            for _, cfg, prog, jprog in _corpus(name):
                run_program(prog, cfg)
                jrun_program(jprog, _jcfg(cfg))
        for key in keys[::2]:
            got = vec.window_result(*key)
            want = jvec.window_result(*_jkey(key))
            assert (got is None) == (want is None), key
            if got is not None:
                assert (got[0], got[1].as_tuple()) == \
                    (want[0], want[1].as_tuple()), key
        assert vec.prefetch_windows(keys) == \
            jvec.prefetch_windows([_jkey(k) for k in keys])
    got, want = vec.vector_stats(), jvec.vector_stats()
    assert got == want
    assert got["windows_batched"] and got["programs_lowered"] and \
        got["columns_replayed"] and got["fallbacks"]


def _entries(store):
    return {repr(k[1:]): (lat.hex(), tuple(float(c).hex()
                                           for c in led.as_tuple()))
            for k, (lat, led) in store.export().items()}


def test_torch_backend_on_the_cpu_fills_the_store_as_numpy():
    """``set_array_backend("torch", device="cpu")``: the batched pass's
    entries bit for bit the numpy backend's and the reference's over the
    window keys of every fig shape, and, through ``chip_smoke.py``'s
    ``[noc]`` check, over a quick mapper search's keys against the heap
    engine too."""
    keys = _window_keys(corpus.ws_plan_shapes(quick=True),
                        corpus.NocConfig())
    runs = {}
    for backend in ("numpy", "torch"):
        assert vec.set_array_backend(backend, device="cpu") == backend
        try:
            vec.reset_vector_stats()
            with R.fresh_state():
                vec.prefetch_windows(keys)
                runs[backend] = (_entries(SIM_CACHE),
                                 vec.VECTOR_STATS["windows_batched"])
        finally:
            vec.set_array_backend("numpy")
    with R.fresh_state():
        jvec.prefetch_windows([_jkey(k) for k in keys])
        want = _entries(jsimcache.SIM_CACHE)
    assert runs["torch"] == runs["numpy"]
    assert runs["torch"][0] == want and runs["torch"][1] > 1
    assert vec._STATE["backend"] == "numpy"
    doc = _chip_smoke().noc_torch_backend("cpu", "cpu")
    assert doc["batched"] > 1 and doc["entries"] <= doc["keys"]


# --------------------------------------------------------------------------- #
# verify_compiled
# --------------------------------------------------------------------------- #
def _found(findings):
    return [(f.check, f.where, f.message) for f in findings]


def _mutations(compile_, prog, cfg):
    """The same corruptions of a compiled program or its source, made with
    ``compile_`` (either package's ``compile_program``)."""
    cp = compile_(prog, cfg)
    out = {"clean": (cp, prog)}
    i = next(i for i, o in enumerate(prog) if o.flits > 0 and o.deps)
    src = list(prog)
    src[i] = dataclasses.replace(prog[i], pe_adds=prog[i].pe_adds + 1)
    out["stale source"] = (cp, src)
    bad = compile_(prog, cfg)
    bad.children[prog[i].deps[0]] = ()
    bad.dep_count[i] += 1
    op = list(bad.ops[i])
    op[12] = (op[12][0],) + tuple(e + 1 for e in op[12][1:])
    op[7] = op[7][:-1]
    bad.ops[i] = tuple(op)
    out["tampered"] = (bad, prog)
    short = compile_(prog, cfg)
    short.children = short.children[:-1]
    out["lengths"] = (short, None)
    out["fewer source ops"] = (cp, prog[:-1])
    return out


def test_verify_compiled_findings_match_reference():
    """Clean over the collective and ws corpora in both packages; on a
    stale source op, tampered deps, children, links and energy, disagreeing
    array lengths and a short source, the reference's findings."""
    for name in ("collective", "ws"):
        for label, cfg, prog, jprog in _corpus(name):
            cp = compile_program(prog, cfg)
            assert verify.verify_compiled(cp, prog, cfg) == [], label
            assert verify.verify_compiled(cp) == []
    cfg = corpus.NocConfig(n=4)
    parts = [(x, y) for x in range(4) for y in range(4)]
    from repro.core.noc.collective.schedule import plan_collective as jplan
    from repro_torch.core.noc.collective.schedule import plan_collective
    prog = plan_collective("allreduce", parts, 512.0, cfg)
    jprog = jplan("allreduce", parts, 512.0, JNocConfig(n=4))
    got = _mutations(compile_program, prog, cfg)
    want = _mutations(jcompile_program, jprog, JNocConfig(n=4))
    for name, (cp, src) in got.items():
        jcp, jsrc = want[name]
        found = _found(verify.verify_compiled(cp, src, cfg))
        assert found == _found(jverify.verify_compiled(
            jcp, jsrc, JNocConfig(n=4))), name
        assert bool(found) == (name != "clean"), name


# --------------------------------------------------------------------------- #
# The experiments CLI's --engine and --no-cache, and chip_smoke's [noc]
# --------------------------------------------------------------------------- #
SECTIONS = "tables,fig7_9,mapper,faults"


def _cli(main, out: Path, *flags) -> dict:
    argv = ["--quick", "--sections", SECTIONS, "--out", str(out),
            "--no-persist", *flags]
    vec.reset_vector_stats()
    jvec.reset_vector_stats()
    with R.fresh_state(), redirect_stdout(io.StringIO()) as text:
        try:
            assert main(argv) == 0
        finally:
            simcache.configure(True)
            jsimcache.configure(True)
    summary = (out / "summary.md").read_text().split("## Run stats")[0]
    csv = [line.split(",", 2)
           for line in (out / "benchmarks.csv").read_text().splitlines()]
    return {"json": {s: json.loads((out / f"{s}.json").read_text())
                     for s in SECTIONS.split(",")},
            "summary": summary, "csv": [(r[0], r[2]) for r in csv],
            "stdout": text.getvalue().splitlines()}


def test_cli_engines_and_no_cache_write_the_reference_artifacts(tmp_path):
    """Each of ``--engine heap|compiled|vectorized|auto`` and
    ``--no-cache``: the reference's artifacts under the same flags (less
    wall clock), and the same results across flags (less the mapper's
    window-store lookups, which the prefetch and the heap engine's
    memo bypass change by design, as in the reference)."""
    cs = _chip_smoke()
    runs = {}
    for flags in (("--engine", "heap"), ("--engine", "compiled"),
                  ("--engine", "vectorized"), ("--engine", "auto"),
                  ("--no-cache",)):
        label = "-".join(f.strip("-") for f in flags)
        got = _cli(experiments.main, tmp_path / f"port-{label}", *flags)
        want = _cli(jexperiments.main, tmp_path / f"ref-{label}", *flags)
        for key in ("summary", "csv"):
            assert got[key] == want[key], (flags, key)
        assert {s: cs.noc_results(f) for s, f in got["json"].items()} == \
            {s: cs.noc_results(f) for s, f in want["json"].items()}
        assert _without_clock(got["json"]) == _without_clock(want["json"])
        assert got["stdout"][-1] == want["stdout"][-1]
        assert got["stdout"][-1].startswith("vectorized backend [on]")
        runs[label] = got
    base = {s: cs.noc_results(f) for s, f in runs["engine-heap"]["json"].items()}
    for label, got in runs.items():
        assert {s: cs.noc_results(f) for s, f in got["json"].items()} == \
            base, label
        assert got["summary"] == runs["engine-heap"]["summary"], label
    assert "cache: 0 entries" in runs["no-cache"]["stdout"][-2]
    assert SIM_CACHE.enabled and jsimcache.SIM_CACHE.enabled


def _without_clock(x):
    if isinstance(x, dict):
        return {k: _without_clock(v) for k, v in x.items()
                if k != "elapsed_us"}
    if isinstance(x, list):
        return [_without_clock(v) for v in x]
    return x


def test_chip_smoke_noc_phase_runs_on_the_cpu(tmp_path):
    """``[noc]``'s host parts: the four engines' sweeps equal, and the
    quick faulted corpora verified and equal under every engine that
    takes each program."""
    cs = _chip_smoke()
    seconds = cs.noc_sweeps(tmp_path)
    assert set(seconds) == set(cs.NOC_ENGINES)
    ran = cs.noc_faulted_corpus()
    assert ran["heap"] == ran["compiled"] == 42
    assert 0 < ran["vectorized"] < ran["heap"]
