"""The paper's evaluation in the port (``repro_torch.experiments``, the
workloads, ``simulate_network`` and the power model) against the
reference's, on the CPU.

* ``simulate_network`` for AlexNet, VGG-16 and ResNet-50 under each of the
  three dataflow modes at E 1 and 16 rounds equals the reference's, every
  layer's every field and the totals, exactly;
* ``ws_ina_improvement`` / ``ws_vs_os_improvement`` (Figs 7-9, 10-12)
  equal the reference's and the pins of ``tests/test_experiments.py``;
* each of the eight ported sections of ``run_all(QUICK_SWEEP)`` equals the
  reference's dict, and ``summary.md`` and ``benchmarks.csv`` equal the
  reference's; what is left out of each comparison is named at the test.

The reference runs its heap engine with its layer memo on, the port's one
configuration (its vectorized prefetch and compiled replay give the same
results but other window-store counters), and builds its plans on the
port's psum sites (``tests/_torch_ref_plans.py``).
"""
import dataclasses
import json

import pytest

import _torch_ref_plans as R
from repro.core.noc.compiled import compiled_disabled
from repro.core.noc.power import ws_ina_improvement as jws_ina
from repro.core.noc.power import ws_vs_os_improvement as jws_vs_os
from repro.core.noc.traffic import simulate_network as jsimulate_network
from repro.core.noc.vectorized import vectorized_disabled
from repro.core.workloads import WORKLOADS as JWORKLOADS
from repro.experiments import sweeps as jsweeps
from repro.mapper import search as jsearch

from repro_torch.core import workloads
from repro_torch.core.noc import NocConfig
from repro_torch.core.noc.power import (ws_ina_improvement,
                                        ws_vs_os_improvement)
from repro_torch.core.noc.traffic import MODES, simulate_network
from repro_torch.experiments import sweeps
from repro_torch.experiments.__main__ import main as experiments_main

from test_experiments import FIG7_9_PINS, FIG10_12_PINS

NETWORKS = ("alexnet", "vgg16", "resnet50")
SECTIONS = ("tables", "fig7_9", "fig10_12", "mesh_scaling", "hierarchy",
            "mapper", "plan", "serve")


# --------------------------------------------------------------------------- #
# Workloads, whole-network simulation, the power model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NETWORKS)
def test_workloads_match_reference(name):
    assert [dataclasses.astuple(l) for l in workloads.WORKLOADS[name]] == \
        [dataclasses.astuple(l) for l in JWORKLOADS[name]]
    from repro.core.workloads import full_workload as jfull
    assert [dataclasses.astuple(l) for l in workloads.full_workload(name)] \
        == [dataclasses.astuple(l) for l in jfull(name)]


def test_mapper_workloads_match_reference():
    from repro.core.workloads import mapper_workloads as jmapper_workloads
    got, want = workloads.mapper_workloads(), jmapper_workloads()
    assert list(got) == list(want)
    for key in want:
        assert [dataclasses.astuple(l) for l in got[key]] == \
            [dataclasses.astuple(l) for l in want[key]], key


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NETWORKS)
def test_simulate_network_matches_reference(name, mode):
    got = simulate_network(workloads.WORKLOADS[name], mode, NocConfig(), 1,
                           16)
    want = jsimulate_network(JWORKLOADS[name], mode,
                             jsweeps.NocConfig(), 1, 16)
    assert [dataclasses.asdict(r) for r in got.pop("layers")] == \
        [dataclasses.asdict(r) for r in want.pop("layers")]
    assert got == want


@pytest.mark.parametrize("name", NETWORKS)
def test_improvements_match_reference_and_pins(name):
    """Figs 7-9 and 10-12 at E 1, 16 rounds: the reference's values to the
    bit, and ``tests/test_experiments.py``'s pins."""
    for port, ref, pins in ((ws_ina_improvement, jws_ina, FIG7_9_PINS),
                            (ws_vs_os_improvement, jws_vs_os,
                             FIG10_12_PINS)):
        got = port(name, workloads.WORKLOADS[name], 1, NocConfig(), 16)
        want = ref(name, JWORKLOADS[name], 1, jsweeps.NocConfig(), 16)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        lat, pwr, en = pins[name]
        assert got.latency_x == pytest.approx(lat, rel=1e-9)
        assert got.power_x == pytest.approx(pwr, rel=1e-9)
        assert got.energy_x == pytest.approx(en, rel=1e-9)


# --------------------------------------------------------------------------- #
# run_all(QUICK_SWEEP): both packages, once
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def quick_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("quick")
    with pytest.MonkeyPatch.context() as mp:
        R.store_env(mp, tmp)
        R.patch_reference_plans(mp)
        # the reference's heap engine with its layer memo on: the port's
        # one configuration
        mp.setattr(jsearch, "compiled_enabled", lambda: True)
        with R.fresh_state(), compiled_disabled(), vectorized_disabled():
            ref = jsweeps.run_all(
                dataclasses.replace(jsweeps.QUICK_SWEEP,
                                    plan_dir=str(tmp / "ref_store")),
                out_dir=tmp / "ref", sections=SECTIONS)
        with R.fresh_state():
            port = sweeps.run_all(
                dataclasses.replace(sweeps.QUICK_SWEEP,
                                    plan_dir=str(tmp / "port_store")),
                out_dir=tmp / "port", sections=SECTIONS)
    return tmp, ref, port


def _without(x, keys=("elapsed_us",)):
    if isinstance(x, dict):
        return {k: _without(v, keys) for k, v in x.items() if k not in keys}
    if isinstance(x, list):
        return [_without(v, keys) for v in x]
    return x


def _port_key(key: str) -> str:
    """A port plan key is the reference's with the port's tag appended
    (``plan.plan_key``: the two stores never share a file)."""
    return f"{key}__torch"


@pytest.mark.parametrize("section", ["tables", "fig7_9", "fig10_12",
                                     "mesh_scaling", "hierarchy", "mapper",
                                     "serve"])
def test_quick_section_matches_reference(quick_runs, section):
    """Every field but the wall-clock ``elapsed_us`` of each row."""
    _, ref, port = quick_runs
    assert _without(port[section]) == _without(ref[section])


def test_quick_plan_section_matches_reference(quick_runs):
    """The plan section.  Left out: ``elapsed_us``, the store paths, and of
    each embedded plan its ``schema`` (the port's tag) and ``tiles`` (the
    port plans Hopper ``ina_matmul`` launches where the reference plans
    Pallas blocks: ``tests/test_torch_plan.py`` holds those); keys carry
    the port's tag.  Both stores start cold, so the collective engine runs
    of each row are compared too."""
    _, ref, port = quick_runs
    got, want = _without(port["plan"]), _without(ref["plan"])
    assert got.pop("store") != want.pop("store")
    rows = got.pop("rows")
    assert not any("plan_error" in r for r in rows)
    assert len(rows) == len(want["rows"]) == 10
    assert rows == [dict(r, key=_port_key(r["key"]))
                    for r in want.pop("rows")]
    plans, want_plans = got.pop("plans"), want.pop("plans")
    assert list(plans) == [_port_key(k) for k in want_plans]
    for key, plan in want_plans.items():
        mine = dict(plans[_port_key(key)])
        for field in ("schema", "tiles"):
            assert mine.pop(field) and plan.pop(field)
        assert mine == plan
    assert got == want


def test_quick_artifacts_match_reference(quick_runs):
    """``summary.md`` and ``benchmarks.csv`` over the eight sections.
    Left out: the summary's run stats (wall-clock section timings, the
    store's path) and the CSV's ``us_per_call`` column (wall clock)."""
    tmp, _, _ = quick_runs
    summary = {pkg: (tmp / pkg / "summary.md").read_text()
               .split("## Run stats")[0] for pkg in ("ref", "port")}
    assert summary["port"] == summary["ref"]
    assert "## plan" in summary["port"] and "## serve" in summary["port"]
    csv = {pkg: [line.split(",", 2) for line in
                 (tmp / pkg / "benchmarks.csv").read_text().splitlines()]
           for pkg in ("ref", "port")}
    assert [(r[0], r[2]) for r in csv["port"]] == \
        [(r[0], r[2]) for r in csv["ref"]]
    assert not any(r[0].startswith(("plan_error", "serve_error"))
                   for r in csv["port"])
    for section in SECTIONS:
        assert json.loads((tmp / "port" / f"{section}.json").read_text())[
            "figure"] == section


def test_full_mapper_space_verdicts_match_reference(tmp_path):
    """``DEFAULT_SWEEP``'s plan section searches the full mapper space
    (``mapper_space="full"``): the verdicts are the reference's, the plan
    records the space, and a store holding the quick plan rebuilds it."""
    from repro.configs import ARCHS as JARCHS
    from repro.plan.builder import gemm_verdicts as jgemm_verdicts
    from repro_torch.configs import ARCHS
    from repro_torch.plan import PlanStore
    from repro_torch.plan.builder import gemm_verdicts
    got = gemm_verdicts(ARCHS["qwen2-1.5b"], 2, "full")
    want = jgemm_verdicts(JARCHS["qwen2-1.5b"], 2, "full")
    assert [dataclasses.astuple(v) for v in got[0]] == \
        [dataclasses.astuple(v) for v in want[0]]
    assert got[1] == want[1] != gemm_verdicts(ARCHS["qwen2-1.5b"], 2)[1]
    store, mesh = PlanStore(tmp_path), (("model", 1),)
    quick, built = store.get_or_build(ARCHS["qwen2-1.5b"], mesh, "decode")
    assert built and quick.mapper_space == "quick"
    full, built = store.get_or_build(ARCHS["qwen2-1.5b"], mesh, "decode",
                                     mapper_space="full")
    assert built and full.mapper_space == "full"
    assert (full.gemms, full.mapper_hardware) == gemm_verdicts(
        ARCHS["qwen2-1.5b"], full.tokens, "full")
    assert not store.get_or_build(ARCHS["qwen2-1.5b"], mesh, "decode",
                                  mapper_space="full")[1]


def test_quick_sweep_keeps_the_reference_shape():
    """The port's sweep config is the reference's, less the faults
    section's fields (the port has no fault layer yet)."""
    faults = {f.name for f in dataclasses.fields(jsweeps.SweepConfig)
              if f.name.startswith("fault_")}
    assert faults
    for name in ("DEFAULT_SWEEP", "QUICK_SWEEP"):
        want = dataclasses.asdict(getattr(jsweeps, name))
        for f in faults:
            want.pop(f)
        want["plan_dir"] = None
        assert dataclasses.asdict(getattr(sweeps, name)) == want
    assert sweeps.SECTIONS == tuple(s for s in jsweeps.SECTIONS
                                    if s != "faults")
    assert {k: v for k, v in jsweeps.PAPER_REFERENCE.items()
            if k != "faults"} == sweeps.PAPER_REFERENCE


def test_cli_writes_the_artifacts(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.experiments`` on the simulation sections,
    the window store under ``--cache-dir``: the figures' averages printed,
    the store saved and read back warm by a second run."""
    argv = ["--quick", "--sections", "tables,fig7_9,fig10_12",
            "--out", str(tmp_path / "out"),
            "--cache-dir", str(tmp_path / "sims")]
    with R.fresh_state():
        assert experiments_main(argv) == 0
    first = capsys.readouterr().out
    assert "fig7_9: 6 rows  (avg latency_x=" in first
    assert (tmp_path / "sims" / "window_cache.json").is_file()
    with R.fresh_state():
        assert experiments_main(argv) == 0
    second = capsys.readouterr().out
    assert " 0 misses" in second and "rows loaded" in second
    fig = json.loads((tmp_path / "out" / "fig7_9.json").read_text())
    assert fig["average"] == jsweeps.run_fig7_9(jsweeps.QUICK_SWEEP)[
        "average"]
