"""The port's capacity planner (``repro_torch.serve``: traffic, costs,
cluster, ``python -m repro_torch.serve``) against the reference's, on the
CPU.

* ``ClusterSimulator`` and ``search_fleet`` under ``SyntheticCostModel``
  give byte-identical metrics JSON to the reference's over the cases of
  ``tests/test_serve_cluster.py`` (and a replica-failure trace), the
  never-admissible request raising in both;
* ``make_workload``, ``poisson_arrivals``, ``parse_length_dist`` and
  ``load_trace`` give the reference's requests and samples;
* ``PlanCostModel.from_plans`` on the port's plans equals the reference's
  on its plans at chips 1 and 2, under both semantics;
* ``python -m repro_torch.serve --no-execute`` writes the reference's JSON
  byte for byte but the plan keys (the port's tag), for a fixed fleet,
  ``--search-fleet`` and ``--search-fleet --chips 2``;
* the engine demo's requests, served by the port's engine on the CPU on the
  reference's weights (carried across by ``repro_torch.convert``), give the
  tokens of a greedy loop over the reference's ``decode_step`` (the
  reference's ``ServingEngine`` cannot be built on the installed jax).

The reference's plans are built on the port's psum sites
(``tests/_torch_ref_plans.py``).
"""
import dataclasses
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ref_plans as R
import repro.serve.__main__ as jplanner
from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model
from repro.serve import cluster as jcluster
from repro.serve import costs as jcosts
from repro.serve import traffic as jtraffic

import repro_torch.serve.__main__ as planner
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.serve import cluster, costs, traffic

ARCH = "qwen2-1.5b"


# --------------------------------------------------------------------------- #
# The cluster simulator and the fleet search (tests/test_serve_cluster.py)
# --------------------------------------------------------------------------- #
def _failures(mod, fleet, reqs):
    horizon = max(r.arrival for r in reqs)
    return mod.replica_failure_trace(fleet, horizon, mtbf_s=horizon * 0.3,
                                     mttr_s=horizon * 0.08, seed=0)


def _overload(tr):
    return tr.make_workload(120, qps=1000.0, prompt_dist="uniform:32:64",
                            gen_dist="uniform:16:32", seed=3)


def _fleet_reqs(tr):
    return tr.make_workload(120, qps=50.0, prompt_dist="uniform:32:64",
                            gen_dist="uniform:16:32", seed=3)


_FLEET_KW = dict(slots=4, block_size=16, max_seq=128, prefill_chunk=32)

#: name -> fn(traffic, cluster, costs) -> a JSON-ready result
CLUSTER_CASES = {
    "pinned": lambda tr, cl, co: cl.ClusterSimulator(
        2, slots=4, block_size=16, max_seq=256, prefill_chunk=32,
        cost=co.SyntheticCostModel()).run(tr.make_workload(
            80, qps=2.0, prompt_dist="uniform:16:128",
            gen_dist="uniform:8:64", seed=42)),
    "littles_law": lambda tr, cl, co: cl.ClusterSimulator(
        4, slots=8, block_size=16, max_seq=512, prefill_chunk=32,
        cost=co.SyntheticCostModel()).run(tr.make_workload(
            400, qps=5.0, prompt_dist="lognormal:64:0.5:256",
            gen_dist="uniform:16:64", seed=7)),
    "zero_traffic": lambda tr, cl, co: cl.ClusterSimulator(
        2, cost=co.SyntheticCostModel()).run([]),
    "overload_small": lambda tr, cl, co: cl.ClusterSimulator(
        1, slots=2, block_size=16, max_seq=128, prefill_chunk=32,
        cost=co.SyntheticCostModel()).run(_overload(tr)),
    "overload_big": lambda tr, cl, co: cl.ClusterSimulator(
        8, slots=8, block_size=16, max_seq=128, prefill_chunk=32,
        cost=co.SyntheticCostModel()).run(_overload(tr)),
    "replica_failures": lambda tr, cl, co: cl.ClusterSimulator(
        2, slots=4, block_size=16, max_seq=128, prefill_chunk=32,
        cost=co.SyntheticCostModel(),
        failures=_failures(cl, 2, _fleet_reqs(tr))).run(_fleet_reqs(tr)),
    "search_fleet": lambda tr, cl, co: cl.search_fleet(
        _fleet_reqs(tr), slo_s=0.5, metric="queueing_s", max_fleet=16,
        cost=co.SyntheticCostModel(), **_FLEET_KW),
    "search_fleet_unmet": lambda tr, cl, co: cl.search_fleet(
        _fleet_reqs(tr), slo_s=0.0, metric="queueing_s", max_fleet=2,
        cost=co.SyntheticCostModel(), **_FLEET_KW),
    "search_fleet_chips": lambda tr, cl, co: cl.search_fleet(
        _fleet_reqs(tr), slo_s=0.05, metric="queueing_s", max_fleet=8,
        cost_by_chips={1: co.SyntheticCostModel(),
                       2: co.SyntheticCostModel(0.001, 0.002, 0.00025)},
        **_FLEET_KW),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_cluster_metrics_byte_identical_to_reference(case):
    fn = CLUSTER_CASES[case]
    got = json.dumps(fn(traffic, cluster, costs), sort_keys=True)
    assert got == json.dumps(fn(jtraffic, jcluster, jcosts), sort_keys=True)
    if case == "pinned":     # test_serve_cluster.py's drift alarm
        m = json.loads(got)
        assert (m["requests"], m["tokens_out"], m["iterations"],
                m["events"]) == (80, 2858, 2762, 2842)


def test_replica_failure_trace_matches_reference():
    kw = dict(mtbf_s=30.0, mttr_s=8.0, seed=5)
    assert cluster.replica_failure_trace(3, 100.0, **kw) == \
        jcluster.replica_failure_trace(3, 100.0, **kw)


def test_never_admissible_request_raises_as_reference():
    msgs = []
    for tr, cl, co in ((traffic, cluster, costs),
                       (jtraffic, jcluster, jcosts)):
        req = cl.Request(rid="huge", prompt_len=512, max_new=64)
        sim = cl.ClusterSimulator(1, slots=2, block_size=16, num_blocks=2,
                                  max_seq=1024, cost=co.SyntheticCostModel())
        with pytest.raises(RuntimeError, match="never be admitted") as e:
            sim.run([req])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="cost model"):
        cluster.ClusterSimulator(1)


# --------------------------------------------------------------------------- #
# Workloads
# --------------------------------------------------------------------------- #
def _astuples(reqs):
    return [dataclasses.astuple(r) for r in reqs]


@pytest.mark.parametrize("vocab", [None, 256])
@pytest.mark.parametrize("qps", [0.0, 3.0])
def test_make_workload_matches_reference(qps, vocab):
    args = (40, qps, "lognormal:128:0.5:512", "uniform:32:128", 11)
    assert _astuples(traffic.make_workload(*args, vocab=vocab,
                                           prefix="e")) == \
        _astuples(jtraffic.make_workload(*args, vocab=vocab, prefix="e"))


@pytest.mark.parametrize("spec", ["fixed:64", "uniform:16:128",
                                  "lognormal:64:0.5:512"])
def test_length_dists_and_arrivals_match_reference(spec):
    draw, jdraw = traffic.parse_length_dist(spec), \
        jtraffic.parse_length_dist(spec)
    a, b = random.Random(3), random.Random(3)
    assert [draw(a) for _ in range(200)] == [jdraw(b) for _ in range(200)]
    assert traffic.poisson_arrivals(2.5, 50, random.Random(1)) == \
        jtraffic.poisson_arrivals(2.5, 50, random.Random(1))
    assert traffic.poisson_arrivals(0.0, 3, None) == [0.0] * 3
    for bad in ("zipf:3", "uniform:9:2"):
        with pytest.raises(ValueError):
            traffic.parse_length_dist(bad)


def test_trace_round_trip_matches_reference(tmp_path):
    rows = [{"t": 0.5, "prompt_len": 8, "max_new": 4},
            {"t": 0.0, "prompt_len": 16, "max_new": 2, "rid": "z",
             "priority": 1},
            {"t": 0.5, "prompt_len": 3, "max_new": 9, "rid": "a"}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(rows))
    got = traffic.load_trace(str(path))
    assert _astuples(got) == _astuples(jtraffic.load_trace(str(path)))
    assert [r.rid for r in got] == ["z", "a", "t0000"]


# --------------------------------------------------------------------------- #
# Plans: the cost model and the planner's JSON
# --------------------------------------------------------------------------- #
@pytest.fixture
def ref_plans(tmp_path, monkeypatch):
    R.store_env(monkeypatch, tmp_path)
    R.patch_reference_plans(monkeypatch)
    with R.fresh_state():
        yield tmp_path


MESH_8X8 = (("data", 8), ("model", 8))


@pytest.mark.parametrize("chips", [1, 2])
def test_plan_cost_model_matches_reference(ref_plans, chips):
    port = costs.serve_plans(ARCHS[ARCH], MESH_8X8, verbose=False,
                             plan_dir=ref_plans / "p", chips=chips)
    ref = jcosts.serve_plans(JARCHS[ARCH], MESH_8X8, verbose=False,
                             plan_dir=ref_plans / "j", chips=chips)
    for sem in costs.SEMANTICS:
        got = costs.PlanCostModel.from_plans(
            ARCHS[ARCH], port["prefill"][0], port["decode"][0], 64,
            semantics=sem, calibration=0.5)
        want = jcosts.PlanCostModel.from_plans(
            JARCHS[ARCH], ref["prefill"][0], ref["decode"][0], 64,
            semantics=sem, calibration=0.5)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.chips == chips
        for n in (1, 2, 8, 33):
            assert got.decode_iter_seconds(n) == want.decode_iter_seconds(n)
        assert got.prefill_chunk_seconds() == want.prefill_chunk_seconds()
    with pytest.raises(ValueError, match="semantics"):
        costs.PlanCostModel.from_plans(ARCHS[ARCH], port["prefill"][0],
                                       port["decode"][0], 64,
                                       semantics="xla")


PLANNER_ARGV = ["--arch", ARCH, "--no-execute", "--requests", "60", "--qps",
                "0.1", "--slo-metric", "queueing_s", "--slo-p99-ms",
                "30000"]


@pytest.mark.parametrize("extra", [[], ["--search-fleet"],
                                   ["--search-fleet", "--chips", "2"]],
                         ids=["fleet1", "search", "search_chips2"])
def test_planner_json_matches_reference(ref_plans, extra):
    """Byte for byte but each plan key, which carries the port's tag
    (``__torch``) so that the two packages' stores never share a file."""
    out = {}
    for pkg, main in (("port", planner.main), ("ref", jplanner.main)):
        path = ref_plans / f"{pkg}.json"
        assert main(PLANNER_ARGV + extra + [
            "--out", str(path), "--plan-dir", str(ref_plans / pkg)]) == 0
        out[pkg] = path.read_text()
    doc = json.loads(out["port"])
    keys = {v["key"] for v in doc["plan"].values()}
    assert keys and all(k.endswith("__torch") for k in keys)
    for k in keys:
        out["port"] = out["port"].replace(k, k.removesuffix("__torch"))
    assert out["port"] == out["ref"]
    assert doc["engine"] is None and doc["fleet_answer"]["metrics"]


def test_planner_synthetic_cost_without_plans(tmp_path, monkeypatch):
    """``--no-plan``: the synthetic cost model, no plan in the JSON."""
    monkeypatch.chdir(tmp_path)
    argv = PLANNER_ARGV + ["--no-plan", "--search-fleet"]
    assert planner.main(argv) == 0
    got = (tmp_path / "results" / "serve" /
           f"serve_{ARCH}_seed0.json").read_text()
    assert jplanner.main(argv + ["--out", "ref.json"]) == 0
    assert got == (tmp_path / "ref.json").read_text()
    assert json.loads(got)["plan"] is None


# --------------------------------------------------------------------------- #
# The engine demo
# --------------------------------------------------------------------------- #
def _reference_tokens(reqs, jm, jp, max_seq):
    """Greedy tokens of each request alone (B 1) through the reference's
    ``decode_step``: the prompt token by token, then ``max_new`` tokens."""
    step = jax.jit(jm.decode_step)
    out = {}
    for req in reqs:
        cache = jm.init_cache(1, max_seq)
        for pos, tok in enumerate(req.prompt):
            logits, cache = step(jp, {"tokens": jnp.asarray([[tok]]),
                                      "pos": jnp.asarray(pos, jnp.int32)},
                                 cache)
        toks = []
        for i in range(req.max_new):
            nxt = int(jnp.argmax(logits[0, -1]))
            toks.append(nxt)
            if i + 1 < req.max_new:
                logits, cache = step(
                    jp, {"tokens": jnp.asarray([[nxt]]),
                         "pos": jnp.asarray(req.prompt_len + i, jnp.int32)},
                    cache)
        out[req.rid] = toks
    return out


def test_engine_demo_matches_reference_loop(capsys):
    cfg = ARCHS[ARCH]
    rc, jrc = cfg.reduced(), JARCHS[ARCH].reduced()
    jm = jget_model(jrc)
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), rc, device="cpu")
    doc = planner.run_engine_demo(cfg, 0, 6, device="cpu", params=params)
    reqs = traffic.make_workload(6, qps=0.0, prompt_dist="uniform:4:12",
                                 gen_dist="uniform:2:6", seed=0,
                                 vocab=rc.vocab, prefix="e")
    assert doc["tokens"] == _reference_tokens(reqs, jm, jp, rc.max_seq)
    assert doc["paged_monolithic_checks"] == doc["requests"] == 6
    assert (doc["slots"], doc["block_size"], doc["prefill_chunk"]) == \
        (2, 8, 4)
    assert doc["prefill_chunks"] == sum(-(-r.prompt_len // 4) for r in reqs)
    assert "engine demo: 6 requests" in capsys.readouterr().out


def test_planner_runs_the_demo_on_the_cpu(tmp_path, monkeypatch):
    """``--device cpu``: the demo's document lands in the JSON; the
    engine's own seeded weights."""
    monkeypatch.chdir(tmp_path)
    assert planner.main(["--no-plan", "--requests", "20", "--device", "cpu",
                         "--execute-requests", "3", "--out", "o.json"]) == 0
    doc = json.loads((tmp_path / "o.json").read_text())
    eng = doc["engine"]
    assert eng["requests"] == 3 and eng["paged_monolithic_checks"] == 3
    assert sorted(eng["tokens"]) == ["e0000", "e0001", "e0002"]
