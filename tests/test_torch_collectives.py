"""The port's accumulation strategies across ranks, against the JAX package.

* Reference side: one subprocess with 8 host devices (as
  ``tests/test_collectives.py``) runs ``repro.core.collectives``' ring
  functions, ``psum_with_mode`` and ``reduce_scatter_with_mode`` in every
  mode at P = 2, 4 and 8 (meshes over the first P devices), on seeded numpy
  inputs [P, 16, 32] in float32 and bfloat16, scattering on axis 0 and 1;
  and it records the ``auto`` sites of the reduced qwen2's forward and
  decode step at P = 2 and 4.
* Port side: one gloo spawn a P runs ``repro_torch.core.collectives`` on the
  same inputs (``tests/_torch_dist_workers.py``).
* Tolerances: the ring modes add in the reference's order and must be
  bit-equal in both dtypes.  The native modes (``ina``, ``xla``: XLA's
  psum against gloo's all-reduce) sum in another order: float32 within
  1e-5; bfloat16 within ``P * 2^-8 * sum_i |x_i|`` elementwise, because
  the reference sums in float32 and rounds once (its CPU upcast) while gloo
  rounds each of its P-1 partial sums to bfloat16.  gloo's bfloat16 sums
  are not always rounded to nearest (a sum one ulp from the exact one was
  seen), so each rounding is taken as off by up to one ulp, 2^-8 of the
  partial sum, which ``sum_i |x_i|`` bounds.
* The analytic parts run in this process: ``per_link_bytes``, the ``auto``
  choice and the simulated costs of each mode, each side on a fresh sim
  cache that persists nothing.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import collectives as JC
from repro.core.noc.collective import cost as jcost
from repro.core.noc.simcache import fresh_sim_cache as jfresh

from repro_torch.core import collectives as TC
from repro_torch.core.noc.collective import cost as tcost
from repro_torch.core.noc.simcache import fresh_sim_cache as tfresh
from repro_torch.launch import mesh

import _torch_dist_workers as W

SPANS = (2, 4, 8)
DTYPES = ("float32", "bfloat16")
RING = ("eject_inject", "rs_ina_ax0", "rs_ina_ax1", "all_gather_ax0",
        "all_gather_ax1", "psum_ina_ax0", "psum_ina_ax1")
FNS = RING + tuple(f"{op}_with_mode_{m}_ax{a}" for op in ("psum", "rs")
                   for m in W.MODES for a in (0, 1))
NATIVE = ("ina", "xla")


def inputs(p: int) -> np.ndarray:
    return np.random.default_rng(100 + p).standard_normal(
        (p, 16, 32)).astype(np.float32)


REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from repro.compat import shard_map
from repro.configs import ARCHS
from repro.core import collectives as C
from repro.models.api import get_model
from repro.parallel.tp import ParallelCtx

out_dir = sys.argv[1]
devs = jax.devices()
assert len(devs) == 8, devs
MODES = ("ina", "ina_ring", "eject_inject", "xla", "auto")

def fns():
    f = {"eject_inject": lambda x: C.ring_psum_eject_inject(x, "model")}
    for a in (0, 1):
        f[f"rs_ina_ax{a}"] = lambda x, a=a: C.ring_reduce_scatter_ina(x, "model", a)
        f[f"all_gather_ax{a}"] = lambda x, a=a: C.ring_all_gather(x, "model", a)
        f[f"psum_ina_ax{a}"] = lambda x, a=a: C.psum_ina(x, "model", a)
        for m in MODES:
            f[f"psum_with_mode_{m}_ax{a}"] = lambda x, a=a, m=m: C.psum_with_mode(x, "model", m, a)
            f[f"rs_with_mode_{m}_ax{a}"] = lambda x, a=a, m=m: C.reduce_scatter_with_mode(x, "model", m, a)
    return f

arrays = {}
for p in (2, 4, 8):
    mesh = Mesh(np.array(devs[:p]), ("model",))
    x = np.random.default_rng(100 + p).standard_normal((p, 16, 32)).astype(np.float32)
    for dname in ("float32", "bfloat16"):
        xd = jnp.asarray(x).astype(dname)
        table = fns()
        f = shard_map(lambda xs: {n: fn(xs[0])[None] for n, fn in table.items()},
                      mesh=mesh, in_specs=P("model"), out_specs=P("model"))
        for name, y in jax.jit(f)(xd).items():
            assert y.dtype == xd.dtype, (name, y.dtype)
            arrays[f"{p}/{dname}/{name}"] = np.asarray(y.astype(jnp.float32))

cfg = ARCHS["qwen2-1.5b"].reduced()
model = get_model(cfg)
pshape = jax.eval_shape(model.init, jax.random.PRNGKey(0))
sites = {}
for p in (2, 4):
    mesh = Mesh(np.array(devs[:p]).reshape(1, p), ("data", "model"))
    for rs in (False, True):
        pctx = ParallelCtx(mesh=mesh, psum_mode="auto", rs_seq=rs)
        with C.record_psum_sites() as fwd:
            jax.eval_shape(lambda prm, t: model.forward(prm, {"tokens": t}, pctx),
                           pshape, jax.ShapeDtypeStruct((2, 8), jnp.int32))
        cache = jax.eval_shape(lambda: model.init_cache(2, 16))
        with C.record_psum_sites() as dec:
            jax.eval_shape(lambda prm, t, c: model.decode_step(
                prm, {"tokens": t, "pos": jnp.int32(3)}, c, pctx), pshape,
                jax.ShapeDtypeStruct((2, 1), jnp.int32), cache)
        sites[f"{p}/forward/{rs}"] = [[s.op, s.p, s.nbytes] for s in fwd]
        sites[f"{p}/decode/{rs}"] = [[s.op, s.p, s.nbytes] for s in dec]

np.savez(os.path.join(out_dir, "reference.npz"), **arrays)
with open(os.path.join(out_dir, "sites.json"), "w") as fh:
    json.dump(sites, fh)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives_ref")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    arrays = dict(np.load(out / "reference.npz"))
    return arrays, json.loads((out / "sites.json").read_text())


_PORT: dict = {}


def port(p: int) -> list:
    """Each rank's results at span ``p`` (one gloo spawn a span)."""
    if p not in _PORT:
        _PORT[p] = mesh.spawn(W.collectives_rank, p, "cpu", args=(inputs(p),))
    return _PORT[p]


@pytest.mark.parametrize("name", FNS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", SPANS)
def test_collective_matches_reference(reference, p, dtype, name):
    want = reference[0][f"{p}/{dtype}/{name}"]
    got = np.stack([r[f"{dtype}/{name}"] for r in port(p)])
    assert got.shape == want.shape
    mode = name.split("with_mode_")[-1].rsplit("_ax", 1)[0]
    if mode not in NATIVE:
        np.testing.assert_array_equal(got, want)
        return
    x = inputs(p)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    mag = np.abs(x.astype(np.float32)).sum(0)            # sum_i |x_i|
    if name.startswith("rs_with_mode"):
        axis = int(name[-1])
        mag = np.stack(np.split(mag, p, axis=axis))      # rank i's chunk
    bound = p * 2.0 ** -8 * mag
    assert np.all(np.abs(got - want) <= bound), float(np.abs(got - want).max())


@pytest.mark.parametrize("p", SPANS)
def test_collectives_sum_over_ranks(p):
    """Independent of the reference: every mode's psum equals the float64
    rank sum, and rank i's reduce-scatter is chunk i of it."""
    x = inputs(p)
    total = x.astype(np.float64).sum(0)
    for r, res in enumerate(port(p)):
        for m in W.MODES:
            for a in (0, 1):
                np.testing.assert_allclose(res[f"float32/psum_with_mode_{m}_ax{a}"],
                                           total, rtol=1e-5, atol=1e-5)
                chunk = np.split(total, p, axis=a)[r]
                np.testing.assert_allclose(res[f"float32/rs_with_mode_{m}_ax{a}"],
                                           chunk, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(res["float32/all_gather_ax1"],
                                      np.concatenate(list(x), axis=1))


@pytest.mark.parametrize("key", [f"{p}/{ph}/{rs}" for p in (2, 4)
                                 for ph in ("forward", "decode")
                                 for rs in (False, True)])
def test_record_psum_sites_matches_reference(reference, key):
    """The reference traces its ``lax.scan`` body once, so it records each
    layer's two sites once; the port's Python loop records them in every
    layer, so its list is the reference's repeated once a layer."""
    p, phase, rs = key.split("/")
    from repro_torch.configs import ARCHS
    layers = ARCHS["qwen2-1.5b"].reduced().n_layers
    want = [tuple(s) for s in reference[1][key]] * layers
    for rank in port(int(p)):
        assert rank["sites"][f"{phase}/{rs}"] == want


# --------------------------------------------------------------------------- #
# analytic parts (this process)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["ina", "ina_ring", "eject_inject", "xla",
                                  "auto"])
def test_per_link_bytes_matches_reference(mode):
    for p in (1, 2, 3, 4, 8, 16):
        for nbytes in (0, 1000, 6144, 196608, 1572864):
            for full in (True, False):
                assert TC.per_link_bytes(mode, p, nbytes, full) == \
                    JC.per_link_bytes(mode, p, nbytes, full)
    with pytest.raises(ValueError):
        TC.per_link_bytes("xla_spmd", 2, 8)


# qwen2-1.5b's row-parallel payloads (d_model 1536): the serve phase's
# decode (2 slots) and prefill chunk (64) in bf16, the legacy loop's decode
# (4 rows), the exact-f32 phase's decode and chunk, and a 512-token chunk.
QWEN2_PAYLOADS = tuple(b * s * 1536 * e for b, s, e in
                       ((2, 1, 2), (4, 1, 2), (1, 64, 2), (2, 1, 4),
                        (1, 64, 4), (1, 512, 2)))


def _fresh_choice(mod, fresh, sim, fn, *args):
    """``fn(*args)`` on an empty, unpersisted sim cache and empty memos."""
    sim.cache_clear()
    mod._fallback_choice.cache_clear()
    with fresh():
        out = fn(*args)
    sim.cache_clear()
    mod._fallback_choice.cache_clear()
    return out


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
def test_auto_choice_matches_reference(p):
    for nbytes in QWEN2_PAYLOADS:
        for op in ("psum", "reduce_scatter"):
            want = _fresh_choice(JC, jfresh, jcost._simulate,
                                 JC.resolve_auto_mode, op, p, nbytes)
            got = _fresh_choice(TC, tfresh, tcost._simulate,
                                TC.resolve_auto_mode, op, p, nbytes)
            assert got == want, (op, p, nbytes)
        for objective in ("latency", "energy"):
            assert _fresh_choice(TC, tfresh, tcost._simulate,
                                 TC.choose_psum_mode, p, nbytes, objective) \
                == _fresh_choice(JC, jfresh, jcost._simulate,
                                 JC.choose_psum_mode, p, nbytes, objective)


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
def test_psum_mode_costs_match_reference(p):
    for nbytes in QWEN2_PAYLOADS:
        want = _fresh_choice(JC, jfresh, jcost._simulate, JC.mesh_psum_costs,
                             p, nbytes)
        got = _fresh_choice(TC, tfresh, tcost._simulate, TC.mesh_psum_costs,
                            p, nbytes)
        assert set(got) == set(want)
        for mode in want:
            assert got[mode].latency_cycles == want[mode].latency_cycles
            assert got[mode].energy_pj == want[mode].energy_pj
            assert got[mode].packets == want[mode].packets


def test_record_psum_sites_and_plan_regimes():
    """Recording returns the stand-in and simulates nothing; outside it a
    site resolves by the cost model once, then from the memo.  (The
    reference's middle regime, a plan's table, is not carried.)"""
    runs0 = dict(tcost.COST_STATS)
    with TC.record_psum_sites() as sites:
        with TC.record_psum_sites() as inner:
            assert TC.resolve_auto_mode("psum", 16, 1 << 20) == "ina"
        assert TC.resolve_auto_mode("reduce_scatter", 4, 512) == "ina"
    assert inner == [TC.PsumSite("psum", 16, 1 << 20)]
    assert sites == [TC.PsumSite("reduce_scatter", 4, 512)]
    assert tcost.COST_STATS["engine_runs"] == runs0["engine_runs"]

    TC._fallback_choice.cache_clear()
    first = TC.resolve_auto_mode("psum", 4, 12345)
    assert first == TC.choose_psum_mode(4, 12345)
    hits = TC._fallback_choice.cache_info().hits
    assert TC.resolve_auto_mode("psum", 4, 12345) == first
    assert TC._fallback_choice.cache_info().hits == hits + 1


def test_one_rank_returns_the_input_itself():
    """At p == 1 (no group) every mode, the native ones too, returns x
    untouched: a one-rank step launches nothing more."""
    import torch
    x = torch.randn(4, 6)
    for m in W.MODES:
        assert TC.psum_with_mode(x, None, m) is x
        assert TC.reduce_scatter_with_mode(x, None, m) is x
    assert TC.ring_all_gather(x, None) is x
    assert TC.psum_ina(x, None, 1) is x


def test_sim_store_hands_out_copies_and_fresh_restores():
    """The in-memory store: a hit is a copy of the ledger (the caller may
    mutate it), a signature the store holds replays nothing even after
    the lru is cleared, and ``fresh_sim_cache`` gives back the outer store
    on exit."""
    from repro_torch.core.noc import simcache as tsim
    with tfresh() as store:
        tcost._simulate.cache_clear()
        runs = tcost.COST_STATS["engine_runs"]
        want = TC.mesh_psum_costs(4, 6144)
        assert tcost.COST_STATS["engine_runs"] > runs
        n = len(store)
        assert n > 0
        key = next(iter(store._store))
        lat, ledger = store.get(key)
        ledger.flit_links += 1
        assert store.get(key)[1].flit_links == ledger.flit_links - 1
        tcost._simulate.cache_clear()
        runs = tcost.COST_STATS["engine_runs"]
        got = TC.mesh_psum_costs(4, 6144)
        assert tcost.COST_STATS["engine_runs"] == runs
        assert len(store) == n
        for mode in want:
            assert got[mode].latency_cycles == want[mode].latency_cycles
            assert got[mode].energy_pj == want[mode].energy_pj
        with tfresh() as inner:
            assert len(inner) == 0
        assert tsim.SIM_CACHE is store and len(store) == n
    tcost._simulate.cache_clear()


@pytest.mark.parametrize("op", ["reduce", "broadcast", "gather", "allreduce"])
def test_heap_engine_matches_reference_collective_cost(op):
    """The port runs every program on the heap engine alone, where the
    reference takes its vectorized or compiled executor: each collective
    op, both router semantics and both allreduce lowerings, on a full 4x4
    mesh and on a row, costs the same cycles, energy and packets."""
    from repro.core.noc.router import NocConfig as JCfg
    from repro_torch.core.noc.router import NocConfig as TCfg
    algos = ("reduce_bcast", "rs_ag") if op == "allreduce" else \
        ("reduce_bcast",)
    for parts in (None, [(x, 1) for x in range(4)]):
        for semantics in ("ina", "eject_inject"):
            for algorithm in algos:
                for bits in (512, 49152):
                    kw = dict(participants=parts, algorithm=algorithm,
                              semantics=semantics)
                    jcost._simulate.cache_clear()
                    tcost._simulate.cache_clear()
                    with jfresh():
                        want = jcost.collective_cost(op, bits, JCfg(n=4), **kw)
                    with tfresh():
                        got = tcost.collective_cost(op, bits, TCfg(n=4), **kw)
                    assert (got.latency_cycles, got.energy_pj, got.packets) \
                        == (want.latency_cycles, want.energy_pj,
                            want.packets), (parts, semantics, algorithm, bits)
    jcost._simulate.cache_clear()
    tcost._simulate.cache_clear()
