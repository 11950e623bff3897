"""The reference's plan path, run beside the port's in one process.

Two things stand between ``repro.plan`` and the port's plans on the
installed jax, and the tests that hold the port's capacity planner and
sweeps to the reference's patch both, with ``monkeypatch``, in the test
only:

* ``repro.plan.builder.trace_mesh`` passes ``AbstractMesh`` its axis pairs,
  which some JAX versions refuse; :func:`abstract_mesh` builds it from
  sizes and names (as ``tests/test_torch_plan.py`` does);
* the reference traces a stacked layer body once under ``lax.scan``, so a
  psum decision's ``count`` is one body's, where the port's layer loop
  records every layer's (``tests/test_torch_plan.py`` holds the port's
  count to the reference's times the depth).  Everything downstream of the
  count (a plan's psum summary, the serving cost model, the cluster
  simulator's fleet answers) would differ by that factor alone, so the
  reference's ``collect_psum_sites`` is given the port's sites
  (:func:`port_sites`, the same ``(op, p, nbytes)`` payloads with the
  port's counts) and the rest of its plan path runs unchanged.  Each
  trace of the port's sites runs once in the process and both packages'
  builds read it (``tests/test_torch_plan.py`` holds the trace itself).

:func:`fresh_state` starts both packages from empty simulation stores,
memos and executor programs, so that cache counters and collective engine
runs can be compared.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax

from repro.core import collectives as JC
from repro.plan import builder as jbuilder

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.plan import builder as tbuilder


def abstract_mesh(mesh_shape):
    """The reference's trace mesh as ``AbstractMesh(sizes, names)``, or
    the pairs form on JAX versions that take only that one."""
    pairs = jbuilder.normalize_mesh(mesh_shape)
    sizes = tuple(s for _, s in pairs)
    names = tuple(a for a, _ in pairs)
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(pairs))


_COLLECT = tbuilder.collect_psum_sites


@functools.cache
def _sites(cfg, mesh: tuple, shape) -> tuple:
    """The port's ``collect_psum_sites``, once a ``(cfg, mesh, shape)``
    in the process (a ``meta`` trace of the model's step, the costly part
    of a plan build)."""
    return tuple(_COLLECT(cfg, mesh, shape))


def cached_port_sites(cfg, mesh, shape) -> list:
    return list(_sites(cfg, tuple(mesh), shape))


def port_sites(cfg, mesh, shape, pctx=None):
    """The port's psum sites for the reference's ``(cfg, mesh, shape)``,
    as the reference's :class:`~repro.core.collectives.PsumSite`s."""
    assert pctx is None, "the sweeps and the planner pass no pctx"
    return [JC.PsumSite(s.op, s.p, s.nbytes)
            for s in _sites(ARCHS[cfg.name], jbuilder.normalize_mesh(mesh),
                            ShapeConfig(*dataclasses.astuple(shape)))]


def patch_reference_plans(monkeypatch) -> None:
    """Let the reference build plans here, on the port's site counts, and
    let both packages' builds share each trace of the port's sites."""
    monkeypatch.setattr(jbuilder, "trace_mesh", abstract_mesh)
    monkeypatch.setattr(jbuilder, "collect_psum_sites", port_sites)
    monkeypatch.setattr(tbuilder, "collect_psum_sites", cached_port_sites)


def store_env(monkeypatch, tmp_path) -> None:
    """Both packages' plan and simulation stores under ``tmp_path``."""
    for env, sub in (("REPRO_PLAN_DIR", "ref_plans"),
                     ("REPRO_SIMCACHE_DIR", "ref_sims"),
                     ("REPRO_TORCH_PLAN_DIR", "port_plans"),
                     ("REPRO_TORCH_SIMCACHE_DIR", "port_sims")):
        monkeypatch.setenv(env, str(tmp_path / sub))


@contextlib.contextmanager
def fresh_state():
    """Empty, non-persistent simulation stores, cold collective and GEMM
    memos and cold executor programs in both packages; the previous stores
    come back on exit."""
    from repro.core.noc import fresh_sim_cache as jfresh
    from repro.core.noc import traffic as jtraffic
    from repro.core.noc.collective import cost as jcost
    from repro_torch.core.noc import fresh_sim_cache as tfresh
    from repro_torch.core.noc import traffic as ttraffic
    from repro_torch.core.noc.collective import cost as tcost
    for mod in (jcost, tcost):
        mod._simulate.cache_clear()
        mod._simulate_faulted.cache_clear()
    for mod in (jtraffic, ttraffic):
        mod.clear_compiled_caches()
    jbuilder._GEMM_MEMO.clear()
    tbuilder._GEMM_MEMO.clear()
    with jfresh(), tfresh():
        yield
