"""Versioned on-disk plan store: repeated launches start warm (counterpart
of ``repro.plan.store``).

Plans persist as one JSON file per plan key under
``results/.plans_torch`` (beside the sim store ``results/.simcache_torch``;
override with ``$REPRO_TORCH_PLAN_DIR`` or an explicit directory).  The
directory, the environment variable, the key suffix and the schema tag are
the port's own: a port plan and a reference plan never share one.  The
contract is the reference's:

* **schema-guarded**: every file carries
  :func:`~.plan.plan_schema_hash`; a mismatch (field drift, cost-model
  surface change, sim-store schema bump, a reference plan) makes the file
  invisible (rebuild) instead of serving stale decisions;
* **atomic**: writes go through tempfile + ``os.replace``, so concurrent
  launches never see a torn plan;
* **best-effort**: a missing or corrupt file is a cold start, never an
  error;
* **verified**: :meth:`PlanStore.save` refuses a plan with findings
  (:func:`repro_torch.analysis.verify_plan`).

:meth:`PlanStore.get_or_build` is the one call consumers use: load when
warm (no collective simulation), build and save when cold.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.exec.timing import Stopwatch

from .plan import ExecutionPlan, plan_key, plan_schema_hash

#: Environment override for the store location (CLI flags take precedence).
PLAN_DIR_ENV = "REPRO_TORCH_PLAN_DIR"

_DEFAULT_DIR = os.path.join("results", ".plans_torch")


def default_plan_dir() -> str:
    """The store location honoring the environment override."""
    return os.environ.get(PLAN_DIR_ENV, _DEFAULT_DIR)


def add_plan_cli_args(ap) -> None:
    """The ``--psum-mode auto`` companion flags, shared by the launch CLIs
    (train/serve) so the surface cannot drift between them."""
    ap.add_argument("--plan-dir", default=None, metavar="DIR",
                    help="ExecutionPlan store consulted by --psum-mode auto "
                         f"(default ${PLAN_DIR_ENV} or {_DEFAULT_DIR})")
    ap.add_argument("--no-plan", action="store_true",
                    help="auto mode without plans (per-site resolution by "
                         "the cost model, the pre-plan behaviour)")


def launch_phase(shape) -> str:
    """Plan-phase label for a launch ShapeConfig.

    The canonical phase shapes (train_4k / prefill_32k / decode_32k) share
    the bare phase name; any other shape keys by its full geometry, so two
    launches with different ``--batch``/``--seq`` never collide on one plan
    file (the psum payloads differ)."""
    from .builder import PHASE_SHAPES
    if PHASE_SHAPES.get(shape.kind) == shape.name:
        return shape.kind
    return (f"{shape.kind}-{shape.name}-"
            f"{shape.seq_len}x{shape.global_batch}")


def plan_for_launch(cfg: ModelConfig, mesh, shape, psum_mode: str,
                    plan_dir: Optional[str] = None, enabled: bool = True,
                    verbose: bool = True, **build_kwargs):
    """(plan, info) an ``--psum-mode auto`` launch should carry, or
    ``(None, None)`` when planning is off.

    Shared by the train and serve drivers: persists the sim store (so a
    cold plan build warms the next launch), keys the plan via
    :func:`launch_phase`, and prints one status line.  ``info`` records
    the store behaviour (``key``, ``from_store``, ``collective_sims``,
    ``plan_s``, the psum summary)."""
    if psum_mode != "auto" or not enabled:
        return None, None
    from repro_torch.core.noc.collective.cost import COST_STATS
    from repro_torch.core.noc.simcache import SIM_CACHE
    if SIM_CACHE._persist_dir is None:
        # The first launch plan of a process wires persistence; a re-call
        # would re-read the whole store and retarget a caller's directory.
        SIM_CACHE.persist(SIM_CACHE.persist_default_dir())
    store = PlanStore(plan_dir)
    runs0 = COST_STATS["engine_runs"]
    watch = Stopwatch()
    plan, built = store.get_or_build(cfg, mesh, launch_phase(shape),
                                     shape=shape, **build_kwargs)
    info = {"key": plan.key, "from_store": not built,
            "plan_s": watch.seconds,
            "collective_sims": COST_STATS["engine_runs"] - runs0,
            "psum": plan.psum_summary()}
    if verbose:
        src = "warm store" if info["from_store"] else "built"
        print(f"[plan] {plan.key}: {src} in {info['plan_s']:.3f} s "
              f"({info['collective_sims']} collective sims) "
              f"modes={info['psum']['modes']}", flush=True)
    return plan, info


class PlanStore:
    """Directory of schema-guarded ``ExecutionPlan`` JSON files."""

    def __init__(self, dir_path: Optional[str | Path] = None) -> None:
        self.dir = Path(dir_path) if dir_path is not None \
            else Path(default_plan_dir())
        self.loads = 0
        self.builds = 0

    def path_for(self, key: str) -> Path:
        return self.dir / f"{key}.json"

    def load(self, key: str) -> Optional[ExecutionPlan]:
        """The stored plan for ``key``, or None (missing/corrupt/stale)."""
        try:
            doc = json.loads(self.path_for(key).read_text())
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict) or doc.get("schema") != plan_schema_hash():
            return None
        try:
            plan = ExecutionPlan.from_dict(doc)
        except (KeyError, TypeError, ValueError):
            return None
        self.loads += 1
        return plan

    def save(self, plan: ExecutionPlan) -> Path:
        """Verify ``plan`` (a finding raises ``VerificationError`` and
        nothing is written), then write it atomically; returns the path."""
        from repro_torch.analysis.findings import VerificationError
        from repro_torch.analysis.verify import verify_plan
        from repro_torch.core.noc.simcache import atomic_write_text
        findings = verify_plan(plan)
        if findings:
            raise VerificationError(findings)
        self.dir.mkdir(parents=True, exist_ok=True)
        path = self.path_for(plan.key)
        atomic_write_text(path, plan.to_json())
        return path

    @staticmethod
    def _compatible(plan: ExecutionPlan, cfg: ModelConfig,
                    build_kwargs: dict) -> bool:
        """Was the stored plan built from this config, the way the caller
        asks to build?

        The key covers only (model, mesh, phase, dtype); the config's
        content (a registry edit keeps the name) and the build parameters
        that change a plan's content (objective, mapper space, an explicit
        token tile, gemm search on or off, a non-default NocConfig) are
        recorded in the plan and checked here: a mismatch is cold, and the
        plan is rebuilt."""
        from repro_torch.core.noc import NocConfig

        from .plan import config_digest
        if plan.config != config_digest(cfg):
            return False
        checks = {"objective": plan.objective, "tokens": plan.tokens}
        if build_kwargs.get("gemm_search", True):
            if not plan.gemms:
                return False
            checks["mapper_space"] = plan.mapper_space
        for key, have in checks.items():
            # None means "the builder's derived default": matches any
            req = build_kwargs.get(key)
            if req is not None and req != have:
                return False
        if plan.chips != build_kwargs.get("chips", 1):
            return False
        if plan.chips > 1 and \
                plan.package != build_kwargs.get("package", "mesh"):
            return False
        noc = repr(build_kwargs.get("noc_cfg") or NocConfig())
        return plan.noc == noc

    def get_or_build(self, cfg: ModelConfig, mesh_shape, phase: str,
                     **build_kwargs) -> tuple[ExecutionPlan, bool]:
        """(plan, built): load when warm, :func:`~.builder.build_plan` and
        save when cold.  ``build_kwargs`` go to the builder; a stored plan
        built under other parameters (:meth:`_compatible`) is cold and is
        rebuilt in place."""
        from .builder import build_plan, normalize_mesh
        key = plan_key(cfg.name, normalize_mesh(mesh_shape), phase,
                       str(cfg.dtype), build_kwargs.get("chips", 1),
                       build_kwargs.get("package", "mesh"))
        plan = self.load(key)
        if plan is not None and self._compatible(plan, cfg, build_kwargs):
            return plan, False
        plan = build_plan(cfg, mesh_shape, phase, **build_kwargs)
        self.save(plan)
        self.builds += 1
        return plan, True

