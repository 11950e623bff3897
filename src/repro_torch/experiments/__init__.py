"""Paper-evaluation sweep engine (Tables I/II, Figs 7-12, scaling studies;
the port's copy of ``repro.experiments``).

``python -m repro_torch.experiments`` runs the evaluation of the INA paper
through the plan-keyed simulation cache and emits per-figure JSON plus a
markdown summary into ``results/`` — see EXPERIMENTS.md for the CLI and
the cache design.  Every section but the reference's ``faults`` is ported.
"""
from .sweeps import (DEFAULT_SWEEP, QUICK_SWEEP, SweepConfig, run_all,
                     run_fig7_9, run_fig10_12, run_mesh_scaling, run_tables)

__all__ = ["SweepConfig", "DEFAULT_SWEEP", "QUICK_SWEEP", "run_tables",
           "run_fig7_9", "run_fig10_12", "run_mesh_scaling", "run_all"]
