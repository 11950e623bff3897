"""Execution helpers: wall-clock durations (``timing``) and the
deterministic process-pool fan-out (``pool``)."""
from .pool import default_jobs, parallel_map

__all__ = ["default_jobs", "parallel_map"]
