"""Serving engine of the port: scheduler, paged KV cache, engine, and the
serving metrics (:mod:`.metrics`)."""
from repro_torch.serve.metrics import percentile, summarize

__all__ = ["percentile", "summarize"]
