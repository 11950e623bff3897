"""Serving metrics: TTFT / TPOT / latency percentiles, Little's law (a copy
of ``repro.serve.metrics``, which imports no JAX).

Summaries are plain-float dicts, rounded to a fixed precision and written
with sorted keys — byte-identical across runs of the same seed (no
wall-clock, no dict-order dependence; see tests/test_serve_cluster.py).
"""
from __future__ import annotations

_ROUND = 9


def percentile(xs: list[float], p: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    import math
    rank = max(1, math.ceil(p / 100.0 * len(xs)))
    return xs[rank - 1]


def _dist(xs: list[float]) -> dict:
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0, "max": 0.0}
    return {
        "mean": round(sum(xs) / len(xs), _ROUND),
        "p50": round(percentile(xs, 50), _ROUND),
        "p95": round(percentile(xs, 95), _ROUND),
        "p99": round(percentile(xs, 99), _ROUND),
        "max": round(max(xs), _ROUND),
    }


def time_in_system(records: list[dict]) -> float:
    """Time-averaged number of requests in the system (arrival..finish),
    over the span from first arrival to last finish."""
    if not records:
        return 0.0
    t0 = min(r["arrival"] for r in records)
    t1 = max(r["finish"] for r in records)
    if t1 <= t0:
        return 0.0
    area = sum(r["finish"] - r["arrival"] for r in records)
    return area / (t1 - t0)


def summarize(records: list[dict]) -> dict:
    """Aggregate per-request records into the serving metrics dict.

    Each record: ``arrival``, ``admit``, ``first_token``, ``finish``
    (seconds), ``prompt_len``, ``max_new``.
    """
    if not records:
        return {"requests": 0, "tokens_out": 0, "makespan_s": 0.0,
                "throughput_rps": 0.0, "throughput_tok_s": 0.0,
                "queueing_s": _dist([]), "ttft_s": _dist([]),
                "tpot_s": _dist([]), "e2e_s": _dist([]),
                "littles_law_ratio": 1.0}
    t0 = min(r["arrival"] for r in records)
    t1 = max(r["finish"] for r in records)
    makespan = t1 - t0
    tokens = sum(r["max_new"] for r in records)
    n = len(records)
    queueing = [r["admit"] - r["arrival"] for r in records]
    ttft = [r["first_token"] - r["arrival"] for r in records]
    e2e = [r["finish"] - r["arrival"] for r in records]
    tpot = [(r["finish"] - r["first_token"]) / (r["max_new"] - 1)
            for r in records if r["max_new"] > 1]

    # Little's law: L = lambda * W.  lambda is estimated from the observed
    # arrival span (not the makespan — that would make the identity hold
    # by construction), W is the mean time in system, and L is the
    # time-averaged occupancy integrated over the run; the ratio is a
    # consistency check on the event loop, ~1.0 up to finite-horizon edge
    # effects.  Degenerates to 1.0 for batch arrivals (zero span).
    arr_span = max(r["arrival"] for r in records) - t0
    lam = n / makespan if makespan > 0 else 0.0
    w = sum(e2e) / n
    l_direct = time_in_system(records)
    if arr_span > 0 and l_direct > 0:
        ratio = ((n - 1) / arr_span) * w / l_direct
    else:
        ratio = 1.0

    return {
        "requests": n,
        "tokens_out": tokens,
        "makespan_s": round(makespan, _ROUND),
        "throughput_rps": round(lam, _ROUND),
        "throughput_tok_s": round(tokens / makespan, _ROUND)
        if makespan > 0 else 0.0,
        "queueing_s": _dist(queueing),
        "ttft_s": _dist(ttft),
        "tpot_s": _dist(tpot),
        "e2e_s": _dist(e2e),
        "littles_law_ratio": round(ratio, _ROUND),
    }
