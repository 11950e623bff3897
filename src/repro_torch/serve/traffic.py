"""Seeded request workloads: Poisson arrivals, length laws, trace replay
(a copy of ``repro.serve.traffic``).

Everything routes through one ``random.Random(seed)`` stream so a workload
is a pure function of its parameters — the foundation of the simulator's
byte-identical-metrics guarantee (same seed, same JSON).

Length specs are small strings so they can ride CLI flags and sweep
configs: ``fixed:64``, ``uniform:16:128``, ``lognormal:64:0.5:512``
(median, sigma, max).
"""
from __future__ import annotations

import json
import random

from repro_torch.serve.batching import Request


def parse_length_dist(spec: str):
    """A ``rng -> int`` sampler from a distribution spec string."""
    parts = spec.split(":")
    kind = parts[0]
    if kind == "fixed":
        n = int(parts[1])
        return lambda rng: n
    if kind == "uniform":
        lo, hi = int(parts[1]), int(parts[2])
        if lo > hi:
            raise ValueError(f"uniform bounds reversed in {spec!r}")
        return lambda rng: rng.randint(lo, hi)
    if kind == "lognormal":
        import math
        median, sigma, cap = float(parts[1]), float(parts[2]), int(parts[3])
        mu = math.log(median)
        return lambda rng: max(1, min(cap,
                                      round(rng.lognormvariate(mu, sigma))))
    raise ValueError(f"unknown length distribution {spec!r} "
                     "(fixed:N | uniform:LO:HI | lognormal:MED:SIGMA:MAX)")


def poisson_arrivals(qps: float, n: int, rng: random.Random) -> list[float]:
    """``n`` cumulative arrival times at rate ``qps`` (exponential gaps);
    ``qps <= 0`` means everything arrives at t=0 (offline batch)."""
    if qps <= 0:
        return [0.0] * n
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(qps)
        out.append(t)
    return out


def make_workload(n: int, qps: float, prompt_dist: str, gen_dist: str,
                  seed: int, vocab: int | None = None,
                  prefix: str = "r") -> list[Request]:
    """``n`` seeded requests; with ``vocab``, prompts carry real token ids
    (engine-executable), otherwise lengths only (simulator)."""
    rng = random.Random(seed)
    prompts = parse_length_dist(prompt_dist)
    gens = parse_length_dist(gen_dist)
    arrivals = poisson_arrivals(qps, n, rng)
    out = []
    for i, t in enumerate(arrivals):
        plen = prompts(rng)
        gen = gens(rng)
        tokens = None
        if vocab is not None:
            tokens = tuple(rng.randrange(3, vocab) for _ in range(plen))
        out.append(Request(rid=f"{prefix}{i:04d}", prompt_len=plen,
                           max_new=gen, arrival=t, prompt=tokens))
    return out


def load_trace(path: str) -> list[Request]:
    """Replay a recorded trace: a JSON list of ``{"t": float,
    "prompt_len": int, "max_new": int}`` objects (optional ``"priority"``,
    ``"rid"``)."""
    with open(path) as fh:
        rows = json.load(fh)
    out = []
    for i, row in enumerate(rows):
        out.append(Request(
            rid=str(row.get("rid", f"t{i:04d}")),
            prompt_len=int(row["prompt_len"]), max_new=int(row["max_new"]),
            arrival=float(row["t"]), priority=int(row.get("priority", 0))))
    return sorted(out, key=lambda r: (r.arrival, r.rid))
