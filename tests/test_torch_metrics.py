"""The port's serving metrics (``repro_torch.serve.metrics``) against the
reference's ``repro.serve.metrics``: the same dicts on the same records."""
import numpy as np
import pytest

from repro.serve import metrics as ref
from repro_torch.serve import metrics as port
from repro_torch.serve import percentile, summarize


def _records(seed: int, n: int, batch: bool = False,
             max_new: int | None = None) -> list:
    """``n`` seeded request records: arrivals in order (all at 0 for a
    batch arrival), admission, first token and finish after them."""
    rng = np.random.default_rng(seed)
    arrival = np.zeros(n) if batch else np.cumsum(rng.exponential(0.05, n))
    admit = arrival + rng.exponential(0.01, n)
    first = admit + rng.uniform(0.005, 0.05, n)
    new = np.full(n, max_new) if max_new else rng.integers(1, 64, n)
    finish = first + (new - 1) * rng.uniform(0.001, 0.01, n)
    return [{"arrival": float(a), "admit": float(b), "first_token": float(c),
             "finish": float(d), "prompt_len": int(p), "max_new": int(m)}
            for a, b, c, d, p, m in zip(arrival, admit, first, finish,
                                        rng.integers(1, 512, n), new)]


CASES = {"empty": [], "single": _records(0, 1), "seeded": _records(1, 57),
         "batch_arrival": _records(2, 16, batch=True),
         "one_token_each": _records(3, 9, max_new=1),
         "mixed": _records(4, 200)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_summarize_matches_reference(name):
    records = CASES[name]
    assert summarize(records) == ref.summarize(records)
    assert port.time_in_system(records) == ref.time_in_system(records)


@pytest.mark.parametrize("name", sorted(CASES))
def test_percentile_matches_reference(name):
    xs = [r["finish"] - r["arrival"] for r in CASES[name]]
    for p in (0, 1, 50, 90, 95, 99, 99.9, 100):
        assert percentile(xs, p) == ref.percentile(xs, p)
    assert port._dist(xs) == ref._dist(xs)


def test_degenerate_cases_are_the_references():
    """The zero-span ratio is 1.0, a one-token request has no TPOT, an
    empty run is all zeros: the same on both sides."""
    batch = summarize(CASES["batch_arrival"])
    assert batch["littles_law_ratio"] == 1.0
    assert summarize(CASES["one_token_each"])["tpot_s"]["max"] == 0.0
    assert summarize([])["requests"] == 0
    assert port._ROUND == ref._ROUND == 9
