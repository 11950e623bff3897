"""The port's determinism linter and its ``python -m repro_torch.analysis``
CLI, against the reference's (``repro.analysis.lint`` and
``repro.analysis.__main__``).

* Each rule's snippet, written under ``repro_torch/<dir>/`` for the port's
  :func:`lint_file` and under ``repro/<dir>/`` for the reference's, gives
  the same ``(check, line)`` list, the determinism scope's boundary and the
  pragma cases included; each package's scope ends at its own tree.
* ``lint_paths([src/repro_torch])`` has no finding, and the port adds no
  more pragmas than the reference's budget of 5 over all of ``src``
  allows.
* One ``verify --quick`` run over collectives, ws, hierarchy, faults and
  kvcache gives the reference CLI's section artifact counts and the same
  findings JSON (``count`` 0, ``command``, ``sections``).
* ``lint`` on a bad file exits 1 with one ``wall-clock`` finding, and an
  unknown section exits 2.
"""
import json
import re
from pathlib import Path
from textwrap import dedent

import pytest

from repro.analysis.__main__ import main as jmain
from repro.analysis.lint import count_pragmas as jcount_pragmas
from repro.analysis.lint import lint_file as jlint_file

from repro_torch.analysis import LINT_RULES, lint_paths
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.lint import count_pragmas, lint_file

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

SNIPPETS = {
    "unseeded-random": ("plan/mod.py", """\
        import random
        import numpy as np
        x = random.random()
        r = random.Random(7)
        g = np.random.default_rng(0)
        h = np.random.default_rng()
        """),
    "wall-clock": ("serve/mod.py", """\
        import time
        import datetime
        from time import perf_counter
        t0 = time.time()
        t1 = perf_counter()
        d = datetime.datetime.now()
        """),
    "wall-clock-out-of-scope": ("experiments/m.py", """\
        import time
        t0 = time.time()
        """),
    "set-iteration": ("anywhere/mod.py", """\
        s = {1, 2, 3}
        for x in s:                  # flagged
            print(x)
        for x in sorted(s):          # sorted: fine
            print(x)
        items = list(s)              # flagged
        keep = {x for x in s}        # set comprehension: set in, set out
        total = sum(x for x in s)    # order-insensitive reducer
        names: set = set()
        joined = ",".join(names)     # flagged: annotated set
        """),
    "mutable-default+non-atomic-write": ("runtime/mod.py", """\
        from pathlib import Path
        def f(acc=[]):
            return acc
        def g(acc=None):
            return acc
        def dump(p, text):
            with open(p, "w") as fh:
                fh.write(text)
            Path(p).write_text(text)
        data = open("x").read()
        """),
    "pragma-named-rule": ("mapper/mod.py", """\
        import time
        t = time.time()   # lint: allow(wall-clock)
        # lint: allow(non-atomic-write)
        open("lock", "w")
        """),
    "pragma-other-rule": ("core/noc/mod.py", """\
        import time
        t = time.time()   # lint: allow(set-iteration)
        """),
}


def _snippet(tmp_path, top: str, rel: str, code: str) -> Path:
    f = tmp_path / top / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(dedent(code))
    return f


def _lines(findings) -> list:
    return [(f.check, int(f.where.rsplit(":", 1)[1])) for f in findings]


@pytest.mark.parametrize("case", sorted(SNIPPETS))
def test_lint_rules_match_reference(tmp_path, case):
    """The port's rules, under ``repro_torch/``, find what the reference's
    find under ``repro/``; and neither package's scoped rules reach into
    the other's tree (only the unscoped set-iteration and mutable-default
    rules do)."""
    rel, code = SNIPPETS[case]
    mine = _lines(lint_file(_snippet(tmp_path, "repro_torch", rel, code)))
    ref = _lines(jlint_file(_snippet(tmp_path, "repro", rel, code)))
    assert mine == ref
    if case in ("wall-clock", "unseeded-random"):
        assert mine and {c for c, _ in mine} == {case}
    unscoped = {name for name, r in LINT_RULES.items() if not r.scope}
    crossed = _lines(lint_file(tmp_path / "repro" / rel))
    assert crossed == [(c, n) for c, n in ref if c in unscoped]
    assert _lines(jlint_file(tmp_path / "repro_torch" / rel)) == \
        [(c, n) for c, n in mine if c in unscoped]


def test_lint_registry_matches_reference():
    from repro.analysis.lint import LINT_RULES as JRULES
    assert list(LINT_RULES) == list(JRULES)
    for name, rule in LINT_RULES.items():
        assert rule.description == JRULES[name].description
        assert rule.scope == tuple(s.replace("repro/", "repro_torch/", 1)
                                   for s in JRULES[name].scope)


def test_lint_port_zero_findings_within_pragma_budget():
    """No finding over the port; its pragmas (the linter's docstring
    example and the sim store's lock file) leave all of ``src`` within
    the reference's budget of 5, counted alike by both packages."""
    assert lint_paths([PORT]) == []
    assert count_pragmas([PORT]) == jcount_pragmas([PORT]) == 2
    assert count_pragmas([SRC]) <= 5


VERIFY_SECTIONS = "collectives,ws,hierarchy,faults,kvcache"


def _verify(fn, out: Path, capsys) -> tuple:
    rc = fn(["verify", "--quick", "--sections", VERIFY_SECTIONS,
             "--json", str(out)])
    counts = dict(re.findall(r"\[analysis\] verify (\w+): (\d+) artifact",
                             capsys.readouterr().out))
    return rc, counts, json.loads(out.read_text())


def test_cli_verify_matches_reference(tmp_path, capsys):
    rc, counts, doc = _verify(main, tmp_path / "port.json", capsys)
    jrc, jcounts, jdoc = _verify(jmain, tmp_path / "ref.json", capsys)
    assert rc == jrc == 0
    assert counts == jcounts and list(counts) == VERIFY_SECTIONS.split(",")
    assert doc == jdoc
    assert doc["count"] == 0 and doc["command"] == "verify"
    assert doc["sections"] == VERIFY_SECTIONS.split(",")


def test_cli_lint_and_unknown_section(tmp_path, capsys):
    out = tmp_path / "findings.json"
    bad = _snippet(tmp_path, "repro_torch", "plan/bad.py",
                   "import time\nt = time.time()\n")
    assert main(["lint", str(bad), "--json", str(out)]) == 1
    doc = json.loads(out.read_text())
    assert doc["count"] == 1 and doc["command"] == "lint"
    assert doc["findings"][0]["check"] == "wall-clock"
    assert "repro_torch.exec.timing.Stopwatch" in \
        doc["findings"][0]["message"]
    assert main(["lint", str(PORT)]) == 0
    assert main(["verify", "--sections", "kvcache,nope"]) == 2
    capsys.readouterr()
