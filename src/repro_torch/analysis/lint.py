"""Determinism lint: AST rules over ``src/repro_torch`` (a copy of
``repro.analysis.lint``, DESIGN.md S13, scoped to the port's modules).

The repo's artifacts are byte-deterministic by contract — simcache keys,
plan JSON, serve capacity reports, the seeded cluster sim.  This pass
checks the source-level habits that break that contract, with a small
registry of named rules:

``unseeded-random``
    Module-level ``random.*`` / ``numpy.random.*`` stream use (or a
    zero-argument ``Random()``/``default_rng()``) in sim/cost/plan/serve
    modules.  Seeded generator objects (``random.Random(seed)``) pass.
``wall-clock``
    ``time.time()``-family or ``datetime.now()``-family reads in the same
    modules; durations belong in ``repro_torch.exec.timing.Stopwatch``
    (reporting modules like ``experiments/`` are out of scope — timing
    *is* their output).
``set-iteration``
    Iteration over a known-``set``-typed expression in an order-sensitive
    position (a ``for`` loop, a list/dict/generator comprehension,
    ``list()``/``tuple()``/``join()``) — set order varies with PYTHONHASHSEED
    for str/bytes keys and with insertion history otherwise.  Wrapping in
    ``sorted()`` (or folding through ``len``/``sum``/``min``/``max``/
    ``any``/``all``/``set``/``frozenset``) is the fix and is recognised.
    Known-set expressions are inferred per module: ``set``/``frozenset``
    constructors and literals, set operators, and any name or attribute
    annotated ``set``/``frozenset`` anywhere in the module.
``mutable-default``
    A ``list``/``dict``/``set`` literal or constructor as a parameter
    default (shared across calls).
``non-atomic-write``
    ``open(path, "w")`` / ``Path.write_text`` in persistence-bearing
    modules — artifacts must go through ``simcache.atomic_write_text`` so
    a crashed writer never leaves a torn file for the next reader.

Suppress a justified finding with a pragma on the offending line or the
line above::

    with open(lock_path, "w"):   # lint: allow(non-atomic-write)

``lint_paths()`` returns machine-readable :class:`~.findings.Finding`s;
``python -m repro_torch.analysis lint src/repro_torch`` is the CLI.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from pathlib import Path
from typing import Callable, Optional, Sequence

from .findings import Finding

#: Modules bound to the determinism contract: simulation/cost (the heap,
#: compiled, and vectorized engines — ``core/noc/`` is a prefix, so
#: ``core/noc/vectorized.py`` is in scope like the rest), planning,
#: serving, mapper search, the fault-tolerant runtime.  experiments/,
#: launch/, exec/ stay out — they report wall time and write logs by
#: design (duration reporting routes through ``exec.timing.Stopwatch``).
_DETERMINISM_SCOPE = ("repro_torch/core/noc/", "repro_torch/plan/",
                      "repro_torch/serve/", "repro_torch/mapper/",
                      "repro_torch/runtime/")

PRAGMA = "lint: allow"
_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([a-z-]+(?:\s*,\s*[a-z-]+)*)\)")


@dataclasses.dataclass(frozen=True)
class LintRule:
    """One registered rule: a pure function over a module's AST."""

    name: str
    description: str
    #: Path fragments the rule applies to; empty tuple = every file.
    scope: tuple[str, ...]
    #: (tree, source) -> [(lineno, message), ...]
    check: Callable[[ast.Module, str], list]


# --------------------------------------------------------------------------- #
# Shared AST helpers
# --------------------------------------------------------------------------- #
def _module_aliases(tree: ast.Module) -> dict[str, str]:
    """Local name -> dotted origin for imports (``np`` -> ``numpy``,
    ``from time import time`` -> ``time`` -> ``time.time``)."""
    alias: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                alias[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                alias[a.asname or a.name] = f"{node.module}.{a.name}"
    return alias


def _dotted(node: ast.expr, alias: dict[str, str]) -> Optional[str]:
    """Resolve an attribute chain / name to its dotted import origin."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(alias.get(node.id, node.id))
    return ".".join(reversed(parts))


# --------------------------------------------------------------------------- #
# unseeded-random
# --------------------------------------------------------------------------- #
_RANDOM_CTORS = {"random.Random", "numpy.random.default_rng",
                 "numpy.random.RandomState", "numpy.random.Generator"}


def _check_unseeded_random(tree: ast.Module, src: str) -> list:
    alias = _module_aliases(tree)
    hits = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func, alias)
        if dotted is None:
            continue
        if dotted in _RANDOM_CTORS:
            if not node.args and not node.keywords:
                hits.append((node.lineno,
                             f"{dotted}() without a seed is entropy-seeded; "
                             f"pass an explicit seed"))
            continue
        if dotted.startswith("random.") or dotted.startswith("numpy.random."):
            hits.append((node.lineno,
                         f"{dotted}() draws from the global stream; use a "
                         f"seeded Random/Generator object instead"))
    return hits


# --------------------------------------------------------------------------- #
# wall-clock
# --------------------------------------------------------------------------- #
_WALL_CLOCK = {"time.time", "time.time_ns", "time.monotonic",
               "time.monotonic_ns", "time.perf_counter",
               "time.perf_counter_ns", "time.process_time",
               "datetime.datetime.now", "datetime.datetime.utcnow",
               "datetime.date.today"}


def _check_wall_clock(tree: ast.Module, src: str) -> list:
    alias = _module_aliases(tree)
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func, alias)
            if dotted in _WALL_CLOCK:
                hits.append((node.lineno,
                             f"{dotted}() reads the wall clock; route "
                             f"timing through "
                             f"repro_torch.exec.timing.Stopwatch "
                             f"(keeps artifacts time-free)"))
    return hits


# --------------------------------------------------------------------------- #
# mutable-default
# --------------------------------------------------------------------------- #
def _is_mutable_literal(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set,
                         ast.ListComp, ast.DictComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("list", "dict", "set", "defaultdict",
                                 "Counter", "OrderedDict", "deque"))


def _check_mutable_default(tree: ast.Module, src: str) -> list:
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            defaults = list(node.args.defaults) + \
                [d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if _is_mutable_literal(d):
                    hits.append((d.lineno,
                                 "mutable default argument is shared "
                                 "across calls; default to None"))
    return hits


# --------------------------------------------------------------------------- #
# non-atomic-write
# --------------------------------------------------------------------------- #
def _check_non_atomic_write(tree: ast.Module, src: str) -> list:
    hits = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "open":
            mode = None
            if len(node.args) >= 2:
                mode = node.args[1]
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
                    and ("w" in mode.value or "a" in mode.value):
                hits.append((node.lineno,
                             "direct open() write can leave a torn file; "
                             "use simcache.atomic_write_text"))
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr == "write_text":
            hits.append((node.lineno,
                         "Path.write_text is not atomic; use "
                         "simcache.atomic_write_text"))
    return hits


# --------------------------------------------------------------------------- #
# set-iteration
# --------------------------------------------------------------------------- #
_SET_ANN_RE = re.compile(r"\b(?:frozenset|set|Set|FrozenSet|AbstractSet)\b")
_SET_METHODS = ("union", "intersection", "difference",
                "symmetric_difference", "copy")
#: Order-insensitive consumers: iterating a set *inside* these is fine.
_UNORDERED_SINKS = ("sorted", "min", "max", "sum", "len", "any", "all",
                    "set", "frozenset")


def _annotated_set_names(tree: ast.Module) -> set:
    """Names/attributes annotated ``set``/``frozenset`` anywhere in the
    module (incl. function return annotations, so properties count)."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.AnnAssign) and node.annotation is not None:
            if _SET_ANN_RE.search(ast.unparse(node.annotation)):
                target = node.target
                if isinstance(target, ast.Name):
                    names.add(target.id)
                elif isinstance(target, ast.Attribute):
                    names.add(target.attr)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.returns is not None \
                    and _SET_ANN_RE.search(ast.unparse(node.returns)):
                names.add(node.name)
        elif isinstance(node, ast.arg) and node.annotation is not None:
            if _SET_ANN_RE.search(ast.unparse(node.annotation)):
                names.add(node.arg)
    return names


class _SetIterationVisitor(ast.NodeVisitor):
    _MSG = ("iteration order of a set depends on hashing; wrap in "
            "sorted() or fold through an order-insensitive reducer")

    def __init__(self, set_names, exempt):
        self.set_names = set_names
        self.exempt = exempt          # node ids under an unordered sink
        self.local_sets: set = set()
        self.hits: list = []

    # -- known-set expression inference -------------------------------- #
    def _is_set(self, node) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                return f.id in ("set", "frozenset") or f.id in self.set_names
            if isinstance(f, ast.Attribute):
                if f.attr in _SET_METHODS and self._is_set(f.value):
                    return True
                return f.attr in self.set_names
            return False
        if isinstance(node, ast.Attribute):
            return node.attr in self.set_names
        if isinstance(node, ast.Name):
            return node.id in self.local_sets
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            return self._is_set(node.left) or self._is_set(node.right)
        if isinstance(node, ast.IfExp):
            return self._is_set(node.body) or self._is_set(node.orelse)
        return False

    # -- local tracking (in source order; one flat namespace is enough
    #    for lint purposes — shadowing across scopes over-approximates) - #
    def visit_Assign(self, node):
        self.generic_visit(node)
        for target in node.targets:
            if isinstance(target, ast.Name):
                if self._is_set(node.value):
                    self.local_sets.add(target.id)
                else:
                    self.local_sets.discard(target.id)

    def visit_AugAssign(self, node):
        self.generic_visit(node)
        if isinstance(node.target, ast.Name) and self._is_set(node.value):
            self.local_sets.add(node.target.id)

    # -- order-sensitive positions -------------------------------------- #
    def visit_For(self, node):
        if self._is_set(node.iter):
            self.hits.append((node.iter.lineno, self._MSG))
        self.generic_visit(node)

    def _visit_comp(self, node):
        if id(node) not in self.exempt:
            for gen in node.generators:
                if self._is_set(gen.iter):
                    self.hits.append((gen.iter.lineno, self._MSG))
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp
    # SetComp deliberately not order-sensitive: a set in, a set out.

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("list", "tuple") \
                and len(node.args) == 1 and self._is_set(node.args[0]):
            self.hits.append((node.lineno, self._MSG))
        elif isinstance(f, ast.Attribute) and f.attr == "join" \
                and node.args and self._is_set(node.args[0]):
            self.hits.append((node.lineno, self._MSG))
        self.generic_visit(node)


def _check_set_iteration(tree: ast.Module, src: str) -> list:
    set_names = _annotated_set_names(tree)
    exempt: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        sinkish = (isinstance(f, ast.Name) and f.id in _UNORDERED_SINKS) or \
            (isinstance(f, ast.Attribute) and f.attr in _SET_METHODS)
        if sinkish:
            for a in node.args:
                exempt.add(id(a))
    visitor = _SetIterationVisitor(set_names, exempt)
    visitor.visit(tree)
    return visitor.hits


# --------------------------------------------------------------------------- #
# Registry and driver
# --------------------------------------------------------------------------- #
LINT_RULES: dict[str, LintRule] = {
    r.name: r for r in (
        LintRule("unseeded-random",
                 "global random stream / unseeded generator in "
                 "determinism-scoped modules",
                 _DETERMINISM_SCOPE, _check_unseeded_random),
        LintRule("wall-clock",
                 "wall-clock read in determinism-scoped modules",
                 _DETERMINISM_SCOPE, _check_wall_clock),
        LintRule("set-iteration",
                 "order-sensitive iteration over a set-typed expression",
                 (), _check_set_iteration),
        LintRule("mutable-default",
                 "mutable default argument",
                 (), _check_mutable_default),
        LintRule("non-atomic-write",
                 "persisted write bypassing atomic_write_text",
                 _DETERMINISM_SCOPE, _check_non_atomic_write),
    )
}


def _pragma_allows(lines: list, lineno: int, rule: str) -> bool:
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _PRAGMA_RE.search(lines[ln - 1])
            if m and rule in [s.strip() for s in m.group(1).split(",")]:
                return True
    return False


def count_pragmas(paths: Sequence) -> int:
    """Total ``# lint: allow`` pragmas under ``paths`` (budget metric)."""
    total = 0
    for f in _py_files(paths):
        total += len(_PRAGMA_RE.findall(f.read_text()))
    return total


def _py_files(paths: Sequence) -> list:
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files


def lint_file(path, rules: Optional[Sequence[LintRule]] = None
              ) -> list[Finding]:
    path = Path(path)
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as exc:
        return [Finding("parse-error", f"{path}:{exc.lineno}", str(exc))]
    lines = src.splitlines()
    try:
        display = os.path.relpath(path)
    except ValueError:
        display = str(path)
    posix = "/" + path.resolve().as_posix().lstrip("/")
    out: list = []
    for rule in (rules if rules is not None else LINT_RULES.values()):
        if rule.scope and not any(f"/{frag}" in posix
                                  for frag in rule.scope):
            continue
        for lineno, message in rule.check(tree, src):
            if _pragma_allows(lines, lineno, rule.name):
                continue
            out.append((lineno, Finding(rule.name, f"{display}:{lineno}",
                                        message)))
    return [f for _, f in sorted(out, key=lambda x: (x[0], x[1].check))]


def lint_paths(paths: Sequence,
               rules: Optional[Sequence[LintRule]] = None) -> list[Finding]:
    """Run the registry (or ``rules``) over every ``*.py`` under
    ``paths``; returns pragma-filtered findings in (file, line) order."""
    findings: list[Finding] = []
    for f in _py_files(paths):
        findings.extend(lint_file(f, rules))
    return findings
