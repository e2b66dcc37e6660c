"""fmlint core (the port's copy of ``fm_spark_tpu/analysis/core.py``):
rule registry, finding model, suppressions, baseline.

The port's static-analysis framework. Three concerns stay apart:

- **Rules** are small functions registered with the :func:`rule`
  decorator; each receives a :class:`Context` (cached parsed sources)
  and returns :class:`Finding` objects. Rule modules
  (:mod:`.rules_obs`, :mod:`.rules_threads`, :mod:`.rules_torch`) never
  touch the runner (:func:`run_rules`).
- **Suppressions** are inline, per-line, and carry a REQUIRED written
  reason: ``# fmlint: disable=<rule>[,<rule>] -- <reason>``. A bare
  disable (no reason) does NOT suppress and is itself a finding
  (``suppression-hygiene``), as is a disable naming an unknown rule —
  conventions stay enforced *and explained* at the site that bends
  them.
- **The baseline** (``fmlint_baseline_torch.json``, committed) holds
  per-(rule, file) finding COUNTS, so a strict new rule can land while
  its existing debt burns down: a run fails only when some (rule, file)
  cell exceeds its baselined count; cells below it are reported as
  burn-down (and ``--write-baseline`` shrinks the file).

The scope is the port: :meth:`Context.package_files` walks
``fm_spark_tpu_torch/``, :meth:`Context.root_files` is the port's root
script (``chip_smoke.py``) and :meth:`Context.tests_blob` the port's
tests (``tests/test_torch_*.py``). The JAX package has its own pass.

Everything here is stdlib-only and uses relative imports, so
``python -m fm_spark_tpu_torch.tools.fmlint`` loads the package by path
and the lint runs where torch does not import.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Default committed baseline location (repo root).
BASELINE_FILE = "fmlint_baseline_torch.json"

#: The package the pass scans, and the port's root script.
PACKAGE = "fm_spark_tpu_torch"
ROOT_SCRIPTS = ("chip_smoke.py",)

#: The meta-rule findings of which are never suppressible (a
#: suppression that silences the suppression checker is a hole, not a
#: convention).
SUPPRESSION_RULE = "suppression-hygiene"

_DISABLE_RE = re.compile(
    r"#\s*fmlint:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
    r"(\s*--\s*(\S.*?))?\s*$")


# ------------------------------------------------------------------ findings

@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis finding, anchored to ``path:line``."""

    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    func: str = ""     # enclosing function ('' = module level)

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def render(self) -> str:
        ctx = self.func or "<module>"
        return f"{self.path}:{self.line} [{ctx}] {self.rule}: {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ------------------------------------------------------------------ registry

@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    doc: str
    fn: object  # Callable[[Context], Iterable[Finding]]


RULES: dict[str, Rule] = {}


def rule(rule_id: str, doc: str):
    """Register an analysis rule. ``doc`` is the one-line glossary entry
    (README's rule table renders it); the decorated function takes a
    :class:`Context` and yields/returns :class:`Finding` objects."""
    if not re.fullmatch(r"[a-z0-9]+(-[a-z0-9]+)*", rule_id):
        raise ValueError(f"rule id {rule_id!r} must be kebab-case")

    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, doc.strip(), fn)
        return fn

    return deco


def all_rules() -> list[Rule]:
    return [RULES[k] for k in sorted(RULES)]


# ------------------------------------------------------------------- context

@dataclasses.dataclass(frozen=True)
class Suppression:
    rules: tuple
    reason: str | None   # None = bare disable (does not suppress)
    line: int


class SourceFile:
    """One parsed source file (lazy AST; a syntax error is recorded,
    not raised — :func:`run_rules` reports it as a ``parse-error`` finding)."""

    def __init__(self, repo: str, rel: str):
        self.rel = rel.replace(os.sep, "/")
        self.path = os.path.join(repo, rel)
        with open(self.path) as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self._tree = None
        self._suppressions: dict[int, Suppression] | None = None
        self.parse_error: str | None = None

    @property
    def tree(self) -> ast.AST | None:
        if self._tree is None and self.parse_error is None:
            try:
                self._tree = ast.parse(self.source, filename=self.rel)
            except SyntaxError as e:
                self.parse_error = f"line {e.lineno}: {e.msg}"
        return self._tree

    def suppressions(self) -> dict[int, Suppression]:
        # Memoized like the AST: run_rules asks once per finding.
        if self._suppressions is None:
            out = {}
            for i, text in enumerate(self.lines, start=1):
                m = _DISABLE_RE.search(text)
                if not m:
                    continue
                rules = tuple(r.strip() for r in m.group(1).split(","))
                reason = m.group(3)
                out[i] = Suppression(rules, reason, i)
            self._suppressions = out
        return self._suppressions


class Context:
    """Shared state one analysis run hands every rule: the repo root
    and a parse cache. Rules pick their own scope through the file
    accessors; missing directories yield empty lists so rules behave
    on synthetic fixture repos."""

    def __init__(self, repo: str | None = None):
        self.repo = os.path.abspath(repo or REPO)
        self._cache: dict[str, SourceFile] = {}

    def file(self, rel: str) -> SourceFile | None:
        rel = rel.replace(os.sep, "/")
        sf = self._cache.get(rel)
        if sf is None:
            path = os.path.join(self.repo, rel)
            if not os.path.isfile(path):
                return None
            sf = self._cache[rel] = SourceFile(self.repo, rel)
        return sf

    def files_under(self, rel_dir: str, recursive: bool = True
                    ) -> list[SourceFile]:
        root = os.path.join(self.repo, rel_dir)
        if not os.path.isdir(root):
            return []
        out = []
        if recursive:
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                for fname in sorted(filenames):
                    if fname.endswith(".py"):
                        rel = os.path.relpath(
                            os.path.join(dirpath, fname), self.repo)
                        out.append(self.file(rel))
        else:
            for fname in sorted(os.listdir(root)):
                if fname.endswith(".py"):
                    out.append(self.file(os.path.join(rel_dir, fname)))
        return [f for f in out if f is not None]

    def package_files(self) -> list[SourceFile]:
        """Every module of the port (``fm_spark_tpu_torch/``)."""
        return self.files_under(PACKAGE)

    def root_files(self) -> list[SourceFile]:
        """The port's repo-root script (``chip_smoke.py``); the JAX
        package's ``bench*.py`` are the reference's, not scanned here."""
        out = [self.file(name) for name in ROOT_SCRIPTS]
        return [f for f in out if f is not None]

    def tests_blob(self) -> str:
        """The port's test sources (``tests/test_torch_*.py``),
        concatenated — the coverage rules' string-scan anchor
        (plans/phases/triggers are strings, so the name appearing in a
        port test IS the exercise anchor)."""
        texts = []
        for sf in self.files_under("tests", recursive=False):
            if os.path.basename(sf.rel).startswith("test_torch_"):
                texts.append(sf.source)
        return "\n".join(texts)

    def suppression_at(self, rel: str, line: int) -> Suppression | None:
        sf = self.file(rel)
        if sf is None:
            return None
        return sf.suppressions().get(line)


# -------------------------------------------------------------------- runner

def run_rules(ctx: Context | None = None,
              rules: list[str] | None = None
              ) -> tuple[list[Finding], list[tuple[Finding, str]]]:
    """Run ``rules`` (default: all registered) over ``ctx``.

    Returns ``(active, suppressed)`` — ``suppressed`` pairs each
    silenced finding with its written reason. A finding is suppressed
    only by a REASONED disable comment on its own line naming its rule;
    :data:`SUPPRESSION_RULE` findings are never suppressible.
    """
    ctx = ctx or Context()
    selected = ([RULES[r] for r in rules] if rules is not None
                else all_rules())
    active: list[Finding] = []
    suppressed: list[tuple[Finding, str]] = []
    for r in selected:
        for f in r.fn(ctx):
            sup = (None if f.rule == SUPPRESSION_RULE
                   else ctx.suppression_at(f.path, f.line))
            if (sup is not None and sup.reason
                    and f.rule in sup.rules):
                suppressed.append((f, sup.reason))
            else:
                active.append(f)
    active.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    suppressed.sort(key=lambda p: (p[0].path, p[0].line, p[0].rule))
    return active, suppressed


# ------------------------------------------------------------------ baseline

def counts_of(findings: list[Finding]) -> dict[str, dict[str, int]]:
    out: dict[str, dict[str, int]] = {}
    for f in findings:
        out.setdefault(f.rule, {})
        out[f.rule][f.path] = out[f.rule].get(f.path, 0) + 1
    return out


def load_baseline(path: str) -> dict[str, dict[str, int]]:
    """Per-(rule, file) baselined counts; a missing file is an empty
    baseline (every finding is new)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    counts = doc.get("counts", {}) if isinstance(doc, dict) else {}
    return {str(r): {str(p): int(n) for p, n in files.items()}
            for r, files in counts.items() if isinstance(files, dict)}


def write_baseline_counts(path: str,
                          counts: dict[str, dict[str, int]]) -> dict:
    """Atomically write ``counts`` as the baseline (dropping empty
    cells/rules so the file shrinks as debt burns down)."""
    counts = {r: {p: int(n) for p, n in files.items() if n}
              for r, files in counts.items()}
    counts = {r: files for r, files in counts.items() if files}
    doc = {
        "version": 1,
        "comment": ("fmlint baseline: per-(rule, file) finding counts "
                    "tolerated while they burn down. A run fails only "
                    "on counts ABOVE these; run python -m "
                    "fm_spark_tpu_torch.tools.fmlint --write-baseline "
                    "after paying debt down."),
        "counts": counts,
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return doc


def write_baseline(path: str, findings: list[Finding]) -> dict:
    return write_baseline_counts(path, counts_of(findings))


def compare_to_baseline(findings: list[Finding],
                        baseline: dict[str, dict[str, int]]) -> dict:
    """Split findings into new-vs-baselined per (rule, file) cell.

    A cell with MORE findings than its baseline count fails — all the
    cell's findings are listed (line drift makes "which exact one is
    new" unknowable from counts, and listing the cell is what a human
    needs anyway). Cells at-or-under budget are tracked; cells under
    budget are the burn-down report.
    """
    counts = counts_of(findings)
    new: list[Finding] = []
    baselined = 0
    burned: list[dict] = []
    for rule_id, files in counts.items():
        for path, n in files.items():
            allowed = baseline.get(rule_id, {}).get(path, 0)
            if n > allowed:
                new.extend(f for f in findings
                           if f.rule == rule_id and f.path == path)
            else:
                baselined += n
                if n < allowed:
                    burned.append({"rule": rule_id, "path": path,
                                   "baseline": allowed, "current": n})
    for rule_id, files in baseline.items():
        for path, allowed in files.items():
            if allowed and counts.get(rule_id, {}).get(path, 0) == 0:
                burned.append({"rule": rule_id, "path": path,
                               "baseline": allowed, "current": 0})
    new.sort(key=lambda f: (f.path, f.line, f.rule))
    burned.sort(key=lambda b: (b["rule"], b["path"]))
    return {"new": new, "baselined": baselined, "burned_down": burned}


# -------------------------------------------------------------------- report

def analyze(repo: str | None = None, baseline_path: str | None = None,
            rules: list[str] | None = None,
            run_id: str | None = None) -> dict:
    """One full analysis run → the JSON-ready report dict.

    ``ok`` is the gate: True iff no (rule, file) cell exceeds its
    baselined count. The report carries everything a renderer
    (``run_doctor``'s Static-analysis section, CI logs) needs: the
    rule glossary, per-cell counts, new findings, reasoned
    suppressions, and the burn-down ledger.
    """
    ctx = Context(repo)
    if baseline_path is None:
        baseline_path = os.path.join(ctx.repo, BASELINE_FILE)
    findings, suppressed = run_rules(ctx, rules=rules)
    baseline = load_baseline(baseline_path)
    cmp = compare_to_baseline(findings, baseline)
    return {
        "version": 1,
        "tool": "fmlint",
        "run_id": run_id,
        "repo": ctx.repo,
        "rules": {r.id: r.doc for r in all_rules()},
        "counts": counts_of(findings),
        "total_findings": len(findings),
        "new": [f.to_dict() for f in cmp["new"]],
        "baselined_total": cmp["baselined"],
        "burned_down": cmp["burned_down"],
        "baseline_path": baseline_path,
        "suppressed": [dict(f.to_dict(), reason=reason)
                       for f, reason in suppressed],
        "ok": not cmp["new"],
    }


def write_report(report: dict, out_dir: str,
                 filename: str = "fmlint.json") -> str | None:
    """Atomically write the report into ``out_dir`` (an
    ``artifacts/obs/<run_id>/`` run directory by convention) so
    ``run_doctor``/``obs_report`` render analysis regressions next to
    perf ones. Best-effort: a lint must never die on report IO."""
    try:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, filename)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path
    except OSError:
        return None


# ---------------------------------------------------------------- ast helpers

def call_name(node: ast.Call) -> str:
    """Dotted name of the called object, best-effort ('' if dynamic)."""
    parts = []
    f = node.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def walk_with_func(tree: ast.AST):
    """Yield ``(node, enclosing_function_name)`` for every node —
    the shared walk rules use to report the enclosing def."""
    stack: list[tuple[ast.AST, str | None]] = [(tree, None)]
    while stack:
        node, func = stack.pop()
        yield node, func
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        for child in ast.iter_child_nodes(node):
            stack.append((child, func))


def parse_errors(files) -> list[Finding]:
    """``parse-error`` findings for unparseable sources (the runner
    must report a broken file, not silently skip it)."""
    out = []
    for sf in files:
        sf.tree  # force the parse
        if sf.parse_error:
            out.append(Finding("parse-error", sf.rel, 1,
                               f"unparseable source: {sf.parse_error}"))
    return out
