"""fmlint's observability and fault-plane rules over the port (the
port of ``fm_spark_tpu/analysis/rules_obs.py``, scoped to
``fm_spark_tpu_torch/``). The rules (ids are what ``# fmlint: disable=``
names):

``eventlog-only``        strict scope: no print/json.dump/sys.std* in
                         resilience/, serve/, the ingest stream modules
``bare-print``           library-wide: no bare ``print()`` outside the
                         CLI modules and ``tools/``
``kernel-fallback``      kernel wrappers under ops/ raise
                         KernelUnavailable, never assert / bare
                         ValueError
``wallclock-duration``   durations use perf_counter/monotonic, never
                         ``time.time()`` in a subtraction
``leg-provenance``       the port's benchmark's leg_record carries
                         run_id+fingerprint (nothing to scan, and no
                         finding, until that benchmark exists)
``registry-coverage``    every fault point / watchdog phase / introspect
                         trigger appears in at least one port test
``trace-propagation``    outbound HTTP requests from serve/ carry the
                         X-FM-Trace context header
``fleet-transport-discipline`` serve/ opens replica connections only
                         through the netfault-aware transport, never
                         raw http.client/socket
``durable-write-discipline`` checkpoint.py / obs/ / embed/ write
                         durable artifacts only through utils/durable,
                         never raw open-for-write or os.rename
``parse-error``          every scanned source must parse

Plus the framework's own meta-rule, ``suppression-hygiene``: a
``# fmlint: disable=`` comment with no ``-- reason`` does not suppress
and is itself a finding, as is one naming a rule that does not exist.
"""

from __future__ import annotations

import ast
import os

from .core import Finding, call_name, parse_errors, rule, walk_with_func

# --------------------------------------------------------------- scope config

#: The strict EventLog-only surface: resilience/ and serve/ entirely,
#: plus the ingest-stream modules whose quarantine/abort transitions
#: carry the same machine-readability contract.
STRICT_DIRS = ("fm_spark_tpu_torch/resilience", "fm_spark_tpu_torch/serve")
STRICT_EXTRA_FILES = (
    "fm_spark_tpu_torch/data/stream.py",
    "fm_spark_tpu_torch/data/native_stream.py",
    "fm_spark_tpu_torch/native/__init__.py",
    "fm_spark_tpu_torch/online.py",
)

#: (basename, enclosing function) pairs exempt from the JSON-write rule
#: — faults.py::_next_count persists cross-process occurrence COUNTERS,
#: bookkeeping the injection harness needs before a journal can exist.
EVENTLOG_ALLOWLIST = {
    ("faults.py", "_next_count"),
    # HTTP wire-format seams: request/response bodies and
    # the replica port file are protocol payloads, not journal events
    # — each module funnels its json.dumps through exactly one helper.
    ("frontdoor.py", "_json_body"),
    ("fleet.py", "_json_body"),
}

#: Top-level library modules whose stdout IS their interface.
CLI_EXEMPT = frozenset({"cli.py", "cli_levers.py", "__main__.py"})

#: The operational tools (``python -m fm_spark_tpu_torch.tools.<name>``):
#: command-line programs whose stdout is their interface, like the CLI.
TOOLS_DIR = "fm_spark_tpu_torch/tools"

#: The kernel wrappers: modules of this directory that import the kernel
#: build (``fm_spark_tpu_torch.kernels``) — each launches a CUDA kernel.
KERNEL_DIR = "fm_spark_tpu_torch/ops"
KERNEL_BUILD_MODULE = "fm_spark_tpu_torch.kernels"

#: Where the port's benchmark keeps its per-leg records: a ``bench*.py``
#: module of the package, or a root ``bench_torch*.py`` script. None of
#: them exists until the port's benchmark lands, and ``leg-provenance``
#: reports nothing then (the JAX package's ``bench.py`` is the
#: reference's, linted by the reference's pass).
BENCH_GLOBS = ("fm_spark_tpu_torch/**/bench*.py", "bench_torch*.py")

LEG_RECORD_REQUIRED_KEYS = ("run_id", "fingerprint")

#: (registry kind, module holding it, literal name) — the coverage
#: rule's anchors: a registered point/phase/trigger no port test
#: names is a recovery/capture path that can rot silently.
COVERAGE_REGISTRIES = (
    ("fault point", "fm_spark_tpu_torch/resilience/faults.py", "KNOWN_POINTS"),
    ("watchdog phase", "fm_spark_tpu_torch/resilience/watchdog.py",
     "KNOWN_PHASES"),
    ("introspection trigger", "fm_spark_tpu_torch/obs/introspect.py",
     "TRIGGERS"),
)


def _strict_files(ctx):
    out = []
    for d in STRICT_DIRS:
        out.extend(ctx.files_under(d, recursive=False))
    for rel in STRICT_EXTRA_FILES:
        sf = ctx.file(rel)
        if sf is not None:
            out.append(sf)
    return out


# --------------------------------------------------------------------- rules

@rule("parse-error",
      "every scanned source file must parse — a broken file is a "
      "finding, never a silently shrunk scan")
def parse_error_rule(ctx):
    return parse_errors(ctx.package_files() + ctx.root_files())


@rule("eventlog-only",
      "resilience/serve/ingest state transitions go through "
      "utils/logging.EventLog — no print, no ad-hoc json.dump, no "
      "sys.stdout/stderr writes")
def eventlog_only(ctx):
    out = []
    for sf in _strict_files(ctx):
        tree = sf.tree
        if tree is None:
            continue
        base = os.path.basename(sf.rel)
        for node, func in walk_with_func(tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name == "print":
                out.append(Finding(
                    "eventlog-only", sf.rel, node.lineno,
                    "bare print() — emit a journal event "
                    "(utils/logging.EventLog) instead", func or ""))
            elif name in ("json.dump", "json.dumps"):
                if (base, func) not in EVENTLOG_ALLOWLIST:
                    out.append(Finding(
                        "eventlog-only", sf.rel, node.lineno,
                        f"ad-hoc JSON write ({name}) — state "
                        "transitions go through EventLog, not "
                        "hand-rolled JSON", func or ""))
            elif name in ("sys.stdout.write", "sys.stderr.write"):
                out.append(Finding(
                    "eventlog-only", sf.rel, node.lineno,
                    f"direct {name} — emit a journal event instead",
                    func or ""))
    return out


@rule("bare-print",
      "no bare print() anywhere in library code — numbers go to the "
      "metrics registry, narrative to EventLog/spans; the CLI modules "
      "and tools/ are exempt")
def bare_print(ctx):
    out = []
    for sf in ctx.package_files():
        base = os.path.basename(sf.rel)
        if (base in CLI_EXEMPT
                and os.path.dirname(sf.rel) == "fm_spark_tpu_torch"):
            continue
        if os.path.dirname(sf.rel) == TOOLS_DIR:
            continue
        tree = sf.tree
        if tree is None:
            continue
        for node, func in walk_with_func(tree):
            if (isinstance(node, ast.Call)
                    and call_name(node) == "print"
                    and not any(kw.arg == "file"
                                for kw in node.keywords)):
                out.append(Finding(
                    "bare-print", sf.rel, node.lineno,
                    "bare print() in library code — use MetricsLogger/"
                    "EventLog/obs APIs (fm_spark_tpu_torch.obs) instead",
                    func or ""))
    return out


def _is_kernel_module(tree) -> bool:
    """A module that imports the kernel build is a kernel wrapper."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == KERNEL_BUILD_MODULE
                or node.module.startswith(KERNEL_BUILD_MODULE + ".")):
            return True
        if isinstance(node, ast.Import) and any(
                a.name.startswith(KERNEL_BUILD_MODULE) for a in node.names):
            return True
    return False


@rule("kernel-fallback",
      "kernel wrappers under ops/ raise ops.KernelUnavailable — never "
      "assert, never bare ValueError — so a refusal is the structured "
      "signal the off/auto/require levers read, not a crash")
def kernel_fallback(ctx):
    out = []
    for sf in ctx.files_under(KERNEL_DIR, recursive=False):
        tree = sf.tree
        if tree is None or not _is_kernel_module(tree):
            continue
        for node, func in walk_with_func(tree):
            if isinstance(node, ast.Assert):
                out.append(Finding(
                    "kernel-fallback", sf.rel, node.lineno,
                    "assert in a kernel wrapper — raise "
                    "ops.KernelUnavailable with the reason the kernel "
                    "cannot serve this request instead of dying",
                    func or ""))
            elif (isinstance(node, ast.Raise)
                  and isinstance(node.exc, ast.Call)):
                f = node.exc.func
                name = f.id if isinstance(f, ast.Name) else (
                    f.attr if isinstance(f, ast.Attribute) else "")
                if name == "ValueError":
                    out.append(Finding(
                        "kernel-fallback", sf.rel, node.lineno,
                        "bare ValueError in a kernel wrapper — raise "
                        "ops.KernelUnavailable (the structured refusal "
                        "the fused_embed levers pin)", func or ""))
    return out


def _time_aliases(tree: ast.AST) -> tuple[set, set]:
    """The file's actual names for the time module and ``time.time``
    itself — ``import time as t`` / ``from time import time as now``
    must not evade the duration rule."""
    mods = {"time", "_time"}
    funcs = {"time"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    mods.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name == "time":
                    funcs.add(a.asname or a.name)
    return mods, funcs


def _is_wallclock_call(node, mods, funcs) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Name):
        return f.id in funcs
    if isinstance(f, ast.Attribute) and f.attr == "time":
        return isinstance(f.value, ast.Name) and f.value.id in mods
    return False


@rule("wallclock-duration",
      "time.time() inside a subtraction is a wall-clock DURATION — "
      "measured intervals go through time.perf_counter()/"
      "time.monotonic(); wall-clock is for timestamps")
def wallclock_duration(ctx):
    out = []
    for sf in ctx.package_files():
        tree = sf.tree
        if tree is None:
            continue
        mods, funcs = _time_aliases(tree)
        for node, func in walk_with_func(tree):
            hit = None
            if (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)
                    and (_is_wallclock_call(node.left, mods, funcs)
                         or _is_wallclock_call(node.right, mods,
                                               funcs))):
                hit = node
            elif (isinstance(node, ast.AugAssign)
                  and isinstance(node.op, ast.Sub)
                  and _is_wallclock_call(node.value, mods, funcs)):
                hit = node
            if hit is not None:
                out.append(Finding(
                    "wallclock-duration", sf.rel, hit.lineno,
                    "time.time() in a subtraction — durations go "
                    "through time.perf_counter()/time.monotonic(), "
                    "wall-clock is for timestamps only", func or ""))
    return out


def _bench_files(ctx):
    import fnmatch

    out = [sf for sf in ctx.package_files()
           if fnmatch.fnmatch(sf.rel, BENCH_GLOBS[0])]
    if os.path.isdir(ctx.repo):
        for fname in sorted(os.listdir(ctx.repo)):
            if fnmatch.fnmatch(fname, BENCH_GLOBS[1]):
                sf = ctx.file(fname)
                if sf is not None:
                    out.append(sf)
    return out


@rule("leg-provenance",
      "the port's benchmark's per-leg record must carry run_id + "
      "fingerprint — a leg untraceable to its run/cohort is a "
      "hand-adjudicated number; silent until that benchmark exists")
def leg_provenance(ctx):
    out = []
    for sf in _bench_files(ctx):
        if sf.tree is None:
            out.append(Finding(
                "leg-provenance", sf.rel, 1,
                f"{sf.rel} unparseable — the sweep's per-leg "
                "provenance contract has no anchor to lint"))
            continue
        found = False
        for node, func in walk_with_func(sf.tree):
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == "leg_record"
                            for t in node.targets)
                    and isinstance(node.value, ast.Dict)):
                continue
            found = True
            keys = {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)}
            missing = [k for k in LEG_RECORD_REQUIRED_KEYS
                       if k not in keys]
            if missing:
                out.append(Finding(
                    "leg-provenance", sf.rel, node.lineno,
                    f"leg_record literal missing provenance key(s) "
                    f"{missing} — every bench leg record must carry "
                    "run_id + fingerprint", func or ""))
        if not found:
            out.append(Finding(
                "leg-provenance", sf.rel, 1,
                "no leg_record dict literal found — the sweep's per-leg "
                "provenance contract has no anchor to lint"))
    return out


def _literal_entries(sf, literal: str) -> tuple[list[str], int] | None:
    """(string entries, line) of a module-level tuple/list assignment
    named ``literal``, AST-extracted — no package import, so the lint
    runs from a bare checkout."""
    if sf is None or sf.tree is None:
        return None
    for node in ast.walk(sf.tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == literal
                        for t in node.targets)
                and isinstance(node.value, (ast.Tuple, ast.List))):
            return ([e.value for e in node.value.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)], node.lineno)
    return None


@rule("registry-coverage",
      "every fault point (KNOWN_POINTS), watchdog phase "
      "(KNOWN_PHASES), and introspection trigger (TRIGGERS) must "
      "appear in at least one port test — an unexercised recovery/"
      "capture path rots silently")
def registry_coverage(ctx):
    out = []
    blob = ctx.tests_blob()
    for kind, rel, literal in COVERAGE_REGISTRIES:
        sf = ctx.file(rel)
        got = _literal_entries(sf, literal)
        if got is None or not got[0]:
            out.append(Finding(
                "registry-coverage", rel, 1,
                f"no {literal} literal found — the {kind} registry "
                "has no anchor to check coverage against"))
            continue
        entries, line = got
        for entry in entries:
            if entry not in blob:
                out.append(Finding(
                    "registry-coverage", rel, line,
                    f"{kind} {entry!r} ({literal}) is exercised by no "
                    "port test (tests/test_torch_*.py) — a new entry "
                    "must ship with at least one test that names it"))
    return out


#: The distributed-trace context header and the
#: ``http.client`` methods that put a request on the wire. The rule is
#: scoped to ``fm_spark_tpu_torch/serve/`` — the only package that makes
#: process-to-process HTTP calls on the request path.
TRACE_HEADER_NAME = "X-FM-Trace"
TRACE_CLIENT_METHODS = ("request", "putrequest")


@rule("trace-propagation",
      "every outbound HTTP request from fm_spark_tpu_torch/serve/ "
      "(http.client .request()/.putrequest()) must carry the "
      "X-FM-Trace context header — an unpropagated hop tears the "
      "distributed trace in half")
def trace_propagation(ctx):
    out = []
    for sf in ctx.files_under("fm_spark_tpu_torch/serve", recursive=False):
        tree = sf.tree
        if tree is None:
            continue
        # Per innermost enclosing function: does it reference the
        # header (the literal, or obs.TRACE_HEADER by name)? Collect
        # first, judge after — walk order is not source order.
        refs: set = set()
        calls: list = []
        for node, func in walk_with_func(tree):
            key = func or ""
            if (isinstance(node, ast.Constant)
                    and node.value == TRACE_HEADER_NAME):
                refs.add(key)
            elif ((isinstance(node, ast.Name)
                   and node.id == "TRACE_HEADER")
                  or (isinstance(node, ast.Attribute)
                      and node.attr == "TRACE_HEADER")):
                refs.add(key)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in TRACE_CLIENT_METHODS):
                calls.append((node, key))
        for node, key in calls:
            if key not in refs:
                out.append(Finding(
                    "trace-propagation", sf.rel, node.lineno,
                    f".{node.func.attr}() puts an HTTP request on "
                    f"the wire with no {TRACE_HEADER_NAME} reference "
                    "in the enclosing function — forward the trace "
                    "context (obs.TRACE_HEADER) so the hop stitches, "
                    "or suppress with the reason this call sits on a "
                    "trust boundary", key))
    return out


#: Raw-transport constructors banned in ``fm_spark_tpu_torch/serve/``
#:: a connection opened outside the netfault-aware seam
#: (resilience/netfaults.FaultyHTTPConnection via ConnectionPool /
#: ``_http_json``) is a transport path no partition schedule can
#: reach — chaos coverage silently shrinks. The loadgen's client-side
#: connection sits OUTSIDE the fleet's transport boundary and carries
#: a reasoned suppression.
TRANSPORT_BANNED = (
    "http.client.HTTPConnection", "HTTPConnection",
    "http.client.HTTPSConnection", "HTTPSConnection",
    "socket.create_connection", "socket.socket",
)


@rule("fleet-transport-discipline",
      "fm_spark_tpu_torch/serve/ must open replica connections through the "
      "netfault-aware transport (netfaults.FaultyHTTPConnection via "
      "ConnectionPool/_http_json) — raw http.client/socket connects "
      "bypass the fault plane, so partition chaos cannot reach them "
      "")
def fleet_transport_discipline(ctx):
    out = []
    for sf in ctx.files_under("fm_spark_tpu_torch/serve", recursive=False):
        tree = sf.tree
        if tree is None:
            continue
        for node, func in walk_with_func(tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in TRANSPORT_BANNED:
                out.append(Finding(
                    "fleet-transport-discipline", sf.rel, node.lineno,
                    f"raw {name}() — the netfault plane cannot "
                    "intercept this connection; route it through "
                    "ConnectionPool/_http_json (or suppress with the "
                    "reason this path sits outside the fleet's "
                    "transport boundary)", func or ""))
    return out


#: The durable-artifact surface: every byte these trees
#: promise to keep must be written through the injectable seam
#: (:mod:`fm_spark_tpu_torch.utils.durable`) — a raw ``open(.., "w")`` or
#: ``os.rename``/``os.replace`` is a write no disk-fault schedule can
#: reach, so crash-consistency coverage silently shrinks. Appends
#: (mode ``"a"``) are allowed raw at open time: the seam wraps the
#: per-line write (``durable.append_line``), not the handle.
DURABLE_DIRS = ("fm_spark_tpu_torch/obs", "fm_spark_tpu_torch/embed")
DURABLE_EXTRA_FILES = ("fm_spark_tpu_torch/checkpoint.py",)
DURABLE_BANNED_RENAMES = ("os.rename", "os.replace")


def _durable_files(ctx):
    out = []
    for d in DURABLE_DIRS:
        out.extend(ctx.files_under(d, recursive=True))
    for rel in DURABLE_EXTRA_FILES:
        sf = ctx.file(rel)
        if sf is not None:
            out.append(sf)
    return out


def _open_write_mode(node: ast.Call) -> "str | None":
    """The literal mode of an ``open()`` call iff it opens for
    (over)write — ``w``/``wb``/``w+``/``x`` variants. Appends and
    reads return None; so does a non-literal mode (can't judge it
    statically, and every in-scope call site uses literals)."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
            and mode.value.lstrip("br").startswith(("w", "x"))):
        return mode.value
    return None


@rule("durable-write-discipline",
      "checkpoint.py, fm_spark_tpu_torch/obs/, and fm_spark_tpu_torch/embed/ "
      "write durable artifacts only through utils/durable "
      "(atomic_write_*/append_line*) — raw open(.., 'w') and "
      "os.rename/os.replace bypass the io-fault seam, so no disk "
      "schedule can reach them")
def durable_write_discipline(ctx):
    out = []
    for sf in _durable_files(ctx):
        tree = sf.tree
        if tree is None:
            continue
        for node, func in walk_with_func(tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name == "open":
                mode = _open_write_mode(node)
                if mode is not None:
                    out.append(Finding(
                        "durable-write-discipline", sf.rel,
                        node.lineno,
                        f"raw open(.., {mode!r}) on the durable "
                        "surface — write through utils/durable "
                        "(atomic_write_bytes/text/json) so io-fault "
                        "schedules can reach it, or suppress with "
                        "the reason these bytes are not a durability "
                        "promise", func or ""))
            elif name in DURABLE_BANNED_RENAMES:
                out.append(Finding(
                    "durable-write-discipline", sf.rel, node.lineno,
                    f"raw {name}() on the durable surface — the "
                    "atomic publish belongs to utils/durable."
                    "atomic_write_* (injectable at io_rename), or "
                    "suppress with the reason this rename is not a "
                    "durable publish", func or ""))
    return out


@rule("suppression-hygiene",
      "every `# fmlint: disable=<rule>` needs `-- <reason>` and must "
      "name a registered rule — bare or misspelled disables are "
      "findings, never silencers")
def suppression_hygiene(ctx):
    from .core import RULES

    out = []
    for sf in ctx.package_files() + ctx.root_files():
        for line, sup in sf.suppressions().items():
            if sup.reason is None:
                out.append(Finding(
                    "suppression-hygiene", sf.rel, line,
                    "bare suppression: `# fmlint: disable=` without "
                    "`-- <reason>` suppresses nothing — state why the "
                    "convention bends here"))
            for rid in sup.rules:
                if rid not in RULES:
                    out.append(Finding(
                        "suppression-hygiene", sf.rel, line,
                        f"suppression names unknown rule {rid!r} — "
                        "check the rule glossary (fmlint --list-rules)"))
    return out
