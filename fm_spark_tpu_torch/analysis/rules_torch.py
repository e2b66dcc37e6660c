"""fmlint PyTorch hazard pass: host syncs, capture side effects, unfenced
timing — the port's counterpart of ``fm_spark_tpu/analysis/rules_jax.py``.

The port's step loop stays ASYNC: a step (eager or a replayed CUDA
graph) returns at launch time and the card runs ahead of the host. One
stray ``loss.item()`` per step serializes host and card and the rate
falls silently — nothing errors, the number just drops. And a step must
stay capturable: a body recorded into a CUDA graph runs its Python once,
at capture, so a host sync there freezes one value into every replay
and a data-shaped op cannot be recorded at all. Three rules:

``torch-host-sync``
    Inside ``for``/``while`` loop bodies of the hot-path files
    (:data:`HOT_FILES` — train.py, sparse.py, online.py, parallel/,
    serve/engine.py, embed/tiered.py), flag the card→host
    synchronization spellings: ``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()``, ``torch.cuda.synchronize()`` and an event's or
    stream's ``.synchronize()``, ``float(...)`` of a non-constant,
    ``int(subscript)``, and ``np.asarray``/``np.array`` (of a tensor
    they copy it to the host). The DELIBERATE fences — the per-window
    loss fetch that IS the measurement boundary, the L-BFGS host loop's
    line-search scalars — carry reasoned suppressions; anything else is
    a stray sync on the hot path. Comprehensions don't count as loops
    (a post-loop summary comprehension is not the step loop).

``torch-capture-side-effect``
    Inside the functions handed to ``graphs.CapturedStep(...)`` and the
    bodies of ``with torch.cuda.graph(...)`` blocks, flag what runs
    once at capture instead of per step — ``print``, journal
    ``.emit(...)``, ``obs.*`` registry calls — and what breaks or
    freezes a capture: the host syncs above, ``torch.unique``,
    ``.nonzero()`` and ``torch.tensor(...)`` (a tensor built from host
    data at capture is a constant in every replay).

``torch-unfenced-timing``
    A timing window (two or more ``perf_counter``/``monotonic``/
    ``time.time`` calls) inside a hot loop body that also dispatches
    step work must contain a fence between the first and last timing
    call — ``torch.cuda.synchronize``, an event's ``synchronize`` or
    ``elapsed_time``, or one of the host syncs above — otherwise it
    measures launch latency, not the step.
"""

from __future__ import annotations

import ast
import fnmatch

from .core import Finding, call_name, rule, walk_with_func

#: The hot-path surface (repo-relative; fnmatch patterns): every file
#: whose loop bodies the async-dispatch discipline protects.
HOT_FILES = (
    "fm_spark_tpu_torch/train.py",
    "fm_spark_tpu_torch/sparse.py",
    "fm_spark_tpu_torch/online.py",
    "fm_spark_tpu_torch/parallel/*.py",
    "fm_spark_tpu_torch/serve/engine.py",
    "fm_spark_tpu_torch/embed/tiered.py",
)

#: Method calls that force a card→host sync (attribute terminals).
SYNC_ATTR_CALLS = frozenset({"item", "cpu", "tolist", "numpy",
                             "synchronize"})
#: Dotted calls that copy a tensor to the host.
SYNC_DOTTED = frozenset({"np.asarray", "np.array", "numpy.asarray",
                         "numpy.array"})
#: Fences that only the timing rule counts: a CUDA event's elapsed time
#: waits for both events.
TIMING_FENCE_ATTRS = frozenset({"elapsed_time"})

TIMING_CALLS = frozenset({"time.perf_counter", "time.monotonic",
                          "time.time", "perf_counter", "monotonic"})

#: Side-effect spellings banned inside captured bodies.
CAPTURE_BANNED_PREFIXES = ("obs.",)
CAPTURE_BANNED_CALLS = frozenset({"print", "torch.unique", "torch.nonzero",
                                  "torch.tensor"})
CAPTURE_BANNED_ATTRS = frozenset({"emit", "nonzero", "unique"})

#: What counts as "dispatching step work" for the timing rule: a call
#: whose terminal name mentions a step, a captured graph or a replay.
DISPATCH_MARKERS = ("step", "captured", "replay")


def hot_files(ctx):
    out = []
    seen = set()
    for sf in ctx.package_files():
        for pat in HOT_FILES:
            if fnmatch.fnmatch(sf.rel, pat) and sf.rel not in seen:
                seen.add(sf.rel)
                out.append(sf)
    return out


def _is_sync_call(node: ast.Call) -> str | None:
    """The host-sync spelling this call is, or None."""
    name = call_name(node)
    if name in SYNC_DOTTED:
        return name
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in SYNC_ATTR_CALLS):
        return ("torch.cuda.synchronize()"
                if name == "torch.cuda.synchronize"
                else f".{node.func.attr}()")
    if name == "float" and node.args and not isinstance(
            node.args[0], ast.Constant):
        return "float(...)"
    if (name == "int" and node.args
            and isinstance(node.args[0], ast.Subscript)):
        return "int(...)"
    return None


def _is_timing_fence(node: ast.Call) -> bool:
    return (_is_sync_call(node) is not None
            or (isinstance(node.func, ast.Attribute)
                and node.func.attr in TIMING_FENCE_ATTRS))


def _is_timing(node: ast.Call) -> bool:
    return call_name(node) in TIMING_CALLS


def _is_dispatch(node: ast.Call) -> bool:
    term = call_name(node).rsplit(".", 1)[-1].lower()
    return any(m in term for m in DISPATCH_MARKERS)


def _loops_with_func(tree):
    """Yield ``(loop_node, enclosing_function)`` for every for/while."""
    for node, func in walk_with_func(tree):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            yield node, func


def _walk_no_comprehensions(node):
    """Walk a loop body without descending into comprehensions or
    nested function defs (their bodies are not the loop's hot path —
    a generator consumed later is not a per-iteration sync)."""
    yield node
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                         ast.GeneratorExp, ast.FunctionDef,
                         ast.AsyncFunctionDef, ast.Lambda)):
        return
    for child in ast.iter_child_nodes(node):
        yield from _walk_no_comprehensions(child)


@rule("torch-host-sync",
      "no card→host sync (.item/.cpu/.tolist/.numpy/synchronize/float/"
      "int/np.asarray) inside hot-path loop bodies — the step loop must "
      "stay async; deliberate fences carry a reasoned suppression")
def torch_host_sync(ctx):
    out = []
    for sf in hot_files(ctx):
        tree = sf.tree
        if tree is None:
            continue
        seen = set()
        for loop, func in _loops_with_func(tree):
            for stmt in loop.body + getattr(loop, "orelse", []):
                for node in _walk_no_comprehensions(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    spelling = _is_sync_call(node)
                    if spelling is None:
                        continue
                    key = (node.lineno, node.col_offset)
                    if key in seen:   # nested loops: flag once
                        continue
                    seen.add(key)
                    out.append(Finding(
                        "torch-host-sync", sf.rel, node.lineno,
                        f"host sync {spelling} inside a hot-path loop "
                        "body — the step loop must stay async (launch, "
                        "don't fetch); if this IS the fence, say so in "
                        "a suppression reason", func or ""))
    return out


def _is_graph_context(expr) -> bool:
    """``torch.cuda.graph(...)`` (or ``cuda.graph(...)``)."""
    return (isinstance(expr, ast.Call)
            and call_name(expr) in ("torch.cuda.graph", "cuda.graph"))


def _captured_bodies(tree):
    """``(nodes, display name)`` for every body this module records into
    a CUDA graph: the function handed to ``CapturedStep(f)`` (the
    nearest ``def f`` above the call — the port's step factories each
    define a local ``run``), an inline ``CapturedStep(lambda ...)``, and
    the statements of every ``with torch.cuda.graph(...)`` block."""
    defs: dict[str, list] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    out = []
    seen = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and call_name(node).rsplit(".", 1)[-1] == "CapturedStep"
                and node.args):
            arg = node.args[0]
            if isinstance(arg, ast.Name) and arg.id in defs:
                above = [d for d in defs[arg.id] if d.lineno < node.lineno]
                if above:
                    d = max(above, key=lambda d: d.lineno)
                    if id(d) not in seen:
                        seen.add(id(d))
                        out.append(([d], d.name))
            elif isinstance(arg, ast.Lambda):
                out.append(([arg], "<lambda>"))
        elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_graph_context(item.context_expr)
                for item in node.items):
            out.append((node.body, "<torch.cuda.graph block>"))
    return out


def _capture_hazard(node: ast.Call) -> str | None:
    cname = call_name(node)
    if cname in CAPTURE_BANNED_CALLS:
        return cname
    if cname.startswith(CAPTURE_BANNED_PREFIXES):
        return cname
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in CAPTURE_BANNED_ATTRS):
        return f".{node.func.attr}()"
    return _is_sync_call(node)


@rule("torch-capture-side-effect",
      "no print / journal .emit / obs.* calls, host syncs, torch.unique, "
      ".nonzero() or torch.tensor(...) inside a body recorded into a "
      "CUDA graph (graphs.CapturedStep, torch.cuda.graph) — it runs "
      "once at capture, never per replay, or breaks the capture")
def torch_capture_side_effect(ctx):
    out = []
    for sf in ctx.package_files():
        tree = sf.tree
        if tree is None:
            continue
        flagged = set()
        for roots, name in _captured_bodies(tree):
            for root in roots:
                for node in ast.walk(root):
                    if not isinstance(node, ast.Call):
                        continue
                    bad = _capture_hazard(node)
                    key = (node.lineno, node.col_offset)
                    if bad is None or key in flagged:
                        continue
                    flagged.add(key)
                    out.append(Finding(
                        "torch-capture-side-effect", sf.rel, node.lineno,
                        f"{bad} inside captured body {name!r} runs once "
                        "at capture, not per replay (or breaks the "
                        "capture) — hoist it out of the recorded body",
                        name))
    return out


@rule("torch-unfenced-timing",
      "a timing window around dispatched step work in a hot loop must "
      "contain a fence (torch.cuda.synchronize / an event's "
      "synchronize or elapsed_time / .item) between its timing calls — "
      "else it measures launch latency, not the step")
def torch_unfenced_timing(ctx):
    out = []
    for sf in hot_files(ctx):
        tree = sf.tree
        if tree is None:
            continue
        flagged = set()
        for loop, func in _loops_with_func(tree):
            timing, fences, dispatches = [], [], []
            for stmt in loop.body + getattr(loop, "orelse", []):
                for node in _walk_no_comprehensions(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    if _is_timing(node):
                        timing.append(node.lineno)
                    elif _is_timing_fence(node):
                        fences.append(node.lineno)
                    elif _is_dispatch(node):
                        dispatches.append(node.lineno)
            if len(timing) < 2 or not dispatches:
                continue
            lo, hi = min(timing), max(timing)
            if any(lo <= f <= hi for f in fences):
                continue
            if any(lo <= d <= hi for d in dispatches):
                key = (sf.rel, hi)
                if key not in flagged:
                    flagged.add(key)
                    out.append(Finding(
                        "torch-unfenced-timing", sf.rel, hi,
                        "timing window around a step dispatch with no "
                        "fence between the timing calls — on the card "
                        "this measures the launch, not the step; fence "
                        "at the window boundary (torch.cuda.synchronize "
                        "/ the loss fetch / CUDA events)", func or ""))
    return out
