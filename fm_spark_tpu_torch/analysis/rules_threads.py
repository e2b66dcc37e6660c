"""fmlint thread-safety pass: lock discipline + thread lifecycle (the
port of ``fm_spark_tpu/analysis/rules_threads.py``, over
``fm_spark_tpu_torch/``).

The port runs long-lived thread populations (supervisor probes,
prefetcher producers, the serve coalescer, the reload follower,
watchdog monitors, the fleet's replica monitors, the front door, the
metrics HTTP server) against shared mutable state. Two rules:

``thread-lock-discipline``
    For every class that starts a ``threading.Thread`` on one of its
    own bound methods (``target=self._run``) — plus the explicitly
    listed :data:`EXTRA_SHARED_CLASSES`, objects handed across threads
    without spawning one — infer the **shared mutable attributes**:
    ``self.X`` written outside ``__init__`` and touched from both the
    thread domain (methods reachable from the thread target via
    ``self.m()`` calls) and the caller domain (everything else). Flag
    every unlocked write to such an attribute, and every unlocked read
    whose domain is disjoint from all writers' domains (a same-domain
    read races only with itself). "Locked" is lexical: inside ``with
    self.<lock>`` where ``<lock>`` was assigned a ``threading.Lock/
    RLock/Condition``, or inside a method only ever called under one
    (``_foo_locked`` idiom — propagated to a fixpoint). Attributes
    that ARE locks, or are built once in ``__init__`` from an
    inherently thread-safe type (``queue.Queue``, ``threading.Event``,
    …), are exempt. A spawning class with shared mutable state and NO
    lock at all gets one finding per attribute.

    Deliberately-lock-free designs (the serve engine's atomic
    generation reference) are exactly what reasoned inline
    suppressions are for — the reason documents the protocol.

``thread-lifecycle``
    Every ``threading.Thread(...)`` (and ``threading.Timer``) must be
    ``daemon=True`` or have a ``join`` on its shutdown path (same
    class, or same function for local threads) — a forgotten
    non-daemon thread turns clean process exit into a hang.

Known blind spot, by design: attributes read only by OTHER objects
(``follower.reloads`` from a test) have no in-class read site, so
cross-object races are out of scope — the pass trades that recall for
running on plain ASTs with near-zero false positives.
"""

from __future__ import annotations

import ast

from .core import Finding, call_name, rule

#: Lock-like factory terminals: an attr assigned one of these is a
#: lock (its ``with self.X`` blocks dominate) and itself exempt.
LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition"})

#: Inherently thread-safe containers/primitives: an attr built ONCE in
#: __init__ from one of these is exempt (its methods synchronize).
SAFE_FACTORIES = frozenset({
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "Event", "Semaphore", "BoundedSemaphore", "Barrier", "deque",
    "local",
}) | LOCK_FACTORIES

#: (file rel-path, class name) pairs analyzed even though they spawn no
#: thread themselves — objects the runtime hands across threads: the
#: metrics instruments (every worker thread adds), the flight recorder
#: (producer threads record, signal handlers dump).
EXTRA_SHARED_CLASSES = (
    ("fm_spark_tpu_torch/obs/metrics.py", "Counter"),
    ("fm_spark_tpu_torch/obs/metrics.py", "Gauge"),
    ("fm_spark_tpu_torch/obs/metrics.py", "Histogram"),
    ("fm_spark_tpu_torch/obs/metrics.py", "MetricsRegistry"),
    ("fm_spark_tpu_torch/obs/flight.py", "FlightRecorder"),
)


class _Access:
    __slots__ = ("method", "line", "write", "locked")

    def __init__(self, method, line, write, locked):
        self.method = method
        self.line = line
        self.write = write
        self.locked = locked


class _ClassInfo:
    """One class's thread-relevant facts, collected in a single walk."""

    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.methods = {n.name: n for n in node.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        self.lock_attrs: set[str] = set()
        self.safe_attrs: set[str] = set()
        self._assign_methods: dict[str, set] = {}
        self.calls: dict[str, set] = {m: set() for m in self.methods}
        # method -> [(caller, locked?)] for every in-class call site
        self.call_sites: dict[str, list] = {}
        self.accesses: dict[str, list] = {}     # attr -> [_Access]
        self.spawn_targets: set[str] = set()
        self.thread_calls: list = []  # (line, method, daemonized)

    def analyze(self):
        # Pass 1: lock/safe attrs (need them before judging "locked").
        for mname, mnode in self.methods.items():
            for node in ast.walk(mnode):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr is None:
                        continue
                    self._assign_methods.setdefault(
                        attr, set()).add(mname)
                    if isinstance(node.value, ast.Call):
                        term = call_name(node.value).rsplit(".", 1)[-1]
                        if term in LOCK_FACTORIES:
                            self.lock_attrs.add(attr)
                        elif (term in SAFE_FACTORIES
                              and mname == "__init__"):
                            self.safe_attrs.add(attr)
        # An attr reassigned outside __init__ is not a stable safe
        # object; one reassigned to a non-factory loses lock status
        # conservatively only if never a lock (keep lock if ever one).
        self.safe_attrs = {
            a for a in self.safe_attrs
            if self._assign_methods.get(a) == {"__init__"}
        }
        # Pass 2: accesses / calls / spawns, with a lexical lock stack.
        for mname, mnode in self.methods.items():
            self._walk_method(mname, mnode)

    def _walk_method(self, mname, mnode):
        def locked_with(node):
            if not isinstance(node, ast.With):
                return False
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr in self.lock_attrs:
                    return True
            return False

        def visit(node, locked):
            if locked_with(node):
                locked = True
            if isinstance(node, ast.Call):
                name = call_name(node)
                term = name.rsplit(".", 1)[-1]
                if term in ("Thread", "Timer"):
                    target_attr = None
                    daemonized = any(
                        kw.arg == "daemon"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                        for kw in node.keywords)
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target_attr = _self_attr(kw.value)
                    if term == "Thread" and target_attr in self.methods:
                        self.spawn_targets.add(target_attr)
                    self.thread_calls.append(
                        (node.lineno, mname, daemonized))
                mcall = _self_method_call(node)
                if mcall in self.methods:
                    self.calls[mname].add(mcall)
                    self.call_sites.setdefault(mcall, []).append(
                        (mname, locked))
            attr_hit = _self_attr(node)
            if attr_hit is not None:
                write = isinstance(getattr(node, "ctx", None),
                                   (ast.Store, ast.Del))
                self.accesses.setdefault(attr_hit, []).append(
                    _Access(mname, node.lineno, write, locked))
            # Container mutation through the attr counts as a write:
            # self.x[k] = v  /  del self.x[k]
            if (isinstance(node, ast.Subscript)
                    and isinstance(getattr(node, "ctx", None),
                                   (ast.Store, ast.Del))):
                attr = _self_attr(node.value)
                if attr is not None:
                    self.accesses.setdefault(attr, []).append(
                        _Access(mname, node.lineno, True, locked))
            for child in ast.iter_child_nodes(node):
                visit(child, locked)

        for stmt in mnode.body:
            visit(stmt, False)

    # ------------------------------------------------------------ domains

    def reach(self, roots) -> set:
        seen = set()
        stack = [r for r in roots if r in self.methods]
        while stack:
            m = stack.pop()
            if m in seen:
                continue
            seen.add(m)
            stack.extend(self.calls.get(m, ()))
        return seen

    def lock_dominated_methods(self) -> set:
        """Methods every in-class call site of which holds a lock —
        their bodies count as locked (the ``_foo_locked`` idiom),
        iterated to a fixpoint so a dominated caller dominates its
        callees."""
        dominated: set = set()
        changed = True
        while changed:
            changed = False
            for m in self.methods:
                if m in dominated:
                    continue
                sites = self.call_sites.get(m)
                if not sites:
                    continue
                if all(locked or caller in dominated
                       for caller, locked in sites):
                    dominated.add(m)
                    changed = True
        return dominated


def _self_attr(node) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _self_method_call(node: ast.Call) -> str | None:
    return _self_attr(node.func)


def _classes(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            yield node


def _is_thread_join(node: ast.Call) -> bool:
    """A ``.join(...)`` call that plausibly joins a thread — i.e. NOT
    ``os.path.join`` / ``"sep".join`` / ``sep.join``, which would
    silently exempt whole modules from the lifecycle rule."""
    recv = node.func.value
    if isinstance(recv, ast.Constant):
        return False                       # "".join(...)
    dotted = call_name(ast.Call(func=recv, args=[], keywords=[])) \
        if isinstance(recv, (ast.Name, ast.Attribute)) else ""
    last = dotted.rsplit(".", 1)[-1].lower()
    if "path" in dotted.lower() or last in ("sep", "linesep", "os"):
        return False                       # os.path.join & kin
    return True


@rule("thread-lock-discipline",
      "shared mutable attributes of thread-spawning (or listed "
      "cross-thread) classes must be accessed under the class's lock "
      "— lock-free protocols need a reasoned suppression")
def thread_lock_discipline(ctx):
    out = []
    extra = {(rel, cls) for rel, cls in EXTRA_SHARED_CLASSES}
    for sf in ctx.package_files():
        tree = sf.tree
        if tree is None:
            continue
        for cnode in _classes(tree):
            info = _ClassInfo(cnode)
            info.analyze()
            spawning = bool(info.spawn_targets)
            listed = (sf.rel, cnode.name) in extra
            if not spawning and not listed:
                continue
            dominated = info.lock_dominated_methods()
            if spawning:
                thread_reach = info.reach(info.spawn_targets)
                caller_reach = info.reach(
                    m for m in info.methods
                    if m not in info.spawn_targets and m != "__init__")
            else:
                # Handed-across-threads class: any two methods can run
                # concurrently — one shared domain on both sides.
                thread_reach = caller_reach = set(info.methods)

            def domains(method):
                d = set()
                if method in thread_reach:
                    d.add("thread")
                if method in caller_reach:
                    d.add("caller")
                return d

            for attr, accs in sorted(info.accesses.items()):
                if (attr in info.lock_attrs
                        or attr in info.safe_attrs
                        or attr.startswith("__")):
                    continue
                accs = [a for a in accs if a.method != "__init__"]
                if not accs:
                    continue
                writes = [a for a in accs if a.write]
                if not writes:
                    continue
                touched = set()
                for a in accs:
                    touched |= domains(a.method)
                if not ("thread" in touched and "caller" in touched):
                    continue
                if not info.lock_attrs:
                    w = writes[0]
                    out.append(Finding(
                        "thread-lock-discipline", sf.rel, w.line,
                        f"class {cnode.name} starts a thread and "
                        f"mutates self.{attr} across thread domains "
                        "with no lock attribute at all — add a "
                        "threading.Lock or document the lock-free "
                        "protocol with a reasoned suppression",
                        w.method))
                    continue
                write_domains = set()
                for w in writes:
                    write_domains |= domains(w.method)
                for a in accs:
                    if a.locked or a.method in dominated:
                        continue
                    if a.write:
                        out.append(Finding(
                            "thread-lock-discipline", sf.rel, a.line,
                            f"write to shared attribute self.{attr} "
                            f"of {cnode.name} (touched from thread "
                            "and caller domains) outside `with "
                            f"self.{sorted(info.lock_attrs)[0]}`",
                            a.method))
                    elif not (domains(a.method) & write_domains):
                        out.append(Finding(
                            "thread-lock-discipline", sf.rel, a.line,
                            f"read of self.{attr} in {cnode.name}."
                            f"{a.method} races writes from the other "
                            "thread domain and holds no lock",
                            a.method))
    return out


@rule("thread-lifecycle",
      "every thread the package starts is daemon=True or joined on "
      "the shutdown path — a forgotten non-daemon thread turns clean "
      "exit into a hang")
def thread_lifecycle(ctx):
    out = []
    for sf in ctx.package_files():
        tree = sf.tree
        if tree is None:
            continue
        # Scope = enclosing class if any, else enclosing function,
        # else module: a join anywhere in the scope clears its threads.
        def scan(scope_node, scope_name):
            spawns = []
            joins = False
            daemon_assign = False

            def visit(node, func):
                nonlocal joins, daemon_assign
                if isinstance(node, ast.ClassDef) and node is not scope_node:
                    scan(node, node.name)
                    return
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    func = node.name
                if isinstance(node, ast.Call):
                    term = call_name(node).rsplit(".", 1)[-1]
                    if term in ("Thread", "Timer"):
                        daemonized = any(
                            kw.arg == "daemon"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is True
                            for kw in node.keywords)
                        spawns.append((node.lineno, func, daemonized,
                                       term))
                    elif (isinstance(node.func, ast.Attribute)
                          and node.func.attr == "join"
                          and _is_thread_join(node)):
                        joins = True
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and tgt.attr == "daemon"
                                and isinstance(node.value, ast.Constant)
                                and node.value.value is True):
                            daemon_assign = True
                for child in ast.iter_child_nodes(node):
                    visit(child, func)

            for child in ast.iter_child_nodes(scope_node):
                visit(child, None)
            for line, func, daemonized, term in spawns:
                if daemonized or daemon_assign or joins:
                    continue
                out.append(Finding(
                    "thread-lifecycle", sf.rel, line,
                    f"{term} started without daemon=True and no join "
                    f"anywhere in {scope_name or 'the module'} — a "
                    "non-daemon thread with no shutdown join hangs "
                    "clean process exit", func or ""))

        scan(tree, None)
    return out
