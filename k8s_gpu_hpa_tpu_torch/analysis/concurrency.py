"""Concurrency-safety passes: inferred locksets, closure escapes, contracts.

Counterpart of ``k8s_gpu_hpa_tpu/analysis/concurrency.py``, over the port's
tree and its own thread boundaries.  An informal invariant ("disjoint DBs
make the shard passes safe") becomes reliable the day a whole-program pass
checks it.  This module checks the port's threading in three layers, in
the spirit of Go's race detector (lockset inference) and escape analysis:

- **lockset pass** (``concurrency-lockset``): per file, infer which
  ``self._lock``-style guards protect which attribute writes (a write is
  *guarded* when it sits lexically inside ``with self.<lock>:``, or — one
  interprocedural step — when every intra-class call site of its method
  holds the lock, the ``decode._prune`` pattern).  Build the thread-entry
  set (``threading.Thread`` targets, callables handed to any executor's
  ``submit``/``map``, plus contract-declared entry points), close it over
  intra-file calls, and flag:

  - ``inconsistent-lockset`` — a field written both under a lock and bare
    (or under disjoint locks).  ``__init__``/``__post_init__`` and methods
    reachable *only* from them are exempt (no second thread exists yet).
  - ``unguarded-shared-write`` — a bare write from a thread-entry-reachable
    method; in Python every public method is also callable from the main
    thread, so such a field needs a lock or a checked contract declaration.

- **escape pass** (``concurrency-escape``): statically verify the
  federation "disjoint ownership" claim.  Every thread-construct site must
  carry a :class:`ConcurrencyContract`; submitted closures must not mutate
  captured state (``cross-closure-escape``) unless the contract declares it
  shared with a *verified* safety argument; and each declared
  :class:`SharedState` is re-proved every run (``contract-violation`` when
  the code no longer honors it, ``stale-contract`` when the boundary or
  entry point it describes is gone): contracts go stale loudly, as
  allowlist entries do.

A contract is a declared boundary, the invariant that makes it safe and
the shared objects it touches, each with a safety kind this module knows
how to check:

===================  =======================================================
safety kind          what the passes verify
===================  =======================================================
``lock-guarded``     every non-init write to the named class/field sits
                     under the declared lock (cross-file: the federation
                     contract names ``obs/coverage.py:CoverageMap.counts``)
``serial-fallback``  the declared guard expression still appears in the
                     boundary function's file (delete the fallback and the
                     contract fails instead of silently lying)
``read-only``        the contract's entry points never mutate the named
                     captured object
``merged-post-join`` ``submit``/``map`` results are consumed by the caller
                     (the merge happens after the join, not via shared
                     accumulators inside the tasks)
``atomic-append``    every non-init write to the named field is a single
                     ``.append(...)`` (GIL-atomic; list order is the only
                     shared state); a name the contract's entry points
                     take as a parameter is held to the same there
===================  =======================================================

The dynamic counterpart lives in control/race_harness.py: a seeded
scheduling shim permutes shard completion order and asserts bit-identity
with serial evaluation, and :func:`infer_guarded_fields` feeds it the
statically-inferred lockset so an instrumented lock can assert the lock is
*actually held* on every guarded-field access at runtime.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field as dc_field
from pathlib import Path

from k8s_gpu_hpa_tpu_torch.analysis import AnalysisPass, Finding, register
from k8s_gpu_hpa_tpu_torch.analysis.purity import _import_aliases, _qualified_name

#: constructs that start OS threads — every call site needs a contract
THREAD_CONSTRUCTS = frozenset(
    {
        "threading.Thread",
        "threading.Timer",
        "concurrent.futures.ThreadPoolExecutor",
        "concurrent.futures.ProcessPoolExecutor",
        "multiprocessing.Process",
    }
)

EXECUTOR_QUALS = frozenset(
    {
        "concurrent.futures.ThreadPoolExecutor",
        "concurrent.futures.ProcessPoolExecutor",
    }
)

LOCK_FACTORIES = frozenset(
    {"threading.Lock", "threading.RLock", "threading.Condition"}
)

#: receiver methods that mutate in place (the write kinds lockset tracks)
MUTATOR_METHODS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "insert",
        "pop",
        "popleft",
        "remove",
        "clear",
        "update",
        "setdefault",
        "add",
        "discard",
        "sort",
        "reverse",
    }
)

HEAP_MUTATORS = frozenset(
    {"heapq.heappush", "heapq.heappop", "heapq.heapreplace", "heapq.heapify"}
)

#: methods with no running second thread yet: their writes (and writes of
#: methods reachable only from them) are construction, not sharing
INIT_NAMES = frozenset({"__init__", "__post_init__"})

SAFETY_KINDS = (
    "lock-guarded",
    "serial-fallback",
    "read-only",
    "merged-post-join",
    "atomic-append",
)


@dataclass(frozen=True)
class SharedState:
    """One object a thread boundary shares, with its checked safety story.

    ``name`` is either a bare attribute/variable name scoped to the
    contract's file (``"request_log"``), or a cross-file field reference
    ``"<repo-relative file>:<Class>"`` / ``"...:<Class>.<field>"`` for
    ``lock-guarded`` declarations.  ``guard`` names the lock attribute
    (``lock-guarded``) or the fallback guard expression (``serial-fallback``).
    """

    name: str
    safety: str
    guard: str = ""
    note: str = ""

    def __post_init__(self) -> None:
        if self.safety not in SAFETY_KINDS:
            raise ValueError(
                f"shared state {self.name!r}: unknown safety kind "
                f"{self.safety!r} (known: {', '.join(SAFETY_KINDS)})"
            )


@dataclass(frozen=True)
class ConcurrencyContract:
    """A declared thread boundary + the invariant that makes it safe.

    Matched to code by (``file``, ``construct``); a contract whose boundary
    disappeared, whose entry points no longer exist, or whose shared-state
    safety argument stopped holding is a finding — never a silent pass."""

    file: str
    construct: str
    invariant: str
    entry_points: tuple[str, ...] = ()
    shared: tuple[SharedState, ...] = ()
    justification: str = ""


#: the port's thread boundaries, one checked contract each
CONTRACTS: tuple[ConcurrencyContract, ...] = (
    ConcurrencyContract(
        file="k8s_gpu_hpa_tpu_torch/metrics/federation.py",
        construct="concurrent.futures.ThreadPoolExecutor",
        invariant=(
            "disjoint-ownership: shard task i touches only "
            "shard_evaluators[i] and shard_dbs[i] (hash-ring construction); "
            "the merge is a commutative sum computed after the join"
        ),
        shared=(
            SharedState(
                "k8s_gpu_hpa_tpu_torch/obs/coverage.py:CoverageMap.counts",
                "lock-guarded",
                guard="_lock",
                note="rule/planner coverage.hit() fires from pool threads",
            ),
            SharedState(
                "k8s_gpu_hpa_tpu_torch/obs/coverage.py:CoverageMap.first_hit_ts",
                "lock-guarded",
                guard="_lock",
                note="first-hit provenance shares record()'s check-then-set",
            ),
            SharedState(
                "k8s_gpu_hpa_tpu_torch/obs/coverage.py:CoverageMap.first_hit_span",
                "lock-guarded",
                guard="_lock",
                note="first-hit provenance shares record()'s check-then-set",
            ),
            SharedState(
                "tracer/selfmetrics sinks",
                "serial-fallback",
                guard="ev.tracer is not None or ev.selfmetrics is not None",
                note="span/list internals are unguarded; the plane detects "
                "shared sinks and runs the serial loop instead",
            ),
        ),
        justification="the declared shard-rules fan-out "
        "(ShardedScrapePlane.evaluate_rules_once)",
    ),
    ConcurrencyContract(
        file="k8s_gpu_hpa_tpu_torch/control/operator.py",
        construct="threading.Thread",
        invariant="read-only-observer: the health-server thread only reads "
        "operator state (last_tick, metrics render, elector.is_leader)",
        entry_points=("do_GET",),
        shared=(SharedState("operator", "read-only"),),
        justification="the operator daemon's production health endpoint; "
        "never started in sim runs",
    ),
    ConcurrencyContract(
        file="k8s_gpu_hpa_tpu_torch/trial.py",
        construct="threading.Thread",
        invariant=(
            "single-owner: the loadgen thread alone calls its step() (the "
            "generator, as the workload's pod owns its device); the main "
            "thread only sets the stop event, and its exception comes back "
            "through _errors, read by check() and after the join"
        ),
        entry_points=("LoadThread._run",),
        shared=(
            SharedState(
                "_errors",
                "atomic-append",
                note="GIL-atomic list.append of the thread's exception",
            ),
        ),
        justification="the live trials' load generator runs in its own "
        "thread, as the workload runs in its own pod",
    ),
    ConcurrencyContract(
        file="k8s_gpu_hpa_tpu_torch/trial.py",
        construct="threading.Thread",
        invariant=(
            "single-writer: the exporter-feed thread is the daemon's only "
            "caller until the stop event is set and the thread joined "
            "(daemon.step() sweeps the source and publishes to the native "
            "server, which answers the scrapes); its exception comes back "
            "through errors"
        ),
        entry_points=("_feed_exporter",),
        shared=(
            SharedState(
                "stop",
                "read-only",
                note="the feed only waits on the event the main thread sets",
            ),
            SharedState(
                "errors",
                "atomic-append",
                note="GIL-atomic list.append, read after the join",
            ),
        ),
        justification="the live trials feed their exporter every half "
        "second while the loop scrapes it over HTTP",
    ),
)


def contract_for(
    rel: str, construct: str, contracts: tuple[ConcurrencyContract, ...] = CONTRACTS
) -> ConcurrencyContract | None:
    """The declared contract covering construct ``construct`` in file
    ``rel`` (repo-relative), or None — the purity pass uses this to decide
    which ambient-threading sites are declared rather than blanket-excused."""
    for c in contracts:
        if c.file == rel and c.construct == construct:
            return c
    return None


# ---- per-file model --------------------------------------------------------

FuncKey = tuple  # (class name | None, function name)


@dataclass
class _Write:
    attr: str
    line: int
    guards: frozenset
    kind: str  # "assign" | "subscript" | "del" | "call:<method>"


@dataclass
class _TaskSite:
    """One ``<executor>.submit/map`` call: the callable it hands over."""

    owner: FuncKey
    receiver: tuple  # ("name", id) | ("selfattr", attr)
    callable_node: ast.expr | None
    line: int
    guards: frozenset
    call_id: int  # id() of the Call node, for used-result detection


@dataclass
class _FnInfo:
    writes: list = dc_field(default_factory=list)  # [_Write]
    #: raw call records: ("self", meth, guards) | ("cls", C, meth, guards)
    #: | ("name", fn, guards)
    calls: list = dc_field(default_factory=list)
    #: mutations rooted at a plain name: (root, line, kind)
    name_mutations: list = dc_field(default_factory=list)
    param_names: set = dc_field(default_factory=set)
    param_types: dict = dc_field(default_factory=dict)
    local_names: set = dc_field(default_factory=set)
    lock_assigns: set = dc_field(default_factory=set)  # self attrs = Lock()
    exec_self_attrs: set = dc_field(default_factory=set)
    exec_names: set = dc_field(default_factory=set)
    raw_task_sites: list = dc_field(default_factory=list)
    #: thread/timer target expressions: (construct qual, target node, line)
    thread_targets: list = dc_field(default_factory=list)
    is_static: bool = False


def _self_attr(node: ast.expr) -> str | None:
    """The first attribute above ``self`` in an attribute/subscript chain
    (``self._data[name][k]`` -> ``_data``), else None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if not isinstance(node, ast.Attribute):
        return None
    attr = node.attr
    base = node.value
    while isinstance(base, (ast.Attribute, ast.Subscript)):
        if isinstance(base, ast.Subscript):
            base = base.value
            continue
        attr = base.attr
        base = base.value
    if isinstance(base, ast.Name) and base.id == "self":
        return attr
    return None


def _root_name(node: ast.expr) -> str | None:
    """The base plain name of an attribute/subscript chain (``operator`` of
    ``operator.stats.count``); None for self-rooted or non-name chains."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name) and node.id != "self":
        return node.id
    return None


def _annotation_class(ann: ast.expr | None) -> str | None:
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip("\"'").rsplit(".", 1)[-1]
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    return None


def _thread_target_expr(node: ast.Call, qual: str) -> ast.expr | None:
    for kw in node.keywords:
        if kw.arg in ("target", "function"):
            return kw.value
    if qual == "threading.Timer" and len(node.args) >= 2:
        return node.args[1]
    return None


def _scan_function(
    fn: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda,
    aliases: dict,
) -> _FnInfo:
    info = _FnInfo()
    args = fn.args
    for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
        info.param_names.add(a.arg)
        cls = _annotation_class(getattr(a, "annotation", None))
        if cls is not None:
            info.param_types[a.arg] = cls
    if args.vararg:
        info.param_names.add(args.vararg.arg)
    if args.kwarg:
        info.param_names.add(args.kwarg.arg)
    if not isinstance(fn, ast.Lambda):
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Name) and dec.id == "staticmethod":
                info.is_static = True

    def record_target(tgt: ast.expr, held: frozenset, kind: str) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                record_target(elt, held, kind)
            return
        if isinstance(tgt, ast.Starred):
            record_target(tgt.value, held, kind)
            return
        if isinstance(tgt, ast.Name):
            info.local_names.add(tgt.id)
            return
        if isinstance(tgt, (ast.Attribute, ast.Subscript)):
            k = "subscript" if isinstance(tgt, ast.Subscript) else kind
            attr = _self_attr(tgt)
            if attr is not None:
                info.writes.append(_Write(attr, tgt.lineno, held, k))
            root = _root_name(tgt)
            if root is not None:
                info.name_mutations.append((root, tgt.lineno, k))

    def handle_call(node: ast.Call, held: frozenset) -> None:
        qual = _qualified_name(node.func, aliases)
        if qual is not None:
            if qual in HEAP_MUTATORS and node.args:
                short = qual.rsplit(".", 1)[1]
                attr = _self_attr(node.args[0])
                if attr is not None:
                    info.writes.append(
                        _Write(attr, node.lineno, held, f"call:{short}")
                    )
                root = _root_name(node.args[0])
                if root is not None:
                    info.name_mutations.append(
                        (root, node.lineno, f"call:{short}")
                    )
            if qual in THREAD_CONSTRUCTS:
                target = _thread_target_expr(node, qual)
                info.thread_targets.append((qual, target, node.lineno))
        if isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            recv = node.func.value
            if meth in MUTATOR_METHODS:
                attr = _self_attr(recv)
                if attr is not None:
                    info.writes.append(
                        _Write(attr, node.lineno, held, f"call:{meth}")
                    )
                root = _root_name(recv)
                if root is not None:
                    info.name_mutations.append(
                        (root, node.lineno, f"call:{meth}")
                    )
            if meth in ("submit", "map"):
                receiver = None
                if isinstance(recv, ast.Name):
                    receiver = ("name", recv.id)
                else:
                    attr = _self_attr(recv)
                    if attr is not None and isinstance(recv, ast.Attribute):
                        receiver = ("selfattr", attr)
                if receiver is not None:
                    info.raw_task_sites.append(
                        (
                            receiver,
                            node.args[0] if node.args else None,
                            node.lineno,
                            held,
                            id(node),
                        )
                    )
            if isinstance(recv, ast.Name):
                if recv.id == "self":
                    info.calls.append(("self", meth, held))
                elif recv.id in info.param_types:
                    info.calls.append(
                        ("cls", info.param_types[recv.id], meth, held)
                    )
        elif isinstance(node.func, ast.Name):
            info.calls.append(("name", node.func.id, held))

    def visit(node: ast.AST, held: frozenset) -> None:
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            return  # separate scope; analyzed on its own
        if isinstance(node, (ast.With, ast.AsyncWith)):
            locks = set()
            for item in node.items:
                visit(item.context_expr, held)
                attr = _self_attr(item.context_expr)
                if attr is not None:
                    locks.add(attr)
            inner = held | frozenset(locks)
            for stmt in node.body:
                visit(stmt, inner)
            return
        if isinstance(node, ast.Assign):
            value_qual = (
                _qualified_name(node.value.func, aliases)
                if isinstance(node.value, ast.Call)
                else None
            )
            for tgt in node.targets:
                record_target(tgt, held, "assign")
                attr = (
                    _self_attr(tgt)
                    if isinstance(tgt, ast.Attribute)
                    else None
                )
                name = tgt.id if isinstance(tgt, ast.Name) else None
                if value_qual in LOCK_FACTORIES and attr is not None:
                    info.lock_assigns.add(attr)
                if value_qual in EXECUTOR_QUALS:
                    if attr is not None:
                        info.exec_self_attrs.add(attr)
                    if name is not None:
                        info.exec_names.add(name)
        elif isinstance(node, ast.AugAssign):
            record_target(node.target, held, "assign")
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                record_target(node.target, held, "assign")
            if isinstance(node.target, ast.Attribute):
                attr = _self_attr(node.target)
                if attr is not None and node.annotation is not None:
                    for sub in ast.walk(node.annotation):
                        if (
                            isinstance(sub, (ast.Name, ast.Attribute))
                            and _qualified_name(sub, aliases) in EXECUTOR_QUALS
                        ):
                            info.exec_self_attrs.add(attr)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    record_target(tgt, held, "del")
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            record_target(node.target, held, "assign")
        elif isinstance(node, ast.Call):
            handle_call(node, held)
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        visit(stmt, frozenset())
    return info


class _FileModel:
    """Everything the two passes need from one parsed file."""

    def __init__(self, path: Path, root: Path):
        self.rel = path.relative_to(root).as_posix()
        self.source = path.read_text()
        self.tree = ast.parse(self.source)
        self.aliases = _import_aliases(self.tree)

        self.classes: dict[str, dict] = {}
        self.lock_attrs: dict[str, set] = {}
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            methods = {}
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods[stmt.name] = stmt
                elif (
                    isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                    and isinstance(stmt.value, ast.Call)
                    and _qualified_name(stmt.value.func, self.aliases)
                    == "dataclasses.field"
                ):
                    for kw in stmt.value.keywords:
                        if (
                            kw.arg == "default_factory"
                            and _qualified_name(kw.value, self.aliases)
                            in LOCK_FACTORIES
                        ):
                            self.lock_attrs.setdefault(node.name, set()).add(
                                stmt.target.id
                            )
                elif (
                    isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Call)
                    and _qualified_name(stmt.value.func, self.aliases)
                    in LOCK_FACTORIES
                ):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            self.lock_attrs.setdefault(node.name, set()).add(
                                tgt.id
                            )
            self.classes[node.name] = methods

        self.module_funcs = {
            n.name: n
            for n in self.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }

        self.fn_info: dict[FuncKey, _FnInfo] = {}
        for cname, methods in self.classes.items():
            for mname, fnode in methods.items():
                self.fn_info[(cname, mname)] = _scan_function(
                    fnode, self.aliases
                )
        for fname, fnode in self.module_funcs.items():
            self.fn_info[(None, fname)] = _scan_function(fnode, self.aliases)

        exec_attrs: set = set()
        exec_names: set = set()
        for info in self.fn_info.values():
            exec_attrs |= info.exec_self_attrs
            exec_names |= info.exec_names
        for (cname, _), info in self.fn_info.items():
            if cname is None:
                continue
            for attr in info.lock_assigns:
                self.lock_attrs.setdefault(cname, set()).add(attr)
        # second sweep: plain names aliased from executor-typed self attrs
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign):
                val_attr = (
                    _self_attr(node.value)
                    if isinstance(node.value, ast.Attribute)
                    else None
                )
                if val_attr in exec_attrs:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            exec_names.add(tgt.id)
        self.exec_attrs = exec_attrs
        self.exec_names = exec_names

        #: every thread-construct call site: (qualified construct, line)
        self.boundaries: list = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                qual = _qualified_name(node.func, self.aliases)
                if qual in THREAD_CONSTRUCTS:
                    self.boundaries.append((qual, node.lineno))

        #: id() of every Call whose value a bare-Expr statement discards
        self.discarded_calls = {
            id(n.value)
            for n in ast.walk(self.tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
        }

        self.task_sites: list = []
        for key, info in self.fn_info.items():
            for receiver, cnode, line, guards, call_id in info.raw_task_sites:
                kind, name = receiver
                is_exec = (kind == "name" and name in exec_names) or (
                    kind == "selfattr" and name in exec_attrs
                )
                if is_exec:
                    self.task_sites.append(
                        _TaskSite(key, receiver, cnode, line, guards, call_id)
                    )

    # -- resolution helpers --------------------------------------------------

    def resolve_callable(
        self, node: ast.expr | None, owner: FuncKey
    ) -> list:
        """FuncKeys a submitted/threaded callable expression names (empty
        when unresolvable — e.g. a bound method of a local object)."""
        if node is None:
            return []
        if isinstance(node, ast.Name):
            if node.id in self.module_funcs:
                return [(None, node.id)]
            return []
        if isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ):
            meth = node.attr
            base = node.value.id
            if base == "self":
                return self._resolve_method(owner[0], meth)
            owner_info = self.fn_info.get(owner)
            if owner_info is not None and base in owner_info.param_types:
                cls = owner_info.param_types[base]
                if meth in self.classes.get(cls, {}):
                    return [(cls, meth)]
            if meth in self.classes.get(base, {}):
                return [(base, meth)]
        return []

    def _resolve_method(self, cls: str | None, meth: str) -> list:
        if cls is not None and meth in self.classes.get(cls, {}):
            return [(cls, meth)]
        found = [(c, meth) for c, ms in self.classes.items() if meth in ms]
        if found:
            return found
        if meth in self.module_funcs:
            return [(None, meth)]
        return []

    def resolve_entry_name(self, name: str) -> list:
        if "." in name:
            cls, _, meth = name.partition(".")
            return [(cls, meth)] if meth in self.classes.get(cls, {}) else []
        return self._resolve_method(None, name)

    def call_edges(self) -> dict:
        """caller FuncKey -> [(callee FuncKey, guards, same_class)]."""
        edges: dict = {}
        for key, info in self.fn_info.items():
            out = []
            for rec in info.calls:
                if rec[0] == "self":
                    _, meth, guards = rec
                    for callee in self._resolve_method(key[0], meth):
                        out.append((callee, guards, callee[0] == key[0]))
                elif rec[0] == "cls":
                    _, cls, meth, guards = rec
                    if meth in self.classes.get(cls, {}):
                        out.append(((cls, meth), guards, cls == key[0]))
                else:
                    _, fname, guards = rec
                    if fname in self.module_funcs:
                        out.append(((None, fname), guards, False))
            if out:
                edges[key] = out
        return edges


# ---- whole-file analysis shared by both passes -----------------------------


@dataclass
class _Analysis:
    model: _FileModel
    seeds: set
    reachable: set
    init_phase: set
    callers: dict


def _entry_seeds(
    model: _FileModel, contracts: tuple[ConcurrencyContract, ...]
) -> set:
    seeds: set = set()
    for key, info in model.fn_info.items():
        for _qual, target, _line in info.thread_targets:
            seeds.update(model.resolve_callable(target, key))
    for site in model.task_sites:
        seeds.update(model.resolve_callable(site.callable_node, site.owner))
    for c in contracts:
        if c.file != model.rel:
            continue
        for name in c.entry_points:
            seeds.update(model.resolve_entry_name(name))
    return seeds


def _analyze(
    model: _FileModel, contracts: tuple[ConcurrencyContract, ...]
) -> _Analysis:
    edges = model.call_edges()
    callers: dict = {}
    for caller, outs in edges.items():
        for callee, guards, same in outs:
            callers.setdefault(callee, []).append((caller, guards, same))

    seeds = _entry_seeds(model, contracts)
    reachable = set(seeds)
    frontier = list(seeds)
    while frontier:
        key = frontier.pop()
        for callee, _guards, _same in edges.get(key, []):
            if callee not in reachable:
                reachable.add(callee)
                frontier.append(callee)

    init_phase = {k for k in model.fn_info if k[1] in INIT_NAMES}
    changed = True
    while changed:
        changed = False
        for key in model.fn_info:
            if key in init_phase or key in seeds:
                continue
            cs = callers.get(key)
            if cs and all(caller in init_phase for caller, _g, _s in cs):
                init_phase.add(key)
                changed = True

    # one-step interprocedural guard propagation: a method whose every
    # same-class call site holds a common lock inherits that lock on its
    # bare writes (the decode.py _prune pattern: pop under the caller's
    # ``with self._hist_lock``)
    changed = True
    while changed:
        changed = False
        for key, info in model.fn_info.items():
            cname = key[0]
            if cname is None or key in seeds:
                continue
            locks = model.lock_attrs.get(cname, set())
            if not locks:
                continue
            bare = [w for w in info.writes if not (w.guards & locks)]
            if not bare:
                continue
            cs = callers.get(key)
            if not cs or not all(same for _c, _g, same in cs):
                continue
            common = None
            for _caller, guards, _same in cs:
                held = guards & locks
                common = held if common is None else (common & held)
            if not common:
                continue
            for w in bare:
                w.guards = w.guards | common
            changed = True

    return _Analysis(model, seeds, reachable, init_phase, callers)


def _shared_decl_index(contracts: tuple[ConcurrencyContract, ...]) -> tuple:
    """(cross-file "file:Class[.attr]" refs, per-contract-file bare names)."""
    full: set = set()
    bare: dict = {}
    for c in contracts:
        for s in c.shared:
            if ":" in s.name:
                full.add(s.name)
            else:
                bare.setdefault(c.file, set()).add(s.name)
    return full, bare


def _declared(full: set, bare: dict, rel: str, cls: str, attr: str) -> bool:
    return (
        f"{rel}:{cls}" in full
        or f"{rel}:{cls}.{attr}" in full
        or attr in bare.get(rel, set())
    )


def _package_files(root: Path):
    base = root / "k8s_gpu_hpa_tpu_torch"
    for path in sorted(base.rglob("*.py")):
        if "__pycache__" not in path.parts:
            yield path


def _models(root: Path) -> dict:
    out: dict = {}
    for path in _package_files(root):
        try:
            out[path.relative_to(root).as_posix()] = _FileModel(path, root)
        except SyntaxError:
            continue
    return out


def infer_guarded_fields(path: Path, root: Path) -> dict:
    """The inferred lockset of one file: ``(class, field) -> lock attr``
    for every field whose non-init writes all hold one common lock.  The
    race harness (control/race_harness.py) installs instrumented locks from
    exactly this map, so the dynamic assertion can never drift from what
    the static pass concluded."""
    model = _FileModel(path, root)
    analysis = _analyze(model, CONTRACTS)
    table: dict = {}
    for key, info in model.fn_info.items():
        cname = key[0]
        if cname is None or key in analysis.init_phase:
            continue
        locks = model.lock_attrs.get(cname, set())
        for w in info.writes:
            table.setdefault((cname, w.attr), []).append(w.guards & locks)
    out: dict = {}
    for (cname, attr), guard_sets in table.items():
        common = None
        for g in guard_sets:
            common = g if common is None else (common & g)
        if common:
            out[(cname, attr)] = sorted(common)[0]
    return out


# ---- the lockset pass ------------------------------------------------------


class LocksetPass(AnalysisPass):
    name = "concurrency-lockset"
    description = (
        "every field is protected by a consistent inferred lockset: no "
        "mixed guarded/bare writes, no bare writes reachable from a "
        "thread entry without a checked contract declaration"
    )

    def __init__(self, contracts: tuple[ConcurrencyContract, ...] | None = None):
        self.contracts = CONTRACTS if contracts is None else contracts

    def run(self, root: Path) -> list[Finding]:
        findings: list[Finding] = []
        full, bare = _shared_decl_index(self.contracts)
        for rel, model in _models(root).items():
            analysis = _analyze(model, self.contracts)
            table: dict = {}
            for key, info in model.fn_info.items():
                if key[0] is None or key in analysis.init_phase:
                    continue
                for w in info.writes:
                    table.setdefault((key[0], w.attr), []).append((key, w))
            for (cls, attr), entries in sorted(table.items()):
                locks = model.lock_attrs.get(cls, set())
                guarded = [
                    (k, w) for k, w in entries if w.guards & locks
                ]
                unguarded = [
                    (k, w) for k, w in entries if not (w.guards & locks)
                ]
                subject = f"{rel}:{cls}.{attr}"
                if guarded and unguarded:
                    lock_names = sorted(
                        {
                            ln
                            for _k, w in guarded
                            for ln in (w.guards & locks)
                        }
                    )
                    k, w = min(unguarded, key=lambda e: e[1].line)
                    findings.append(
                        self.finding(
                            "inconsistent-lockset",
                            rel,
                            w.line,
                            subject,
                            f"{cls}.{attr} is written under "
                            f"{'/'.join(lock_names)} elsewhere (e.g. line "
                            f"{min(x.line for _k2, x in guarded)}) but bare "
                            f"in {k[1]}() — hold the lock on every non-init "
                            "write or the guarded sites are theater",
                        )
                    )
                elif guarded:
                    common = None
                    for _k, w in guarded:
                        held = w.guards & locks
                        common = held if common is None else (common & held)
                    if not common:
                        k, w = min(guarded, key=lambda e: e[1].line)
                        findings.append(
                            self.finding(
                                "inconsistent-lockset",
                                rel,
                                w.line,
                                subject,
                                f"{cls}.{attr} is written under disjoint "
                                "locks — no single lock orders the writes",
                            )
                        )
                elif any(k in analysis.reachable for k, _w in entries):
                    if _declared(full, bare, rel, cls, attr):
                        continue  # the escape pass verifies the declaration
                    k, w = min(
                        (
                            (k, w)
                            for k, w in entries
                            if k in analysis.reachable
                        ),
                        key=lambda e: e[1].line,
                    )
                    findings.append(
                        self.finding(
                            "unguarded-shared-write",
                            rel,
                            w.line,
                            subject,
                            f"{cls}.{attr} is written bare in {k[1]}(), "
                            "which runs on a spawned thread (entry-reachable)"
                            " while staying callable from the main thread — "
                            "guard it with a lock or declare + verify it in "
                            "a concurrency contract",
                        )
                    )
        return findings


# ---- the escape pass -------------------------------------------------------


class EscapePass(AnalysisPass):
    name = "concurrency-escape"
    description = (
        "every thread boundary carries a checked concurrency contract: "
        "submitted closures own their state (no captured-mutable escapes), "
        "and each declared shared object's safety argument is re-proved"
    )

    def __init__(self, contracts: tuple[ConcurrencyContract, ...] | None = None):
        self.contracts = CONTRACTS if contracts is None else contracts

    def run(self, root: Path) -> list[Finding]:
        findings: list[Finding] = []
        models = _models(root)

        for rel, model in sorted(models.items()):
            for qual, line in model.boundaries:
                if contract_for(rel, qual, self.contracts) is None:
                    findings.append(
                        self.finding(
                            "undeclared-thread-boundary",
                            rel,
                            line,
                            f"{rel}:{qual}",
                            f"{qual}() starts threads with no concurrency "
                            "contract — declare the boundary, its entry "
                            "points, and the invariant that makes its "
                            "shared state safe (analysis/concurrency.py "
                            "CONTRACTS)",
                        )
                    )
            self._check_escapes(rel, model, findings)

        for c in self.contracts:
            self._check_contract(c, models, findings)
        return findings

    # -- closure escapes ------------------------------------------------------

    def _check_escapes(
        self, rel: str, model: _FileModel, findings: list
    ) -> None:
        _full, bare = _shared_decl_index(self.contracts)
        declared = bare.get(rel, set())

        def check_entry(info: _FnInfo, line: int, what: str) -> None:
            for root_name, mline, kind in info.name_mutations:
                if root_name in info.param_names:
                    continue
                if root_name in info.local_names:
                    continue
                if root_name in declared:
                    continue
                findings.append(
                    self.finding(
                        "cross-closure-escape",
                        rel,
                        mline,
                        f"{rel}:{root_name}",
                        f"{what} mutates captured {root_name!r} "
                        f"({kind}) — state reachable from concurrent tasks "
                        "must be task-owned, lock-guarded, or declared (and "
                        "verified) in the boundary's concurrency contract",
                    )
                )

        for site in model.task_sites:
            node = site.callable_node
            if isinstance(node, ast.Lambda):
                info = _scan_function(node, model.aliases)
                check_entry(info, site.line, "closure submitted to the pool")
                continue
            for key in model.resolve_callable(node, site.owner):
                info = model.fn_info[key]
                if key[0] is None or info.is_static:
                    check_entry(
                        info, site.line, f"pool entry {key[1]}()"
                    )
        for owner, finfo in model.fn_info.items():
            for _qual, target, line in finfo.thread_targets:
                for key in model.resolve_callable(target, owner):
                    info = model.fn_info[key]
                    if key[0] is None or info.is_static:
                        check_entry(info, line, f"thread target {key[1]}()")

    # -- contract verification ------------------------------------------------

    def _check_contract(
        self, c: ConcurrencyContract, models: dict, findings: list
    ) -> None:
        subject = f"contract:{c.file}:{c.construct}"
        model = models.get(c.file)
        matched = model is not None and any(
            qual == c.construct for qual, _line in model.boundaries
        )
        if not matched:
            findings.append(
                self.finding(
                    "stale-contract",
                    c.file,
                    1,
                    subject,
                    f"concurrency contract for {c.construct} matches no "
                    "call site — the boundary it excused is gone; delete "
                    "the contract",
                )
            )
            return

        entry_keys: list = []
        for name in c.entry_points:
            resolved = model.resolve_entry_name(name)
            if not resolved:
                findings.append(
                    self.finding(
                        "stale-contract",
                        c.file,
                        1,
                        f"{subject}:{name}",
                        f"contract entry point {name!r} resolves to no "
                        "function in the file — the thread entry was "
                        "renamed or removed; update the contract",
                    )
                )
            entry_keys.extend(resolved)

        for s in c.shared:
            if s.safety == "lock-guarded":
                self._verify_lock_guarded(c, s, models, findings, subject)
            elif s.safety == "serial-fallback":
                if s.guard and s.guard not in model.source:
                    findings.append(
                        self.finding(
                            "stale-contract",
                            c.file,
                            1,
                            f"{subject}:{s.name}",
                            f"declared serial-fallback guard {s.guard!r} no "
                            "longer appears in the file — the fallback the "
                            "contract relies on was removed",
                        )
                    )
            elif s.safety == "read-only":
                for key in entry_keys:
                    info = model.fn_info[key]
                    for root_name, line, kind in info.name_mutations:
                        if root_name == s.name:
                            findings.append(
                                self.finding(
                                    "contract-violation",
                                    c.file,
                                    line,
                                    f"{subject}:{s.name}",
                                    f"entry {key[1]}() mutates {s.name!r} "
                                    f"({kind}) but the contract declares it "
                                    "read-only from the spawned thread",
                                )
                            )
            elif s.safety == "merged-post-join":
                discarded = [
                    site
                    for site in model.task_sites
                    if site.call_id in model.discarded_calls
                ]
                if model.task_sites and len(discarded) == len(
                    model.task_sites
                ):
                    findings.append(
                        self.finding(
                            "contract-violation",
                            c.file,
                            model.task_sites[0].line,
                            f"{subject}:{s.name}",
                            "every submit/map result is discarded — the "
                            "declared post-join merge cannot be happening; "
                            "tasks must be communicating through shared "
                            "state instead",
                        )
                    )
            elif s.safety == "atomic-append":
                self._verify_atomic_append(c, s, model, findings, subject)

    def _verify_lock_guarded(
        self,
        c: ConcurrencyContract,
        s: SharedState,
        models: dict,
        findings: list,
        subject: str,
    ) -> None:
        if ":" in s.name:
            file_ref, _, clsattr = s.name.rpartition(":")
        else:
            file_ref, clsattr = c.file, s.name
        cls, _, attr = clsattr.partition(".")
        target = models.get(file_ref)
        if target is None or cls not in target.classes:
            findings.append(
                self.finding(
                    "stale-contract",
                    c.file,
                    1,
                    f"{subject}:{s.name}",
                    f"lock-guarded declaration {s.name!r} names no class "
                    "in the tree — update or delete the declaration",
                )
            )
            return
        analysis = _analyze(target, self.contracts)
        for key, info in target.fn_info.items():
            if key[0] != cls or key in analysis.init_phase:
                continue
            for w in info.writes:
                if attr and w.attr != attr:
                    continue
                if s.guard not in w.guards:
                    findings.append(
                        self.finding(
                            "contract-violation",
                            file_ref,
                            w.line,
                            f"{subject}:{s.name}",
                            f"{cls}.{w.attr} is declared lock-guarded by "
                            f"{s.guard!r} (contract on {c.file}) but "
                            f"{key[1]}() writes it without holding the "
                            "lock",
                        )
                    )

    def _verify_atomic_append(
        self,
        c: ConcurrencyContract,
        s: SharedState,
        model: _FileModel,
        findings: list,
        subject: str,
    ) -> None:
        # a shared list the entry points take as a parameter (a thread
        # target that is a module function) is held to the same rule there
        for name in c.entry_points:
            for key in model.resolve_entry_name(name):
                info = model.fn_info[key]
                if s.name not in info.param_names:
                    continue
                for root_name, line, kind in info.name_mutations:
                    if root_name == s.name and kind != "call:append":
                        findings.append(
                            self.finding(
                                "contract-violation",
                                c.file,
                                line,
                                f"{subject}:{s.name}",
                                f"{s.name} is declared atomic-append but "
                                f"{key[1]}() performs a {kind} on it — only "
                                "bare .append() keeps the GIL-atomicity "
                                "argument",
                            )
                        )
        analysis = _analyze(model, self.contracts)
        for key, info in model.fn_info.items():
            if key[0] is None or key in analysis.init_phase:
                continue
            for w in info.writes:
                if w.attr != s.name:
                    continue
                if w.kind != "call:append":
                    findings.append(
                        self.finding(
                            "contract-violation",
                            c.file,
                            w.line,
                            f"{subject}:{s.name}",
                            f"{key[0]}.{s.name} is declared atomic-append "
                            f"but {key[1]}() performs a {w.kind} — only "
                            "bare .append() keeps the GIL-atomicity "
                            "argument",
                        )
                    )


register(LocksetPass())
register(EscapePass())
