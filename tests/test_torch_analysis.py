"""The static-analysis plane (``analysis/``) against the JAX package's.

- The shared fixture sources: tests/fixtures/analysis/ through both
  packages' metrics-contract and sim-purity passes and their gate
  (``run_passes`` with the fixture passes registered, stale and matched
  allowlist entries), and the mini-trees of
  tests/test_analysis_concurrency.py through both packages' lockset,
  escape and purity passes: the ``as_dict()`` lists are equal, with each
  package's directory name in its paths.
- The older lints' bodies, the port's copies against ``tools/``: the
  dashboard lint on the committed board and the fixture board, the rule
  lint on the rendered bundle and a tampered copy, the span lint on a
  tampered export, the rollup probe's line, and the fault lint's rows.
- The port's own tree: the gate is ok with no active finding and no stale
  entry, every thread construct has a contract and every contract is live,
  the registry holds JAX's ten pass names in JAX's order, and the
  allowlist holds JAX's entries re-pointed plus the port's one.
- The command, ``python -m k8s_gpu_hpa_tpu_torch.analysis``, against
  ``tools/analyze.py``: ``--list``, ``--all``, ``--pass`` with prefix
  groups, the JSON schema and the exit codes 0, 1 and 2.

Tolerance: exact.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from k8s_gpu_hpa_tpu import analysis as jax_analysis
from k8s_gpu_hpa_tpu.analysis import allowlist as jax_allowlist
from k8s_gpu_hpa_tpu.analysis import concurrency as jax_concurrency
from k8s_gpu_hpa_tpu.analysis import contracts as jax_contracts
from k8s_gpu_hpa_tpu.analysis import purity as jax_purity
from k8s_gpu_hpa_tpu_torch import analysis
from k8s_gpu_hpa_tpu_torch.analysis import allowlist, concurrency, contracts, legacy, purity
from k8s_gpu_hpa_tpu_torch.analysis.__main__ import main as analyze_main
from tests.test_torch_cores import confined_to_port_cores  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
PORT_PKG, JAX_PKG = "k8s_gpu_hpa_tpu_torch", "k8s_gpu_hpa_tpu"

PORT = dict(analysis=analysis, allowlist=allowlist, concurrency=concurrency,
            contracts=contracts, purity=purity, pkg=PORT_PKG)
REF = dict(analysis=jax_analysis, allowlist=jax_allowlist, concurrency=jax_concurrency,
           contracts=jax_contracts, purity=jax_purity, pkg=JAX_PKG)


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_torch_test_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _rows(findings, pkg: str = PORT_PKG) -> list[dict]:
    """Findings as sorted ``as_dict()`` rows, the port's directory name
    written as the JAX package's."""
    text = json.dumps([f.as_dict() for f in sorted(findings)])
    return json.loads(text.replace(f"{pkg}/", f"{JAX_PKG}/").replace(f"{pkg}.", f"{JAX_PKG}."))


def _report(report, pkg: str = PORT_PKG) -> dict:
    text = json.dumps(report.as_dict(), sort_keys=True)
    return json.loads(text.replace(f"{pkg}/", f"{JAX_PKG}/"))


def _fixture_config(mods):
    return mods["contracts"].ContractConfig(
        package_roots=("pkg",), native_sources=(), rule_manifests=(),
        dashboards=("bad_dashboard.yaml",), adapter_values=(), hpa_manifests=(), curated=())


# ---- the fixture tree ------------------------------------------------------------


def test_the_fixture_contract_findings_are_jax_s():
    port = contracts.MetricsContractPass(_fixture_config(PORT)).run(FIXTURES)
    ref = jax_contracts.MetricsContractPass(_fixture_config(REF)).run(FIXTURES)
    assert _rows(port) == _rows(ref, JAX_PKG)
    assert sorted(f.category for f in port) == [
        "dangling-consumer", "label-mismatch", "orphan-producer", "type-misuse"]
    # the dashboard's read credits the gauge: never an orphan as well
    assert "fixture_temp_celsius" not in {f.subject for f in port if f.category == "orphan-producer"}


def test_the_fixture_purity_finding_is_jax_s():
    scope = ("pkg/bad_simpath.py",)
    port = purity.SimPurityPass(purity.PurityConfig(scope=scope)).run(FIXTURES)
    ref = jax_purity.SimPurityPass(jax_purity.PurityConfig(scope=scope)).run(FIXTURES)
    assert _rows(port) == _rows(ref, JAX_PKG)
    (wall,) = port
    assert (wall.category, wall.subject) == ("wall-clock", "pkg/bad_simpath.py:time.time")


def _fixture_gate(mods, names, allow):
    a = mods["analysis"]
    a.register(mods["contracts"].MetricsContractPass(_fixture_config(mods)))
    a.register(mods["purity"].SimPurityPass(mods["purity"].PurityConfig(scope=("pkg/bad_simpath.py",))))
    try:
        return a.run_passes(names, root=FIXTURES, allowlist=allow(mods["allowlist"].AllowEntry))
    finally:
        a.register(mods["contracts"].MetricsContractPass())
        a.register(mods["purity"].SimPurityPass())


@pytest.mark.parametrize("names,allow,ok", [
    # the gate fails with all five seeded classes
    (["metrics-contract", "sim-purity"], lambda E: (), False),
    # a matched entry suppresses its finding and is not stale
    (["sim-purity"], lambda E: (E("sim-purity", "wall-clock", "pkg/bad_simpath.py:time.time",
                                  "seeded fixture violation"),), True),
    # an entry that matches nothing is itself a finding
    (["sim-purity"], lambda E: (E("sim-purity", "wall-clock", "pkg/never_existed.py:time.time",
                                  "stale on purpose"),), False),
])
def test_the_fixture_gate_is_jax_s(names, allow, ok):
    port = _fixture_gate(PORT, names, allow)
    ref = _fixture_gate(REF, names, allow)
    assert port.ok is ref.ok is ok
    assert _report(port) == _report(ref, JAX_PKG)


# ---- the concurrency mini-trees (tests/test_analysis_concurrency.py) -------------------

#: name -> (source, the passes it runs, the contract or None); ``{MOD}`` is
#: the module's repo-relative path in each package
SNIPPETS = {
    "unguarded_shared_write": ("""
        import threading

        class Worker:
            def __init__(self):
                self.count = 0
                self._t = None

            def start(self):
                self._t = threading.Thread(target=self._loop)
                self._t.start()

            def _loop(self):
                self.count = self.count + 1
        """, ("lockset",), None),
    "inconsistent_lockset": ("""
        import threading

        class Buf:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

            def add(self, x):
                with self._lock:
                    self._items.append(x)

            def reset(self):
                self._items = []
        """, ("lockset",), None),
    "disjoint_locks": ("""
        import threading

        class Two:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()
                self.x = 0

            def via_a(self):
                with self._a:
                    self.x += 1

            def via_b(self):
                with self._b:
                    self.x += 1
        """, ("lockset",), None),
    "init_phase_writes": ("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._finish()

            def _finish(self):
                self.x = 0

            def bump(self):
                with self._lock:
                    self.x += 1
        """, ("lockset",), None),
    "guard_propagates_to_helper": ("""
        import threading

        class H:
            def __init__(self):
                self._lock = threading.Lock()
                self._h = []

            def step(self):
                with self._lock:
                    self._h.append(1)
                    self._trim()

            def stats(self):
                with self._lock:
                    self._trim()
                    return len(self._h)

            def _trim(self):
                while self._h:
                    self._h.pop(0)
        """, ("lockset",), None),
    "declared_append_only_log": ("""
        import threading

        class Worker:
            def __init__(self):
                self.log = []

            def start(self):
                threading.Thread(target=self._loop).start()

            def _loop(self):
                self.log.append(1)
        """, ("lockset", "escape"), dict(construct="threading.Thread", invariant="append-only log",
                                         shared=(("log", "atomic-append", ""),))),
    "undeclared_thread_boundary": ("""
        from concurrent.futures import ThreadPoolExecutor

        def sweep(items):
            pool = ThreadPoolExecutor(max_workers=2)
            return list(pool.map(str, items))
        """, ("escape",), None),
    "cross_closure_escape": ("""
        from concurrent.futures import ThreadPoolExecutor

        class Sweep:
            def run(self, items):
                pool = ThreadPoolExecutor(max_workers=2)
                hits = []
                out = list(pool.map(lambda i: hits.append(i), items))
                pool.shutdown()
                return out
        """, ("escape",), dict(construct="concurrent.futures.ThreadPoolExecutor",
                               invariant="tasks own their state")),
    "stale_contract_without_boundary": ("x = 1\n", ("escape",),
                                        dict(construct="threading.Thread", invariant="gone")),
    "stale_contract_entry_point": ("""
        import threading

        class S:
            def start(self):
                threading.Thread(target=self._loop).start()

            def _loop(self):
                pass
        """, ("escape",), dict(construct="threading.Thread", invariant="x",
                               entry_points=("_vanished",))),
    "lock_guarded_contract_violation": ("""
        import threading
        from concurrent.futures import ThreadPoolExecutor

        class Store:
            def __init__(self):
                self._lock = threading.Lock()
                self.data = {}
                self.pool = ThreadPoolExecutor(max_workers=1)

            def put(self, k):
                with self._lock:
                    self.data[k] = 1

            def wipe(self):
                self.data = {}

            def run(self, ks):
                return list(self.pool.map(self.put, ks))
        """, ("escape", "lockset"), dict(construct="concurrent.futures.ThreadPoolExecutor",
                                         invariant="data under _lock",
                                         shared=(("{MOD}:Store.data", "lock-guarded", "_lock"),))),
    "atomic_append_contract_violation": ("""
        from concurrent.futures import ThreadPoolExecutor

        class Log:
            def __init__(self):
                self.entries = []
                self.pool = ThreadPoolExecutor(max_workers=1)

            def record(self, x):
                self.entries.append(x)

            def reset(self):
                self.entries = []

            def run(self, xs):
                return list(self.pool.map(self.record, xs))
        """, ("escape", "lockset"), dict(construct="concurrent.futures.ThreadPoolExecutor",
                                         invariant="append-only", entry_points=("record",),
                                         shared=(("entries", "atomic-append", ""),))),
    "read_only_contract_violation": ("""
        import threading

        def watch(state):
            state.flags.append(1)

        class Obs:
            def start(self, state):
                threading.Thread(target=watch).start()
        """, ("escape", "lockset"), dict(construct="threading.Thread",
                                         invariant="observer never mutates",
                                         entry_points=("watch",),
                                         shared=(("state", "read-only", ""),))),
    "merged_post_join_discarded": ("""
        from concurrent.futures import ThreadPoolExecutor

        class Fan:
            def __init__(self):
                self.pool = ThreadPoolExecutor(max_workers=2)

            def run(self, xs):
                for x in xs:
                    self.pool.submit(print, x)
        """, ("escape",), dict(construct="concurrent.futures.ThreadPoolExecutor",
                               invariant="merged after the join",
                               shared=(("results", "merged-post-join", ""),))),
    "serial_fallback_guard_gone": ("""
        from concurrent.futures import ThreadPoolExecutor

        def fan(items):
            with ThreadPoolExecutor(max_workers=2) as pool:
                return list(pool.map(str, items))
        """, ("escape",), dict(construct="concurrent.futures.ThreadPoolExecutor",
                               invariant="falls back when shared",
                               shared=(("sinks", "serial-fallback", "ev.tracer is not None"),))),
}


def _snippet_findings(mods, tmp_path: Path, name: str) -> list:
    source, passes, spec = SNIPPETS[name]
    root = tmp_path / mods["pkg"]
    pkg = root / mods["pkg"]
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text(textwrap.dedent(source))
    c = mods["concurrency"]
    mod = f"{mods['pkg']}/mod.py"
    contracts_ = ()
    if spec is not None:
        contracts_ = (c.ConcurrencyContract(
            file=mod, construct=spec["construct"], invariant=spec["invariant"],
            entry_points=spec.get("entry_points", ()),
            shared=tuple(c.SharedState(n.replace("{MOD}", mod), safety, guard=guard)
                         for n, safety, guard in spec.get("shared", ())),
        ),)
    found = []
    for which in passes:
        cls = c.LocksetPass if which == "lockset" else c.EscapePass
        found += cls(contracts=contracts_).run(root)
    return found


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_a_concurrency_mini_tree_gives_jax_s_findings(name, tmp_path):
    port = _snippet_findings(PORT, tmp_path, name)
    ref = _snippet_findings(REF, tmp_path, name)
    assert _rows(port) == _rows(ref, JAX_PKG)


def test_undeclared_sim_threading_is_a_purity_finding_in_both(tmp_path):
    rows = []
    for mods in (PORT, REF):
        pkg = tmp_path / mods["pkg"] / mods["pkg"] / "control"
        pkg.mkdir(parents=True)
        (pkg / "mod.py").write_text(
            "import threading\n\ndef go():\n    threading.Thread(target=print).start()\n")
        found = mods["purity"].SimPurityPass().run(tmp_path / mods["pkg"])
        rows.append(_rows(found, mods["pkg"]))
    assert rows[0] == rows[1]
    assert [r["category"] for r in rows[0]] == ["ambient-threading"]


def test_an_unknown_safety_kind_is_refused_in_both():
    for c in (concurrency, jax_concurrency):
        with pytest.raises(ValueError, match="unknown safety kind"):
            c.SharedState("x", "hopes-and-prayers")


# ---- the older lints' bodies ---------------------------------------------------------------


@pytest.mark.parametrize("board", [REPO / "deploy" / "grafana-dashboard.yaml",
                                   FIXTURES / "bad_dashboard.yaml", "non-canonical"])
def test_the_dashboard_lint_is_jax_s(board, tmp_path):
    tool = _load_tool("lint_promql_parity")
    if board == "non-canonical":
        board = tmp_path / "board.yaml"
        board.write_text((FIXTURES / "bad_dashboard.yaml").read_text().replace(
            "rate(fixture_temp_celsius[5m])", "rate( fixture_temp_celsius [5m])").replace(
            '"refId": "A"', '"refId": "A"\n        },\n        {\n         "expr": "sum(",\n'
            '         "refId": "B"'))
    got = legacy.lint_dashboard(board.read_text())
    assert got == tool.lint_dashboard(board)
    if board.parent == tmp_path:
        assert len(got[0]) == 2


@pytest.mark.parametrize("tamper", [None, "avg", "drop"])
def test_the_rule_lint_is_jax_s_on_the_rendered_bundle(tamper, tmp_path):
    tool = _load_tool("lint_promql_parity")
    text = contracts.read_surface(REPO, legacy.RULE_MANIFEST)
    if tamper == "avg":
        text = text.replace("avg(max by(node,pod,namespace)(tpu_tensorcore_utilization)",
                            "max(max by(node,pod,namespace)(tpu_tensorcore_utilization)", 1)
    elif tamper == "drop":
        text = text.replace("- record: tpu_test_duty_cycle_avg", "- record: tpu_test_duty_cycle_av", 1)
    path = tmp_path / "rule.yaml"
    path.write_text(text)
    got = legacy.lint_parity(text)
    assert got == tool.lint_parity(path)
    assert bool(got) is (tamper is not None)


def test_the_span_lint_is_jax_s_on_a_tampered_export(tmp_path):
    from k8s_gpu_hpa_tpu.obs import read_jsonl as jax_read
    from k8s_gpu_hpa_tpu_torch.control.cluster import SimCluster, SimDeployment
    from k8s_gpu_hpa_tpu_torch.control.loop import AutoscalingPipeline
    from k8s_gpu_hpa_tpu_torch.obs import Tracer, read_jsonl
    from k8s_gpu_hpa_tpu_torch.utils.clock import VirtualClock

    tool = _load_tool("lint_trace_schema")
    clock = VirtualClock()
    tracer = Tracer(clock)
    cluster = SimCluster(clock, nodes=[("n0", 4)])
    dep = SimDeployment(cluster, "tpu-test", "tpu-test", load_fn=lambda t: 30.0 if t < 30 else 95.0,
                        load_mode="shared")
    cluster.add_deployment(dep, replicas=1)
    AutoscalingPipeline(cluster, dep, target_value=40.0, tracer=tracer).start()
    clock.advance(90.0)
    path = tmp_path / "trace.jsonl"
    tracer.write_jsonl(path)
    lines = path.read_text().splitlines()
    rows = [json.loads(line) for line in lines]
    linked = next(i for i, r in enumerate(rows) if r.get("links"))
    rows[linked]["links"] = [rows[linked]["links"][0], 10**9, rows[linked]["span_id"]]
    rows[1]["span_id"] = rows[0]["span_id"]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    got = legacy.lint_spans(read_jsonl(path))
    assert got == tool.lint_spans(jax_read(path))
    assert len(got) >= 3


def test_the_live_checks_pass_as_jax_s():
    assert legacy.trace_selfcheck() == []
    trace_tool, probe_tool = _load_tool("lint_trace_schema"), _load_tool("downsample_probe")
    with contextlib.redirect_stdout(io.StringIO()):
        assert trace_tool._selfcheck() == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert probe_tool.main([]) == 0
    assert legacy.rollup_probe() == (True, buf.getvalue().strip())


def test_the_fault_lint_reads_every_port_test_s_natural_specs(tmp_path):
    assert legacy.lint_fault_kinds(REPO / "tests") == []
    assert _load_tool("lint_faults").lint_fault_kinds(REPO / "tests") == []
    # the pipeline kinds' table alone leaves the fleet kinds uncovered
    (tmp_path / "test_torch_chaos.py").write_text((REPO / "tests" / "test_torch_chaos.py").read_text())
    errors = legacy.lint_fault_kinds(tmp_path)
    assert errors == [
        f"{kind}: no NATURAL_SPECS row in tests/test_torch_*.py — excluded from the "
        "auto-covering injector parametrization"
        for kind in ("objstore_outage", "region_kill", "region_partition")
    ]


# ---- the port's own tree ----------------------------------------------------------------


@pytest.fixture(scope="module")
def gate():
    return analysis.run_passes()


def test_the_port_s_tree_passes_its_gate(gate):
    assert gate.ok, [f.render() for f in gate.findings]
    assert gate.findings == []
    assert not any(f.category == "stale-allowlist" for f in gate.findings)
    assert {f.subject for f, _ in gate.allowed} == {e.subject for e in allowlist.ALLOWLIST}
    assert gate.passes == [p.name for p in analysis.registered_passes()]


def test_the_registry_holds_jax_s_ten_passes_in_jax_s_order():
    names = [p.name for p in analysis.registered_passes()]
    assert names == [p.name for p in jax_analysis.registered_passes()]
    assert len(names) == 10


def test_the_allowlist_is_jax_s_re_pointed_plus_the_port_s_own():
    def key(e, pkg):
        return (e.pass_name, e.category, e.subject.replace(f"{pkg}/", f"{JAX_PKG}/"), e.justification)

    port = {key(e, PORT_PKG) for e in allowlist.ALLOWLIST}
    ref = {key(e, JAX_PKG) for e in jax_allowlist.ALLOWLIST}
    assert ref <= port
    assert {k[2] for k in port - ref} == {"probe_duty_cycle"}


def test_every_thread_construct_of_the_port_has_a_live_contract():
    escape = concurrency.EscapePass().run(REPO)
    assert escape == []
    models = concurrency._models(REPO)
    sites = [(rel, qual) for rel, m in models.items() for qual, _line in m.boundaries]
    assert sorted(sites) == [
        ("k8s_gpu_hpa_tpu_torch/control/operator.py", "threading.Thread"),
        ("k8s_gpu_hpa_tpu_torch/metrics/federation.py", "concurrent.futures.ThreadPoolExecutor"),
        ("k8s_gpu_hpa_tpu_torch/trial.py", "threading.Thread"),
        ("k8s_gpu_hpa_tpu_torch/trial.py", "threading.Thread"),
    ]
    for rel, qual in sites:
        assert concurrency.contract_for(rel, qual) is not None
    # the federation contract keeps JAX's three lock-guarded fields
    fed = concurrency.contract_for("k8s_gpu_hpa_tpu_torch/metrics/federation.py",
                                   "concurrent.futures.ThreadPoolExecutor")
    ref = jax_concurrency.contract_for("k8s_gpu_hpa_tpu/metrics/federation.py",
                                       "concurrent.futures.ThreadPoolExecutor")
    assert [(s.name.replace(PORT_PKG, JAX_PKG), s.safety, s.guard) for s in fed.shared] == [
        (s.name, s.safety, s.guard) for s in ref.shared]
    assert len(concurrency.CONTRACTS) == 4
    assert all(c.shared for c in concurrency.CONTRACTS)


def test_a_trial_contract_catches_a_non_append_write(tmp_path):
    """The port's two trial contracts hold their error lists to appends:
    an assignment in the loadgen thread, or a mutation of the feed's
    ``errors`` parameter, is a contract violation."""
    pkg = tmp_path / PORT_PKG
    pkg.mkdir()
    source = (REPO / PORT_PKG / "trial.py").read_text()
    broken = source.replace("self._errors.append(e)", "self._errors = [e]").replace(
        "        errors.append(e)\n", "        errors[:] = [e]\n")
    assert broken.count("_errors = [e]") == 1 and "errors[:] = [e]" in broken
    (pkg / "trial.py").write_text(broken)
    found = concurrency.EscapePass().run(tmp_path)
    violations = {f.subject for f in found if f.category == "contract-violation"}
    assert violations == {
        f"contract:{PORT_PKG}/trial.py:threading.Thread:_errors",
        f"contract:{PORT_PKG}/trial.py:threading.Thread:errors",
    }


# ---- the command --------------------------------------------------------------------------


def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_list_gives_jax_s_schema():
    rc, out, _ = _run(analyze_main, ["--list", "--json"])
    jrc, jout, _ = _run(_load_tool("analyze").main, ["--list", "--json"])
    assert rc == jrc == 0
    port, ref = json.loads(out), json.loads(jout)
    assert list(port) == list(ref) == ["passes"]
    assert [sorted(p) for p in port["passes"]] == [sorted(p) for p in ref["passes"]]
    assert [p["name"] for p in port["passes"]] == [p["name"] for p in ref["passes"]]
    rc, out, _ = _run(analyze_main, ["--list"])
    assert rc == 0 and len(out.splitlines()) == 10


@pytest.mark.parametrize("argv,code", [
    (["--pass", "no-such-pass"], 2),
    (["--bogus"], 2),
    ([], 2),
    (["--pass"], 2),
])
def test_a_usage_error_exits_2_as_jax_s(argv, code):
    rc, out, err = _run(analyze_main, argv)
    jrc, _, jerr = _run(_load_tool("analyze").main, argv)
    assert rc == jrc == code
    assert out == ""
    assert ("unknown pass" in err) is ("unknown pass" in jerr)


def test_a_prefix_group_expands_as_jax_s():
    rc, out, _ = _run(analyze_main, ["--pass", "concurrency", "--json"])
    jrc, jout, _ = _run(_load_tool("analyze").main, ["--pass", "concurrency", "--json"])
    assert rc == jrc == 0
    port, ref = json.loads(out), json.loads(jout)
    assert [p["name"] for p in port["passes"]] == [p["name"] for p in ref["passes"]] == [
        "concurrency-lockset", "concurrency-escape"]


def test_a_finding_exits_1_with_jax_s_report(tmp_path, monkeypatch):
    """Both commands pointed at a tree with one undeclared pool (and the
    escape pass holding no contract, as each package's shipped contracts
    describe its own tree): exit 1 and the same JSON report."""
    reports = []
    for mods, main in ((PORT, analyze_main), (REF, _load_tool("analyze").main)):
        root = tmp_path / mods["pkg"]
        (root / mods["pkg"]).mkdir(parents=True)
        (root / mods["pkg"] / "mod.py").write_text(textwrap.dedent(SNIPPETS["undeclared_thread_boundary"][0]))
        monkeypatch.setattr(mods["analysis"], "REPO_ROOT", root)
        mods["analysis"].register(mods["concurrency"].EscapePass(contracts=()))
        try:
            rc, out, _ = _run(main, ["--pass", "concurrency-escape", "--json"])
            assert rc == 1
            reports.append(json.loads(out.replace(f"{mods['pkg']}/", f"{JAX_PKG}/")))
            rc, out, err = _run(main, ["--pass", "concurrency-escape"])
            assert rc == 1 and "undeclared-thread-boundary" in out and "finding(s)" in err
        finally:
            mods["analysis"].register(mods["concurrency"].EscapePass())
    assert reports[0] == reports[1]
    assert [f["category"] for f in reports[0]["findings"]] == ["undeclared-thread-boundary"]


def test_the_module_command_is_clean_on_the_port_s_tree():
    proc = subprocess.run([sys.executable, "-m", "k8s_gpu_hpa_tpu_torch.analysis", "--all", "--json"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    report = json.loads(proc.stdout)
    assert list(report) == ["passes", "findings", "allowed", "ok"]
    assert report["ok"] and report["findings"] == []
    assert [p["name"] for p in report["passes"]] == [
        p.name for p in jax_analysis.registered_passes()]
    assert all(sorted(p) == ["allowed", "description", "findings", "name"] for p in report["passes"])
    assert all(sorted(a) == ["category", "file", "justification", "line", "message", "pass",
                             "subject"] for a in report["allowed"])
