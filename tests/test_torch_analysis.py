"""The port's repro-check suite (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), which imports no JAX: both run here in
one process.

* Findings parity: every checker of both suites over the eight seeded
  fixture directories of ``tests/analysis/fixtures/`` (read in place)
  and over both cores gives the same findings, field for field and
  fingerprint for fingerprint.  Exact, no tolerance.
* ``--stats`` parity: ``print_stats`` prints the same lines.
* The port's CLI contract, mirroring ``tests/analysis/test_cli.py``
  against the port's own committed (empty) baseline.
* The port's sanitizer: ``cross_check``, the stall watchdog, the
  creation-site prefix, and end to end in subprocesses with ``jax`` and
  ``repro`` blocked: static lock keys over a served study, race mode on
  the port's ``FabricDispatcher``, and the pytest plugin.
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import cli as ref_cli  # noqa: E402
from repro.analysis.checkers import CHECKERS as REF_CHECKERS  # noqa: E402
from repro.analysis.loader import Project as RefProject  # noqa: E402
from repro_torch.analysis import cli, sanitize  # noqa: E402
from repro_torch.analysis.checkers import CHECKERS  # noqa: E402
from repro_torch.analysis.findings import Baseline  # noqa: E402
from repro_torch.analysis.loader import Project, load_core  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests/analysis/fixtures"
FIXTURES = ("clean", "evloop", "health", "hygiene", "lockcycle", "shared",
            "wal", "wire")
CORES = ("src/repro_torch/core", "src/repro/core")

# each seeded fixture under the configuration that points its own checker
# at it (as tests/analysis/test_checkers.py does); every other checker
# runs on it with its default configuration
_SEEDED = {
    ("lockcycle", "lock-order"): {
        "modules": ("lock_cycle",), "critical_modules": ("lock_cycle",),
        "aliases": {}},
    ("evloop", "evloop-blocking"): {
        "module": "io_block", "cls": "EventLoopFrontend",
        "entries": ("_loop", "_gone"), "allowed_kinds": ()},
    ("wal", "wal-order"): {
        "classes": ("BadStore",), "log_method": "_log", "roots": ("self",),
        "exempt_attrs": ()},
    ("wire", "wire-schema"): {
        "client_module": "wire_client", "schemas_module": "wire_schemas",
        "routes_modules": ("wire_routes",), "code_modules": None,
        "extra_codes": (), "probe_modules": (), "health_surfaces": ()},
    ("health", "wire-schema"): {
        "client_module": "health_client", "schemas_module": "health_schemas",
        "routes_modules": ("health_routes",), "code_modules": None,
        "extra_codes": (), "probe_modules": ("health_impl",),
        "health_surfaces": (
            {"name": "fleet-health",
             "producers": ("health_impl.Hub.status",
                           "health_impl.Fleet.health"),
             "consumers": ("health_impl.Fleet.gather",)},
            {"name": "ghost-surface",
             "producers": ("health_impl.Gone.status",),
             "consumers": ("health_impl.Fleet.gather",)})},
    ("shared", "shared-state"): {
        "classes": ("Worker", "Gone"), "root_subsystems": ("shared_bad",),
        "dispatch_edges": (), "extra_roots": (), "aliases": {}},
    ("hygiene", "thread-hygiene"): {"modules": ("hygiene_bad",)},
}


def _root(name: str) -> Path:
    return REPO / name if name in CORES else FIX / name


@functools.lru_cache(maxsize=None)
def _project(suite: str, name: str):
    cls = Project if suite == "port" else RefProject
    return cls(_root(name), repo_root=REPO).load()


@functools.lru_cache(maxsize=None)
def _findings(suite: str, name: str, checker: str) -> tuple:
    run = (CHECKERS if suite == "port" else REF_CHECKERS)[checker]
    found = run(_project(suite, name), _SEEDED.get((name, checker)))
    return tuple(sorted((*dataclasses.astuple(f), f.fingerprint)
                        for f in found))


# --------------------------------------------------------------------- #
# parity with the JAX package's suite
# --------------------------------------------------------------------- #
def test_port_registry_matches_the_reference():
    assert list(CHECKERS) == list(REF_CHECKERS)


@pytest.mark.parametrize("checker", list(REF_CHECKERS))
@pytest.mark.parametrize("root", FIXTURES + CORES)
def test_findings_parity(root, checker):
    """(checker, rule, path, line, symbol, message, detail, fingerprint)
    of every finding, equal in both suites."""
    port = _findings("port", root, checker)
    assert port == _findings("ref", root, checker)
    if (root, checker) in _SEEDED:
        assert port, "a seeded fixture must yield its finding"
    if root in CORES:
        assert port == ()                    # both cores are clean


@pytest.mark.parametrize("root", CORES)
def test_stats_parity(root):
    printed = []
    for mod, suite in ((cli, "port"), (ref_cli, "ref")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.print_stats(_project(suite, root)) == 0
        printed.append(buf.getvalue().splitlines())
    assert printed[0] == printed[1]
    assert len(printed[0]) == 4


def test_port_core_stats():
    """The port's core: the reference's 22 lock classes plus the two
    module locks of the kernel loader."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.print_stats(_project("port", CORES[0])) == 0
    out = buf.getvalue()
    assert "lock-order: 24 lock class(es)" in out
    assert "8/8 configured class(es) found" in out
    assert out.rstrip().endswith(", 0 flagged")
    from repro_torch.analysis.checkers.lock_order import build_lock_graph
    keys = build_lock_graph(_project("port", CORES[0]))["keys"]
    assert {"kernels._backend._lock", "kernels._backend._count_lock"} \
        <= set(keys)


# --------------------------------------------------------------------- #
# the port's CLI contract (tests/analysis/test_cli.py over the port)
# --------------------------------------------------------------------- #
def test_core_has_no_findings_beyond_committed_baseline():
    findings = cli.run_checkers(load_core(REPO))
    new, _known, _stale = Baseline.load(cli.DEFAULT_BASELINE).split(
        findings)
    assert not new, "\n".join(f.render() for f in new)


def test_committed_baseline_is_empty_and_the_ports_own():
    assert cli.DEFAULT_BASELINE.parent == Path(cli.__file__).resolve().parent
    data = json.loads(cli.DEFAULT_BASELINE.read_text())
    assert data == {"version": 1, "findings": {}}
    assert Baseline.load(cli.DEFAULT_BASELINE).entries == {}


def test_cli_clean_run_exits_zero(capsys):
    assert cli.main([]) == 0
    assert "; 0 new" in capsys.readouterr().out


def test_cli_fails_on_seeded_findings(tmp_path, capsys):
    rc = cli.main(["--root", str(FIX / "lockcycle"),
                   "--baseline", str(tmp_path / "b.json"),
                   "--checker", "lock-order"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "lock-cycle" in out and "1 new" in out


def test_cli_json_format(tmp_path, capsys):
    rc = cli.main(["--root", str(FIX / "lockcycle"),
                   "--baseline", str(tmp_path / "b.json"),
                   "--checker", "lock-order", "--format", "json"])
    assert rc == 1
    data = json.loads(capsys.readouterr().out)
    assert data["new"] and data["new"][0]["rule"] == "lock-cycle"
    assert data["baselined"] == [] and data["stale"] == []


def test_cli_write_baseline_then_suppressed(tmp_path, capsys):
    baseline = tmp_path / "b.json"
    common = ["--root", str(FIX / "lockcycle"), "--baseline", str(baseline),
              "--checker", "lock-order"]
    assert cli.main(common + ["--write-baseline"]) == 0
    capsys.readouterr()
    assert cli.main(common) == 0
    assert "baselined finding(s) suppressed" in capsys.readouterr().out


def test_cli_reports_stale_baseline_entries(tmp_path, capsys):
    baseline = tmp_path / "b.json"
    cli.main(["--root", str(FIX / "lockcycle"), "--baseline", str(baseline),
              "--checker", "lock-order", "--write-baseline"])
    capsys.readouterr()
    rc = cli.main(["--root", str(FIX / "clean"), "--baseline", str(baseline),
                   "--checker", "lock-order"])
    assert rc == 0
    assert "stale baseline entry" in capsys.readouterr().out


def test_cli_bad_root_is_usage_error(tmp_path):
    assert cli.main(["--root", str(tmp_path / "missing")]) == 2


def test_cli_stats_reports_coverage_and_exits_zero_on_core(capsys):
    rc = cli.main(["--stats"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "44 module(s)" in out             # the port's core by default
    for sub in ("aio:", "durable:", "fabric:", "replication:"):
        assert sub in out and f"{sub} 0" not in out


def test_cli_stats_fails_when_root_discovery_collapses(capsys):
    rc = cli.main(["--stats", "--root", str(FIX / "clean")])
    assert rc == 1
    assert "zero thread roots" in capsys.readouterr().err


# --------------------------------------------------------------------- #
# the port's sanitizer, in-process
# --------------------------------------------------------------------- #
def test_cross_check_flags_transitive_inversion():
    static = {("A", "B"): "s1", ("B", "C"): "s2"}
    out = sanitize.cross_check({("C", "A"): "r1"}, static)
    assert [i["edge"] for i in out["inversions"]] == ["C -> A"]
    assert out["inversions"][0]["static_reverse_path"] == "A ~> C"
    assert out["unknown"] == []


def test_cross_check_consistent_and_unknown_edges():
    out = sanitize.cross_check({("A", "B"): "r1", ("A", "Z"): "r2"},
                               {("A", "B"): "s1"})
    assert out["inversions"] == []
    assert [u["edge"] for u in out["unknown"]] == ["A -> Z"]


def test_cross_check_self_edge_is_not_an_inversion():
    out = sanitize.cross_check({("A", "A"): "r1"}, {("A", "B"): "s1"})
    assert out["inversions"] == []


def test_stall_watchdog_dumps_and_recovers(monkeypatch, capfd):
    monkeypatch.setattr(sanitize, "_STALL_SECONDS", 2.0)
    lock = sanitize._TrackedLock(sanitize._ORIG_LOCK(), "fixture.lock")
    before = len(sanitize.report()["stalls"])
    hold, release = threading.Event(), threading.Event()

    def holder():
        lock.acquire()
        hold.set()
        release.wait()
        lock.release()

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert hold.wait(5.0)
    threading.Timer(3.2, release.set).start()
    start = time.monotonic()
    assert lock.acquire()                    # stalls ~3 s, dumps at 2 s
    lock.release()
    t.join(5.0)
    assert time.monotonic() - start > 2.0
    stalls = sanitize.report()["stalls"]
    assert len(stalls) == before + 1
    assert stalls[-1]["key"] == "fixture.lock"
    err = capfd.readouterr().err
    assert "suspected deadlock" in err and "all thread stacks" in err


def _lock_line(path: Path, needle: str) -> int:
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if needle in line:
            return i
    raise AssertionError(f"{needle!r} not in {path}")


def test_factory_wraps_the_ports_locks_only(monkeypatch):
    """The creation-site prefix ends in its separator: in a process that
    holds both packages, a lock created on the same line of the JAX
    package's ``storage.py`` passes through unwrapped, while the port's
    is keyed to its static lock class."""
    monkeypatch.setattr(sanitize, "_site_keys",
                        sanitize._load_site_keys(str(REPO)))
    monkeypatch.setattr(sanitize, "_keys_seen", {})
    factory = sanitize._make_factory(sanitize._ORIG_LOCK,
                                     sanitize._src_prefix(str(REPO)))
    made = {}
    for pkg in ("repro", "repro_torch"):
        path = REPO / "src" / pkg / "core/storage.py"
        line = _lock_line(path, "self._registry_lock = threading.RLock()")
        code = compile("\n" * (line - 1) + "made[pkg] = factory()",
                       str(path), "exec")
        exec(code, {"factory": factory, "made": made, "pkg": pkg})
    assert not isinstance(made["repro"], sanitize._TrackedLock)
    assert isinstance(made["repro_torch"], sanitize._TrackedLock)
    assert made["repro_torch"].key == "storage.InMemoryStorage._registry_lock"


# --------------------------------------------------------------------- #
# end to end, in subprocesses with jax and repro blocked
# --------------------------------------------------------------------- #
_BLOCK = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None        # the port runs without JAX ...
    sys.modules["repro"] = None      # ... and without the JAX package


    def foreign_modules():
        return sorted(k for k, v in sys.modules.items() if v is not None
                      and k.split(".")[0] in ("jax", "jaxlib", "repro"))
""")


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.pop("REPRO_SANITIZE", None)
    env.pop("REPRO_TORCH_SANITIZE", None)
    env["PYTHONPATH"] = (str(REPO / "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def _run_prog(prog: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _BLOCK + prog],
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


def test_sanitizer_keys_the_ports_locks_over_a_served_study():
    data = _run_prog(textwrap.dedent("""
        import json
        from repro_torch.analysis import sanitize
        sanitize.install()
        from repro_torch.core import (Client, ClientStudy, DirectTransport,
                                      HopaasServer, suggestions)
        srv = HopaasServer(seed=0, device="cpu")
        cl = Client(DirectTransport(srv), srv.tokens.issue("t"))
        study = ClientStudy(name="san", client=cl,
                            properties={"x": suggestions.uniform(0, 1)},
                            sampler={"name": "tpe", "n_startup_trials": 2})
        for _ in range(5):
            t = study.ask()
            study.tell(t, value=abs(t.x - 0.3))
        out = sanitize.cross_check_repo()
        print(json.dumps({
            "keys": sorted(out["locks_created"]),
            "edges": len(out["edges"]),
            "inversions": out["inversions"],
            "stalls": out["stalls"],
            "foreign": foreign_modules(),
        }))
    """))
    keys = data["keys"]
    assert {"storage._StudyShard.lock", "kernels._backend._lock",
            "kernels._backend._count_lock"} <= set(keys), keys
    assert not [k for k in keys if k.startswith("src/repro_torch/core/")]
    assert data["edges"] > 0
    assert data["inversions"] == [] and data["stalls"] == []
    assert data["foreign"] == []


def test_race_mode_catches_seeded_unlocked_write_on_the_port():
    data = _run_prog(textwrap.dedent("""
        import json
        import threading
        from repro_torch.analysis import sanitize
        sanitize.install_race()
        from repro_torch.core.fabric import FabricDispatcher, RouteTable

        d = FabricDispatcher(RouteTable())

        def worker():
            d.seeded_racy = 2        # unlocked cross-thread write: flagged
            with d._conns_lock:
                d.seeded_locked = 2  # consistent lockset: clean
            d.proxied += 1           # allow-annotated in fabric.py: clean

        d.seeded_racy = 1
        with d._conns_lock:
            d.seeded_locked = 1
        d.proxied += 1
        t = threading.Thread(target=worker, name="hot")
        t.start()
        t.join()

        rep = sanitize.race_report()
        print(json.dumps({
            "flagged": sorted([v["class"], v["field"], sorted(v["threads"])]
                              for v in rep["violations"]),
            "classes": rep["instrumented_classes"],
            "instrumented": (FabricDispatcher.__module__, bool(
                FabricDispatcher.__dict__.get("__repro_race__"))),
            "tracked": rep["fields_tracked"],
            "allowed": rep["fields_allowed"],
            "foreign": foreign_modules(),
        }))
    """))
    from repro_torch.analysis.checkers import shared_state
    assert data["flagged"] == [
        ["FabricDispatcher", "seeded_racy", ["MainThread", "hot"]]]
    assert sorted(data["classes"]) == sorted(
        shared_state.DEFAULT_CONFIG["classes"])
    assert data["instrumented"] == ["repro_torch.core.fabric", True]
    assert data["tracked"] > 0 and data["allowed"] > 0
    assert data["foreign"] == []


def test_race_mode_raises_on_a_configured_class_it_cannot_find():
    proc = subprocess.run([sys.executable, "-c", _BLOCK + textwrap.dedent("""
        from repro_torch.analysis import sanitize
        from repro_torch.analysis.checkers import shared_state
        shared_state.DEFAULT_CONFIG["classes"] += ("GhostQueue",)
        sanitize.install_race()
    """)], env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "GhostQueue" in proc.stderr and "RuntimeError" in proc.stderr


_SEEDED_RACE_TEST = textwrap.dedent("""
    import threading

    from repro_torch.core.fabric import FabricDispatcher, RouteTable


    def test_unlocked_cross_thread_write_passes_but_is_recorded():
        d = FabricDispatcher(RouteTable())
        d.seeded_racy = 1
        t = threading.Thread(target=lambda: setattr(d, "seeded_racy", 2))
        t.start()
        t.join()
        assert d.seeded_racy == 2
""")


def _pytest_session(tmp_path: Path, **env) -> subprocess.CompletedProcess:
    (tmp_path / "conftest.py").write_text(_BLOCK)
    (tmp_path / "test_seeded_race.py").write_text(_SEEDED_RACE_TEST)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "repro_torch.analysis.pytest_plugin",
         str(tmp_path / "test_seeded_race.py")],
        cwd=tmp_path, env=_env(**env), capture_output=True, text=True,
        timeout=120)


def test_plugin_fails_the_session_on_a_seeded_race(tmp_path):
    proc = _pytest_session(tmp_path, REPRO_TORCH_SANITIZE="race")
    out = proc.stdout + proc.stderr
    assert proc.returncode != 0, out
    assert "repro-sanitize: RACE: FabricDispatcher.seeded_racy" in out
    assert "across 8 class(es)" in out
    # the test body passed: the failure is the session-finish hook's
    assert "[100%]" in out and "1 failed" not in out


def test_plugin_refuses_to_run_beside_the_reference_sanitizer(tmp_path):
    proc = _pytest_session(tmp_path, REPRO_TORCH_SANITIZE="1",
                           REPRO_SANITIZE="1")
    out = proc.stdout + proc.stderr
    assert proc.returncode != 0, out
    assert "REPRO_SANITIZE are both set" in out
    assert "passed" not in out
