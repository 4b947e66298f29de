"""The port's service against the JAX reference, on the CPU.

* One request script (create, ask, ask_batch, tell, tell_batch, report,
  listings, the v1 shim and the 401/404/405/409/422 errors) runs through
  ``repro.core.server.HopaasServer(seed=0)`` and the port's
  ``HopaasServer(seed=0, device="cpu")``.  With the numpy samplers, and
  with TPE inside its startup phase, every payload and the final
  ``state_digest()`` are identical; with TPE past startup the statuses,
  trial ids and states are.  The wall clock is frozen for both runs, so
  timestamps agree.
* HTTP, speculative precompute, durable state carried across in both
  directions, the no-fallback rule and the import guards.
"""
import ast
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core.durable import DurableStorage as RefDurable  # noqa: E402
from repro.core.server import HopaasServer as RefServer  # noqa: E402
from repro.core.storage import InMemoryStorage as RefMemory  # noqa: E402
from repro.core.types import Study as RefStudy  # noqa: E402
from repro.core.types import Trial as RefTrial  # noqa: E402
from repro_torch.core import service as port_service  # noqa: E402
from repro_torch.core.auth import TokenManager  # noqa: E402
from repro_torch.core.client import Client  # noqa: E402
from repro_torch.core.durable import DurableStorage  # noqa: E402
from repro_torch.core.server import HOPAAS_VERSION, HopaasServer  # noqa: E402
from repro_torch.core.storage import from_reference_record  # noqa: E402
from repro_torch.core.transport import (HttpServiceRunner,  # noqa: E402
                                        HttpTransport, ShardedHttpTransport)
from repro_torch.core.types import Study, Trial  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SRC = Path(__file__).resolve().parents[1] / "src"
SPACE = {"x": {"type": "uniform", "low": -5, "high": 5},
         "lr": {"type": "loguniform", "low": 1e-5, "high": 1e-1},
         "n": {"type": "int", "low": 2, "high": 9},
         "c": {"type": "categorical", "choices": ["a", "b", "c"]}}
FROZEN = 1_700_000_000.0


def _value(params):
    return round((params["x"] - 1) ** 2 + params["n"] * 0.1
                 + (params["c"] == "b"), 9)


def _script(server, token, sampler, rounds):
    """Run the request script; returns [(method, path, status, payload)]."""
    log = []

    def call(method, path, body=None, auth=True):
        headers = {"Authorization": f"Bearer {token}"} if auth else {}
        status, payload, _ = server.handle_request(method, path, body,
                                                   headers)
        log.append((method, path, status, payload))
        return status, payload

    spec = {"name": "parity", "properties": SPACE, "sampler": sampler,
            "pruner": {"name": "median", "n_warmup_steps": 1}}
    call("GET", "/api/version", auth=False)
    call("GET", "/api/v2/version", auth=False)
    call("GET", "/api/v2/openapi", auth=False)
    _, created = call("POST", "/api/v2/studies", spec)
    key = created["study"]["key"]
    call("POST", "/api/v2/studies", spec)
    first_uid = None
    for i in range(rounds):
        _, trial = call("POST", f"/api/v2/studies/{key}/trials:ask",
                        {"worker_id": f"w{i}"})
        uid = trial["uid"]
        first_uid = first_uid or uid
        call("POST", f"/api/v2/trials/{uid}:report",
             {"step": 1, "value": _value(trial["params"])})
        call("POST", f"/api/v2/trials/{uid}:tell",
             {"value": _value(trial["params"]), "state": "completed"})
        _, batch = call("POST", f"/api/v2/studies/{key}/trials:ask_batch",
                        {"n": 3, "worker_id": "wb"})
        call("POST", "/api/v2/trials:tell_batch", {"tells": [
            {"trial_uid": t["uid"], "value": _value(t["params"])}
            for t in batch["trials"]]})
    # the v1 shim (token in the path)
    _, v1 = call("POST", f"/api/ask/{token}", spec)
    call("POST", f"/api/should_prune/{token}",
         {"trial_uid": v1["trial_uid"], "step": 2, "value": 0.5})
    call("POST", f"/api/tell/{token}",
         {"trial_uid": v1["trial_uid"], "value": 0.25})
    call("POST", f"/api/ask_batch/{token}", {**spec, "n": 2})
    call("GET", f"/api/studies/{token}")
    # listings
    call("GET", "/api/v2/studies")
    call("GET", f"/api/v2/studies/{key}")
    call("GET", f"/api/v2/studies/{key}/trials?state=completed&limit=2")
    call("GET", f"/api/v2/studies/{key}/trials?limit=5&cursor=2")
    call("GET", f"/api/v2/trials/{uid}")
    # errors
    call("GET", "/api/v2/studies", auth=False)                       # 401
    call("GET", f"/api/v2/studies/{'0' * 16}")                       # 404
    call("DELETE", f"/api/v2/studies/{key}")                         # 405
    # the first trial is never pruned (no earlier reports at its step)
    call("POST", f"/api/v2/trials/{first_uid}:tell",
         {"value": 1.0, "state": "completed"})                      # 409
    call("POST", f"/api/v2/studies/{key}/trials:ask_batch", {"n": 0})  # 422
    call("POST", "/api/v2/studies", {**spec, "sampler": {"name": "nope"}})
    return log


def _freeze_clock(monkeypatch):
    """Freeze the wall clock, including the ``created_at`` defaults of
    both packages' Trial and Study (their default factory is the
    original ``time.time``, bound when the class was made)."""
    monkeypatch.setattr(time, "time", lambda: FROZEN)
    for cls in (RefTrial, RefStudy, Trial, Study):
        def init(self, *args, _orig=cls.__init__, **kwargs):
            kwargs.setdefault("created_at", FROZEN)
            _orig(self, *args, **kwargs)
        monkeypatch.setattr(cls, "__init__", init)


def _run_both(monkeypatch, sampler, rounds):
    _freeze_clock(monkeypatch)
    token = TokenManager().issue("parity")
    ref = RefServer(storage=RefMemory(), seed=0)
    port = HopaasServer(seed=0, device="cpu")
    ref_log = _script(ref, token, sampler, rounds)
    port_log = _script(port, token, sampler, rounds)
    return ref, ref_log, port, port_log


@pytest.mark.parametrize("sampler", [
    {"name": "random"}, {"name": "quasirandom", "seed": 3},
    {"name": "grid"}, {"name": "cmaes", "seed": 1},
    {"name": "tpe", "n_startup_trials": 40},
    {"name": "gp", "n_startup_trials": 40}])
def test_request_script_identical(monkeypatch, sampler):
    ref, ref_log, port, port_log = _run_both(monkeypatch, sampler, 6)
    statuses = [e[2] for e in port_log]
    assert {401, 404, 405, 409, 422} <= set(statuses)
    for r, p in zip(ref_log, port_log, strict=True):
        assert p == r, (r[:3], p[:3])
    assert port.storage.state_digest() == ref.storage.state_digest()


def _projection(log):
    out = []
    for method, path, status, payload in log:
        trials = (payload.get("trials") if isinstance(payload, dict)
                  else None) or ([payload] if "trial_id" in payload else [])
        out.append((method, path.split("/")[-1].split(":")[-1], status,
                    [(t.get("trial_id"), t.get("state")) for t in trials
                     if isinstance(t, dict)]))
    return out


def test_request_script_tpe_past_startup(monkeypatch):
    ref, ref_log, port, port_log = _run_both(
        monkeypatch, {"name": "tpe", "n_startup_trials": 4}, 6)
    assert _projection(port_log) == _projection(ref_log)
    ref_study = ref.storage.studies()[0]
    port_study = port.storage.studies()[0]
    assert ([(t.trial_id, t.state.value) for t in port_study.trials]
            == [(t.trial_id, t.state.value) for t in ref_study.trials])
    # past startup the proposals come from the port's own generator
    assert port_log[-1][2] == ref_log[-1][2] == 422


def test_version_is_the_reference_version():
    assert HOPAAS_VERSION == "1.1.0-jax"


def test_http_round_trip():
    server = HopaasServer(device="cpu")
    runner = HttpServiceRunner(server, backend="evloop").start()
    try:
        client = Client(HttpTransport(runner.host, runner.port),
                        server.tokens.issue("http"))
        key, created = client.ensure_study(
            {"name": "http", "properties": SPACE,
             "sampler": {"name": "tpe", "n_startup_trials": 3}})
        assert created
        for _ in range(6):
            trial = client.ask(key)
            client.tell(trial["uid"], _value(trial["params"]))
        trials = client.ask_batch(key, 4)
        assert len({t["uid"] for t in trials}) == 4
        client.tell_batch([{"trial_uid": t["uid"], "value": 1.0}
                           for t in trials])
        study = client.study(key)
        assert study["n_completed"] == 10
        assert client.version() == HOPAAS_VERSION
    finally:
        runner.stop()


def test_speculative_precompute_drains():
    server = HopaasServer(device="cpu", speculate_depth=8)
    try:
        _, study = server.op_create_study(
            {"name": "spec", "properties": SPACE,
             "sampler": {"name": "tpe", "n_startup_trials": 4}})
        key = study["key"]
        for _ in range(6):
            (t,) = server.op_ask(key, "w", 1)
            server.op_tell(t["uid"], _value(t["params"]))
        ctx = server._context_for_key(key)
        deadline = time.monotonic() + 20
        while ctx.spec.depth() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ctx.spec.depth() > 0
        trials = server.op_ask(key, "w", 3)
        assert len(trials) == 3
        stats = server.speculation_stats()
        assert stats["published"] >= 1
        assert stats["hits"] + stats["stale_hits"] >= 1
    finally:
        server.close()


def _fill(server, n):
    _, study = server.op_create_study(
        {"name": "durable", "properties": SPACE,
         "sampler": {"name": "random"}})
    key = study["key"]
    for _ in range(n):
        (t,) = server.op_ask(key, "w", 1)
        server.op_tell(t["uid"], _value(t["params"]))
    server.op_ask(key, "w", 1)                    # one left RUNNING
    return key


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_durable_state_carried_across(tmp_path, direction):
    root = str(tmp_path / "wal")
    writer_cls, reader_cls = ((RefDurable, DurableStorage)
                              if direction == "reference_to_port"
                              else (DurableStorage, RefDurable))
    w_store = writer_cls(root, fsync="off")
    w_server = (RefServer(storage=w_store) if writer_cls is RefDurable
                else HopaasServer(storage=w_store, device="cpu"))
    key = _fill(w_server, 7)
    digest = w_store.state_digest()
    record = w_store.state_record()
    w_store.close()

    r_store = reader_cls(root, fsync="off")
    try:
        assert r_store.state_digest() == digest
        r_server = (RefServer(storage=r_store) if reader_cls is RefDurable
                    else HopaasServer(storage=r_store, device="cpu"))
        (t,) = r_server.op_ask(key, "w", 1)
        assert t["trial_id"] == 8                 # numbering continues
    finally:
        r_store.close()
    assert from_reference_record(record).state_digest() == digest


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        HopaasServer()
    with pytest.raises(SystemExit):
        port_service.main(["--port", "0"])


def _service_cli(argv, timeout=180.0):
    """Start ``service.main(argv)`` in a child process; returns the
    process, the router's URL and the API token from its banner."""
    code = ("import sys\n"
            "from repro_torch.core import service\n"
            "sys.exit(service.main(sys.argv[1:]))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.Popen([sys.executable, "-c", code, *argv], env=env,
                            stdout=subprocess.PIPE, text=True)
    url = token = None
    lines = []
    deadline = time.monotonic() + timeout
    while token is None and time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith("HOPAAS fabric at "):
            url = line.split()[3]
        elif line.startswith("API token: "):
            token = line.split()[2]
    if token is None:
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(f"no banner from the service: {lines}")
    return proc, url, token, lines


def _ask_tell(client, n=3):
    key, _ = client.ensure_study({"name": "fabric", "properties": SPACE,
                                  "sampler": {"name": "tpe",
                                              "n_startup_trials": 2}})
    for _ in range(n):
        trial = client.ask(key)
        client.tell(trial["uid"], _value(trial["params"]))
    return key, client.study(key)


@pytest.mark.parametrize("path", ["runner", "sharded_transport",
                                  "service_cli", "no_card"])
def test_fabric_paths_serve(tmp_path, monkeypatch, path):
    """The fabric modes of the transport and the service CLI serve, and
    asking for the card without one starts no process."""
    from repro_torch.core import fabric
    if path == "runner":
        server = HopaasServer(device="cpu")
        runner = HttpServiceRunner(server, backend="evloop",
                                   workers=2).start()
        try:
            client = Client(HttpTransport(runner.host, runner.port),
                            server.tokens.issue("runner"))
            _, study = _ask_tell(client)
            assert study["n_completed"] == 3
            stats = runner.frontend_stats()
            assert stats["fabric_workers"] == 2
            assert stats["dispatcher"]["proxied"] > 0
        finally:
            runner.stop()
    elif path == "sharded_transport":
        fab = fabric.ShardFabric(workers=2, storage="memory", device="cpu",
                                 spawn_timeout=120.0).start()
        try:
            transport = ShardedHttpTransport(fab.endpoints)
            client = Client(transport, fab.issue_token("direct"))
            key, study = _ask_tell(client)
            assert study["n_completed"] == 3
            # every keyed request went straight to the owner
            assert fab.stats()["dispatcher"]["proxied"] == 0
            owner = fab.owner_endpoint(key)
            assert transport._pool_for(
                "POST", f"/api/v2/studies/{key}/trials:ask",
                None) is transport._pools[fab.endpoints.index(owner)]
            transport.close()
        finally:
            fab.stop()
    elif path == "service_cli":
        proc, url, token, lines = _service_cli(
            ["--workers", "2", "--replicas", "1", "--device", "cpu",
             "--port", "0", "--journal-dir", str(tmp_path / "journal"),
             "--fsync", "off"])
        try:
            assert any("2 worker processes" in ln and "device=cpu" in ln
                       for ln in lines), lines
            assert any(ln.startswith("replication: 1 follower") and
                       ln.count(":leader@") == 2 and
                       ln.count(":follower@") == 2 for ln in lines), lines
            host, port = url[len("http://"):].rsplit(":", 1)
            client = Client(HttpTransport(host, int(port)), token)
            _, study = _ask_tell(client)
            assert study["n_completed"] == 3
            assert client.version() == HOPAAS_VERSION
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                assert proc.wait(timeout=60) == 0
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
        # the leaders and followers journaled under the one root
        assert {"worker-0", "worker-1", "worker-0-replica-0",
                "worker-1-replica-0"} <= set(os.listdir(tmp_path /
                                                        "journal"))
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        spawned = []

        def popen(*args, **kwargs):
            spawned.append(args)
            raise AssertionError("a fabric process was started")

        monkeypatch.setattr(fabric.subprocess, "Popen", popen)
        for kwargs in ({}, {"workers": 4, "replicas": 2}):
            with pytest.raises(RuntimeError, match="cuda"):
                fabric.ShardFabric(**kwargs)
        root = tmp_path / "journal"
        for argv in (["--workers", "2"],
                     ["--workers", "4", "--replicas", "2", "--device",
                      "cuda", "--journal-dir", str(root)]):
            with pytest.raises(SystemExit) as e:
                port_service.main(["--port", "0", *argv])
            assert e.value.code == 2
        assert not spawned and not root.exists()


def test_port_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "names += ['repro_torch.models', 'repro_torch.serve',\n"
        "          'repro_torch.kernels.flash_attention',\n"
        "          'repro_torch.launch.serve']\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print(len(names))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 60


# code held in a string: ``-c`` programs, ``-m`` module paths, dynamic
# imports; ``repro_torch`` is the port itself
_CODE_IN_STRING = re.compile(
    r"\b(?:from|import)\s+(?:repro|jax|jaxlib)\b(?!_)"
    r"|^(?:repro|jax|jaxlib)(?:\.\w+)*$")


def test_port_source_imports_neither_jax_nor_repro():
    """No ``import`` node of the port names JAX or the JAX package, and
    no string constant holds such an import or module path either (a
    program in a string, as a fabric worker's spawn line, passes the
    import walk)."""
    offenders = []
    for path in (SRC / "repro_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                if _CODE_IN_STRING.search(node.value):
                    offenders.append((str(path), node.lineno,
                                      node.value[:80]))
                continue
            else:
                continue
            offenders += [(str(path), n) for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not offenders
    assert _CODE_IN_STRING.search(
        "import sys; from repro.core.fabric import main")
    assert _CODE_IN_STRING.search("import jax.numpy as jnp")
    assert _CODE_IN_STRING.search("repro.core.fabric")
    assert not _CODE_IN_STRING.search(
        "import sys; from repro_torch.core.fabric import main")
