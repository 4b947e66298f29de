"""The port's multi-process shard fabric on the CPU, against the JAX
reference.

* The reference's fabric tests (``tests/core/test_fabric.py``) and its
  fabric test of the speculative pipeline, run against
  ``repro_torch.core`` with every worker on ``device="cpu"``.
* Parity: the consistent-hash ring and the request classifier place
  and classify alike in both packages, and one request script through
  the reference's ``ShardFabric(workers=2, storage="memory")`` and the
  port's gives the same statuses, trial ids, owners and per-worker
  ``state_digest()`` (the wall clock of every worker process is frozen
  through a ``sitecustomize`` on its path, so timestamps agree).
* No process the port's fabric spawns maps anything of JAX.

Every wait polls a condition up to a deadline.  Worker start-up is given
``spawn_timeout=120`` s: a worker imports torch, which a loaded machine
slows down, and no check here is about start-up time.  A worker wedged
with SIGSTOP is waited on until all its threads have stopped (on a
loaded machine a running thread finished a request first).
"""
import os
import signal
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (Client, ClientStudy, DurableStorage,  # noqa: E402
                              HopaasServer, HttpServiceRunner,
                              HttpTransport, RetryPolicy, ShardFabric,
                              ShardedHttpTransport, TokenManager,
                              WalDirectoryLockedError, suggestions)
from repro_torch.core.fabric import (HashRing, RouteTable,  # noqa: E402
                                     classify_target)
from repro_torch.core.storage import InMemoryStorage  # noqa: E402

_SPACE = {"x": suggestions.uniform(-1.0, 1.0)}

# generous retry: fabric tests inject crashes/freezes whose recovery
# (respawn ~1.5s) outlasts the default client backoff
_PATIENT = RetryPolicy(max_attempts=8, base_delay=0.1, max_delay=1.0)


def _fabric(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("spawn_timeout", 120.0)
    return ShardFabric(**kw)


def _client(fab, retry=None):
    tok = fab.issue_token("t")
    return Client(HttpTransport(fab.host, fab.port), tok,
                  retry=retry or _PATIENT), tok


def _study(client, name="fab", sampler="random"):
    return ClientStudy(name=name, client=client, properties=dict(_SPACE),
                       sampler={"name": sampler})


def _wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _stopped(pid: int) -> bool:
    """Every thread of process ``pid`` is stopped.  ``kill(SIGSTOP)``
    returns before the last of them has stopped: a thread that is
    running when the signal arrives stops when it next enters the
    kernel, and until then the process can still answer a request."""
    task = Path(f"/proc/{pid}/task")
    states = []
    for tid in os.listdir(task):
        try:
            stat = (task / tid / "stat").read_text()
        except FileNotFoundError:            # the thread has exited
            continue
        states.append(stat.rpartition(")")[2].split()[0])
    return bool(states) and all(s in ("T", "t") for s in states)


# --------------------------------------------------------------------------- #
# consistent-hash ring + request classification
# --------------------------------------------------------------------------- #
def test_hash_ring_minimal_remap_on_grow():
    keys = [f"study-{i:03d}" for i in range(200)]
    r3 = HashRing([0, 1, 2])
    r4 = HashRing([0, 1, 2, 3])
    moved = [k for k in keys if r3.owner(k) != r4.owner(k)]
    # every moved key must move TO the new worker, never between old ones
    assert moved and all(r4.owner(k) == 3 for k in moved)
    # and roughly 1/4 of the keys move, not a full reshuffle
    assert len(moved) < len(keys) // 2
    # placement is deterministic
    assert [r3.owner(k) for k in keys] == [HashRing([2, 1, 0]).owner(k)
                                           for k in keys]


def test_route_table_overrides_and_flip():
    table = RouteTable({0: ("h", 1), 1: ("h", 2)})
    key = "abc123"
    base = table.owner(key)
    other = 1 - base
    table.update(overrides={key: other})
    assert table.owner(key) == other            # override wins over ring
    table.update(clear_overrides=True)
    assert table.owner(key) == base
    # endpoints can grow before the ring flips: reachability before traffic
    table.update(endpoints={0: ("h", 1), 1: ("h", 2), 2: ("h", 3)},
                 ring_ids=[0, 1])
    assert table.endpoint(2) == ("h", 3)
    assert table.worker_ids() == [0, 1]


def test_classify_target_covers_both_surfaces():
    assert classify_target("POST", "/api/v2/studies/k1/trials:ask") == \
        ("key", "k1")
    assert classify_target("POST", "/api/v2/trials/k1:7:tell") == \
        ("key", "k1")
    assert classify_target("POST", "/api/v2/studies") == ("spec",)
    assert classify_target("GET", "/api/v2/studies?limit=5") == ("gather",)
    assert classify_target("POST", "/api/v2/trials:tell_batch") == \
        ("tell_batch",)
    assert classify_target("POST", "/api/ask/TOKEN") == ("spec",)
    assert classify_target("POST", "/api/tell/TOKEN") == ("uid",)
    assert classify_target("POST", "/api/tell_batch/TOKEN") == \
        ("tell_batch",)
    assert classify_target("GET", "/api/studies/TOKEN") == ("gather",)
    assert classify_target("GET", "/api/version") == ("default",)
    assert classify_target("DELETE", "/api/v2/studies") == ("default",)


# --------------------------------------------------------------------------- #
# exclusive WAL directory lock
# --------------------------------------------------------------------------- #
def test_wal_directory_lock_excludes_second_opener(tmp_path):
    root = str(tmp_path / "store")
    st = DurableStorage(root, fsync="off", auto_compact=False)
    with pytest.raises(WalDirectoryLockedError) as e:
        DurableStorage(root, fsync="off")
    assert "locked by another live process" in str(e.value)
    st.close()                                   # close releases the lock
    st2 = DurableStorage(root, fsync="off")
    st2.close()


# --------------------------------------------------------------------------- #
# fabric end-to-end: routing, both API surfaces, scatter-gather
# --------------------------------------------------------------------------- #
def test_fabric_routes_both_surfaces_and_gathers():
    fab = _fabric(workers=2, storage="memory").start()
    try:
        cl, tok = _client(fab)
        studies = [_study(cl, name=f"fab-{i}") for i in range(6)]
        for s in studies:
            s._ensure_key()
        locations = fab.locations()
        owned = {w: len(ks) for w, ks in locations.items()}
        assert sum(owned.values()) == 6
        assert len([w for w, n in owned.items() if n]) >= 1

        # v2 ask/tell through the router proxy
        for s in studies[:3]:
            t = s.ask()
            s.tell(t, value=abs(t.x))
        # v1 surface (spec- and uid-keyed bodies)
        ask = cl._post("ask", studies[0]._spec_body())
        tell = cl._post("tell", {"trial_uid": ask["trial_uid"],
                                 "value": 0.5})
        assert tell["state"] == "completed"

        # tell_batch split by owner, results merged back in order
        trials = [s.ask() for s in studies]
        results = cl.tell_batch(
            [{"trial_uid": t.uid, "value": 0.25, "state": "completed"}
             for t in trials])
        assert [r["uid"] for r in results] == [t.uid for t in trials]
        assert all(r["status"] == 200 for r in results)

        # scatter-gather study lists, v2 (paged) and v1
        v2 = {s["name"] for s in cl.studies()}
        assert {f"fab-{i}" for i in range(6)} <= v2
        status, payload, _ = HttpTransport(fab.host, fab.port).request_full(
            "GET", f"/api/studies/{tok}")
        assert status == 200
        assert {s["name"] for s in payload["studies"]} == v2
        # paging is positional across the merged list
        page = cl.trials_page(studies[0].study_key, limit=1)
        assert len(page["trials"]) == 1
        assert fab.stats()["dispatcher"]["proxied"] > 0
    finally:
        fab.stop()


def test_sharded_transport_skips_the_router_hop():
    fab = _fabric(workers=2, storage="memory").start()
    try:
        tok = fab.issue_token("t")
        transport = ShardedHttpTransport(fab.endpoints)
        cl = Client(transport, tok, retry=_PATIENT)
        s = _study(cl, name="direct")
        t = s.ask()
        s.tell(t, value=abs(t.x))
        resource = cl.study(s.study_key)
        assert resource["n_completed"] == 1
        # the keyed requests went straight to the owner: no proxying
        assert fab.stats()["dispatcher"]["proxied"] == 0
        transport.close()
    finally:
        fab.stop()


# --------------------------------------------------------------------------- #
# kill-and-rebalance a live study mid-campaign
# --------------------------------------------------------------------------- #
def test_migration_digest_identical_zero_lost_tells():
    fab = _fabric(workers=2, storage="durable", fsync="off",
                  respawn=False).start()
    try:
        cl, _tok = _client(fab)
        study = _study(cl, name="live")
        key = study._ensure_key()
        src = fab.owner_of(key)
        dst = [w for w in fab.locations() if w != src][0]

        stop = threading.Event()
        told, errors = [], []

        def campaign():
            while not stop.is_set():
                try:
                    t = study.ask()
                    study.tell(t, value=abs(t.x))
                    told.append(t.uid)
                except Exception as e:       # pragma: no cover - the assert
                    errors.append(repr(e))
                    return

        threads = [threading.Thread(target=campaign) for _ in range(3)]
        for th in threads:
            th.start()
        # the campaign in full flight, then rebalance under it and back
        assert _wait_for(lambda: len(told) >= 5 or errors)
        rec1 = fab.migrate(key, src, dst)
        n = len(told)
        assert _wait_for(lambda: len(told) >= n + 3 or errors)
        rec2 = fab.migrate(key, dst, src)
        n = len(told)
        assert _wait_for(lambda: len(told) >= n + 3 or errors)
        stop.set()
        for th in threads:
            th.join(timeout=30)
        assert not errors, errors

        # 1) both handoffs were digest-verified index-identical
        assert rec1["verified"] and rec2["verified"]
        assert rec1["src_digest"] == rec1["dst_digest"]
        # 2) zero lost tells: every acknowledged tell is a completion
        resource = cl.study(key)
        completed = {t["uid"] for t in cl.iter_trials(key,
                                                      state="completed")}
        assert set(told) <= completed
        # 3) no double-counted completions
        assert resource["n_completed"] == len(completed)
        assert len(told) == len(set(told))
        # the shard now lives where the second migration put it
        locations = fab.locations()
        assert key in locations[src] and key not in locations[dst]
    finally:
        fab.stop()


def test_add_and_remove_worker_rebalances():
    fab = _fabric(workers=2, storage="memory", respawn=False).start()
    try:
        cl, _tok = _client(fab)
        studies = [_study(cl, name=f"grow-{i}") for i in range(8)]
        for s in studies:
            s._ensure_key()
            t = s.ask()
            s.tell(t, value=abs(t.x))
        before = {k for ks in fab.locations().values() for k in ks}

        wid = fab.add_worker()
        locations = fab.locations()
        assert set(locations) == {0, 1, wid}
        assert {k for ks in locations.values() for k in ks} == before
        assert all(h["verified"] for h in fab.handoffs)
        # every study still serves reads and writes after the reshuffle
        for s in studies:
            t = s.ask()
            s.tell(t, value=abs(t.x))
            assert cl.study(s.study_key)["n_completed"] == 2

        fab.remove_worker(wid)
        locations = fab.locations()
        assert set(locations) == {0, 1}
        assert {k for ks in locations.values() for k in ks} == before
        assert cl.study(studies[0].study_key)["n_completed"] == 2
    finally:
        fab.stop()


# --------------------------------------------------------------------------- #
# a hung worker must not hang the router
# --------------------------------------------------------------------------- #
def test_hung_worker_yields_502_not_a_hung_router():
    fab = _fabric(workers=2, storage="memory", upstream_timeout=1.0,
                  respawn=False).start()
    try:
        cl, tok = _client(fab)
        study = _study(cl, name="hang")
        key = study._ensure_key()
        owner = fab.owner_of(key)
        # a study on the *other* worker, created before the wedge
        other = next(s for s in (_study(cl, name=f"hang-{i}")
                                 for i in range(20))
                     if fab.owner_of(s._ensure_key()) != owner)
        fab.kill_worker(owner, sig=signal.SIGSTOP)   # wedge, don't die
        try:
            assert _wait_for(lambda: _stopped(fab._workers[owner].pid))
            raw = HttpTransport(fab.host, fab.port, timeout=20.0)
            t0 = time.monotonic()
            status, payload, _ = raw.request_full(
                "POST", f"/api/v2/studies/{key}/trials:ask",
                {"worker_id": "t"},
                headers={"Authorization": f"Bearer {tok}"})
            elapsed = time.monotonic() - t0
            assert status == 502, (status, payload)
            assert payload["error"]["code"] == "bad_upstream"
            # bounded by the 1s upstream timeout, not the 20s client one
            # (generous slack: CI boxes time-share the cores)
            assert elapsed < 10.0
            # other workers' studies keep serving while one is wedged
            t = other.ask()
            other.tell(t, value=0.0)
        finally:
            fab.kill_worker(owner, sig=signal.SIGCONT)
        # the un-wedged worker serves again (client retries ride it out)
        t = study.ask()
        study.tell(t, value=abs(t.x))
    finally:
        fab.stop()


# --------------------------------------------------------------------------- #
# crash respawn: digest-verified recovery + lease requeue
# --------------------------------------------------------------------------- #
def test_crashed_worker_respawns_with_state_and_requeues_leases():
    fab = _fabric(workers=2, storage="durable", fsync="always",
                  lease_seconds=1.0, respawn_poll=0.1).start()
    try:
        cl, _tok = _client(fab)
        study = _study(cl, name="crash")
        key = study._ensure_key()
        for _ in range(3):
            t = study.ask()
            study.tell(t, value=abs(t.x))
        leased = study.ask()                 # in flight when the crash hits
        leased_at = time.time()
        wid = fab.owner_of(key)
        pre_digest = fab.worker_digest(wid)  # latest state, fsynced
        old_pid = fab._workers[wid].pid

        fab.kill_worker(wid, sig=signal.SIGKILL)
        wp = fab.wait_respawn(wid, old_pid, timeout=120)
        assert wp.pid != old_pid
        # recovery replayed the WAL to the exact pre-crash state; under
        # REPRO_REPLICAS>0 the same crash is healed by promoting a
        # follower (failover) instead of respawning on the WAL
        assert wp.digest == pre_digest
        event = [e for e in fab.events
                 if e["event"] in ("respawn", "failover")][-1]
        assert event["digest_match"] is True
        assert event["recovery"]["records_replayed"] >= 0

        # the lease taken through the dead worker lapses and is requeued:
        # the same params come back on the next ask
        assert _wait_for(lambda: time.time() > leased_at + 1.2)
        revived = study.ask()
        assert revived.params == leased.params
        study.tell(revived, value=abs(revived.params["x"]))
        assert cl.study(key)["n_completed"] == 4
        assert fab.respawns + fab.failovers >= 1
    finally:
        fab.stop()


def _fabric_children() -> list[int]:
    """Live (not zombie) worker processes whose parent is this process."""
    me = str(os.getpid())
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
        except OSError:                      # the process has exited
            continue
        state, ppid = stat.rpartition(")")[2].split()[:2]
        if ppid == me and state != "Z" and b"--serve-worker" in cmd:
            out.append(int(pid))
    return out


def test_stop_during_respawn_leaves_no_worker_alive():
    """``stop()`` while the monitor is respawning a killed worker.  The
    respawned worker comes up only after ``stop()`` has begun, and later
    than ``stop()`` once waited for the monitor (a worker takes 7-10 s
    to start on a loaded host): the monitor must end it."""
    fab = _fabric(workers=2, storage="memory", respawn_poll=0.1)
    spawning = threading.Event()
    real_spawn = fab._spawn

    def slow_spawn(*args, **kwargs):
        wp = real_spawn(*args, **kwargs)
        if fab._started and threading.current_thread() is fab._monitor:
            spawning.set()
            time.sleep(6.0)
        return wp

    fab._spawn = slow_spawn
    before = set(_fabric_children())
    fab.start()
    try:
        assert len(set(_fabric_children()) - before) == 2
        fab.kill_worker(0, sig=signal.SIGKILL)
        assert spawning.wait(120.0)
    finally:
        fab.stop()
    assert set(_fabric_children()) - before == set()
    assert fab._monitor is not None and not fab._monitor.is_alive()


# --------------------------------------------------------------------------- #
# in-process router mode (REPRO_WORKERS / HttpServiceRunner(workers=N))
# --------------------------------------------------------------------------- #
def test_runner_fabric_mode_preserves_semantics():
    storage = InMemoryStorage()
    tokens = TokenManager()
    servers = [HopaasServer(storage=storage, tokens=tokens, seed=i,
                            device="cpu")
               for i in range(2)]
    # pin the evloop backend: the router needs the dispatcher hook, which
    # the threaded frontend lacks
    runner = HttpServiceRunner(servers, backend="evloop",
                               workers=3).start()
    try:
        cl = Client(HttpTransport(runner.host, runner.port),
                    tokens.issue("t"))
        studies = [_study(cl, name=f"inproc-{i}") for i in range(5)]
        for s in studies:
            t = s.ask()
            s.tell(t, value=abs(t.x))
        assert {s["name"] for s in cl.studies()} >= \
            {f"inproc-{i}" for i in range(5)}
        results = cl.tell_batch(
            [{"trial_uid": s.ask().uid, "value": 0.1, "state": "completed"}
             for s in studies])
        assert all(r["status"] == 200 for r in results)
        stats = runner.frontend_stats()
        assert stats["fabric_workers"] == 3
        assert stats["dispatcher"]["proxied"] > 0
        # the shared storage saw every write exactly once
        assert all(len(list(cl.iter_trials(s.study_key,
                                           state="completed"))) == 2
                   for s in studies)
    finally:
        runner.stop()


def test_runner_threaded_backend_ignores_workers():
    storage = InMemoryStorage()
    tokens = TokenManager()
    runner = HttpServiceRunner(
        [HopaasServer(storage=storage, tokens=tokens, device="cpu")],
        backend="threaded", workers=4)
    assert runner.fabric_workers == 1
    runner.start()
    try:
        cl = Client(HttpTransport(runner.host, runner.port),
                    tokens.issue("t"))
        s = _study(cl, name="threaded")
        t = s.ask()
        s.tell(t, value=0.0)
    finally:
        runner.stop()


def test_fabric_inline_single_worker_matches_plain_service():
    fab = _fabric(workers=1, storage="memory").start()
    try:
        assert fab.inline
        cl, _tok = _client(fab)
        s = _study(cl, name="solo")
        t = s.ask()
        s.tell(t, value=abs(t.x))
        assert cl.study(s.study_key)["n_completed"] == 1
        assert fab.stats()["workers"] == 1
        assert "dispatcher" not in fab.stats()
        assert {srv.device.type for srv in fab.servers} == {"cpu"}
    finally:
        fab.stop()


# --------------------------------------------------------------------------- #
# the speculative pipeline across the fabric's worker processes
# --------------------------------------------------------------------------- #
def test_fabric_workers_inherit_depth_and_fleet_health_aggregates(
        monkeypatch):
    """REPRO_SPECULATE propagates to fabric worker processes; the fleet
    health rolls their per-worker counters into one block."""
    monkeypatch.setenv("REPRO_SPECULATE", "4")
    fab = _fabric(workers=2, storage="memory").start()
    try:
        spec = fab.health()["speculation"]
        assert spec["enabled"] is True
        assert spec["workers_reporting"] == 2
    finally:
        fab.stop()


# --------------------------------------------------------------------------- #
# parity with the reference fabric
# --------------------------------------------------------------------------- #
def test_ring_and_classifier_match_the_reference():
    from repro.core.fabric import HashRing as RefRing
    from repro.core.fabric import _key_from_spec as ref_key_from_spec
    from repro.core.fabric import classify_target as ref_classify
    from repro_torch.core.fabric import _key_from_spec

    keys = [f"{i:016x}" for i in range(0, 4000, 7)]
    for ids in ([0, 1], [0, 1, 2, 3], [0, 2, 5], [3]):
        ref, port = RefRing(ids), HashRing(ids)
        assert [port.owner(k) for k in keys] == [ref.owner(k) for k in keys]
    targets = [("POST", "/api/v2/studies/k1/trials:ask"),
               ("POST", "/api/v2/studies/k1/trials:ask_batch"),
               ("GET", "/api/v2/studies/k1/trials?state=completed"),
               ("POST", "/api/v2/trials/k1:7:tell"),
               ("POST", "/api/v2/trials/k1:7:report"),
               ("GET", "/api/v2/trials/k1:7"),
               ("POST", "/api/v2/studies"), ("GET", "/api/v2/studies"),
               ("POST", "/api/v2/trials:tell_batch"),
               ("POST", "/api/ask/T"), ("POST", "/api/ask_batch/T"),
               ("POST", "/api/tell/T"), ("POST", "/api/should_prune/T"),
               ("POST", "/api/tell_batch/T"), ("GET", "/api/studies/T"),
               ("GET", "/api/version"), ("GET", "/api/v2/health"),
               ("GET", "/api/v2/openapi"), ("DELETE", "/api/v2/studies")]
    assert ([classify_target(m, p) for m, p in targets]
            == [ref_classify(m, p) for m, p in targets])
    spec = {"name": "ring", "properties": {
        "x": {"type": "uniform", "low": 0, "high": 1}},
        "sampler": {"name": "tpe"}}
    assert _key_from_spec(spec) == ref_key_from_spec(spec)


_PARITY_SAMPLERS = [{"name": "random"}, {"name": "quasirandom", "seed": 3},
                    {"name": "grid"}, {"name": "cmaes", "seed": 1},
                    {"name": "tpe", "n_startup_trials": 40},
                    {"name": "gp", "n_startup_trials": 40}]
_PARITY_SPACE = {"x": {"type": "uniform", "low": -5, "high": 5},
                 "lr": {"type": "loguniform", "low": 1e-5, "high": 1e-1},
                 "n": {"type": "int", "low": 2, "high": 9},
                 "c": {"type": "categorical", "choices": ["a", "b", "c"]}}


def _parity_value(params):
    return round((params["x"] - 1) ** 2 + params["n"] * 0.1
                 + (params["c"] == "b"), 9)


def _fabric_script(fab):
    """One request script through the router: a study per sampler, then
    rounds of ask, report, tell, ask_batch and a tell_batch across every
    study.  Returns [(request, status, trial ids)], the study keys, their
    owners and each worker's state digest."""
    tok = fab.issue_token("parity")
    transport = HttpTransport(fab.host, fab.port)
    auth = {"Authorization": f"Bearer {tok}"}
    log = []

    def call(method, path, body=None):
        status, payload, _ = transport.request_full(method, path, body,
                                                    auth)
        trials = (payload.get("trials") if isinstance(payload, dict)
                  else None) or ([payload] if "trial_id" in payload else [])
        log.append((method, path, status,
                    [t.get("trial_id") for t in trials]))
        return status, payload

    keys = []
    for i, sampler in enumerate(_PARITY_SAMPLERS):
        _, created = call("POST", "/api/v2/studies", {
            "name": f"parity-{i}", "properties": _PARITY_SPACE,
            "sampler": sampler})
        keys.append(created["study"]["key"])
    for r in range(3):
        tells = []
        for key in keys:
            _, trial = call("POST", f"/api/v2/studies/{key}/trials:ask",
                            {"worker_id": f"w{r}"})
            value = _parity_value(trial["params"])
            call("POST", f"/api/v2/trials/{trial['uid']}:report",
                 {"step": 1, "value": value})
            call("POST", f"/api/v2/trials/{trial['uid']}:tell",
                 {"value": value, "state": "completed"})
            _, batch = call("POST",
                            f"/api/v2/studies/{key}/trials:ask_batch",
                            {"n": 2, "worker_id": "wb"})
            tells += [{"trial_uid": t["uid"],
                       "value": _parity_value(t["params"])}
                      for t in batch["trials"]]
        call("POST", "/api/v2/trials:tell_batch", {"tells": tells})
    call("POST", f"/api/v2/trials/{keys[0]}:1:tell", {"value": 1.0})  # 409
    call("POST", f"/api/v2/studies/{keys[0]}/trials:ask_batch", {"n": 0})
    call("GET", f"/api/v2/studies/{'0' * 16}")                      # 404
    owners = [fab.owner_of(k) for k in keys]
    digests = [fab.worker_digest(w) for w in sorted(fab.locations())]
    transport.close()
    return log, keys, owners, digests


def test_fabric_request_script_matches_reference(tmp_path, monkeypatch):
    site = tmp_path / "frozen-clock"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import time\n"
        "time.time = lambda: 1_700_000_000.0\n")
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", str(site) + (os.pathsep + path
                                                  if path else ""))
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    from repro.core.fabric import ShardFabric as RefFabric

    runs = []
    for make in (lambda: RefFabric(workers=2, storage="memory",
                                   spawn_timeout=120.0),
                 lambda: _fabric(workers=2, storage="memory")):
        fab = make().start()
        try:
            runs.append(_fabric_script(fab))
        finally:
            fab.stop()
    (ref_log, ref_keys, ref_owners, ref_digests), port = runs
    log, keys, owners, digests = port
    assert {e[2] for e in log} >= {200, 201, 404, 409, 422}
    assert log == ref_log
    assert keys == ref_keys
    assert owners == ref_owners and len(set(owners)) == 2
    assert digests == ref_digests


# --------------------------------------------------------------------------- #
# no process of the port's fabric maps JAX
# --------------------------------------------------------------------------- #
def _jax_mappings(pid):
    with open(f"/proc/{pid}/maps") as f:
        paths = {line.split()[-1] for line in f if "/" in line}
    jax = sorted(p for p in paths
                 if {"jax", "jaxlib"} & set(Path(p).parts))
    return jax, paths


@pytest.mark.skipif(not os.path.exists("/proc/self/maps"),
                    reason="needs /proc/<pid>/maps")
def test_fabric_processes_map_no_jax():
    fab = _fabric(workers=2, replicas=1).start()
    try:
        cl, _tok = _client(fab)
        s = _study(cl, name="maps", sampler="tpe")
        for _ in range(3):
            t = s.ask()
            s.tell(t, value=abs(t.x))
        health = fab.health()
        pids = [w["pid"] for w in health["workers"]]
        roles = sorted(w["role"] for w in health["workers"])
        assert roles == ["follower", "follower", "leader", "leader"]
        for pid in pids:
            jax, paths = _jax_mappings(pid)
            assert not jax, (pid, jax)
            # the check sees the libraries the worker loaded
            assert any("libtorch" in Path(p).name for p in paths), pid
    finally:
        fab.stop()
