"""The port's replicated durable shards on the CPU, against the JAX
reference.

* The reference's replication tests (``tests/core/test_replication.py``:
  the hub/client protocol, corruption rejection, the idempotency
  window, leases, the health surface, and the ``chaos`` drills on the
  real multi-process fabric) run against ``repro_torch.core`` with
  every server and fabric worker on ``device="cpu"``.
* The wire format is shared: a reference ``ReplicationHub`` feeds a
  port ``ReplicationClient`` and a port hub feeds a reference client,
  and each follower reaches the leader's digest.
* Every fault-injection site of the port is reached by normal operation
  (as ``tests/core/test_faults.py`` checks for the reference).

Every wait polls a condition up to a deadline; a window in which
something must *not* happen is polled the same way.  The semisync test
waits until the hub has registered its follower before it writes (the
client counts as connected once it has sent its hello, before the hub
has read it).  Fabric workers get ``spawn_timeout=120`` s and the drills
wait up to 120 s for a promotion: start-up of a worker that imports
torch on a loaded machine is not what they check, and the bound they do
check, the 5 s availability gap after a kill, is the reference's.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (Client, ClientStudy,  # noqa: E402
                              DirectTransport, DurableStorage,
                              HopaasServer, HttpTransport, InMemoryStorage,
                              ReplicationClient, ReplicationHub,
                              RetryPolicy, ShardFabric, TokenManager,
                              recover_dir_state, reconcile_with,
                              suggestions)
from repro_torch.core import faults  # noqa: E402
from repro_torch.core.durable import _describe_lock_meta  # noqa: E402
from repro_torch.core.fabric import FabricWorkerServer  # noqa: E402
from repro_torch.core.storage import _DEDUP_WINDOW  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
_SPACE = {"x": suggestions.uniform(-1.0, 1.0)}
_PATIENT = RetryPolicy(max_attempts=10, base_delay=0.1, max_delay=1.0)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.install({})
    yield
    faults.install({})


def _wait_for(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _server(**kw):
    return HopaasServer(seed=0, device="cpu", **kw)


def _drive(server, n=8, name="rep"):
    cl = Client(DirectTransport(server), server.tokens.issue("t"))
    study = ClientStudy(name=name, client=cl, properties=dict(_SPACE),
                        sampler={"name": "random"})
    for _ in range(n):
        t = study.ask()
        study.tell(t, value=abs(t.x))
    return cl, study


def _leader(tmp_path, name="leader", **kw):
    kw.setdefault("fsync", "off")
    kw.setdefault("auto_compact", False)
    return DurableStorage(str(tmp_path / name), **kw)


def _registered(hub):
    return lambda: any(f["connected"] for f in hub.status()["followers"])


# --------------------------------------------------------------------- #
# hub <-> client protocol
# --------------------------------------------------------------------- #
def test_follower_replays_stream_to_identical_digest(tmp_path):
    storage = _leader(tmp_path)
    hub = ReplicationHub(storage)
    storage.attach_replicator(hub)
    srv = _server(storage=storage)
    _drive(srv, n=6)

    shadow = _leader(tmp_path, "follower")
    client = ReplicationClient(shadow, ("127.0.0.1", hub.port)).start()
    try:
        assert client.wait_connected()
        assert client.wait_position(hub.position())
        assert shadow.state_digest() == storage.state_digest()
        # records published after attach stream live, not via baseline
        _drive(srv, n=3, name="rep2")
        assert client.wait_position(hub.position())
        assert shadow.state_digest() == storage.state_digest()
        # hub-side ack bookkeeping is asynchronous wrt the client's
        # applied position — poll it down to zero
        def caught_up():
            lag = hub.status()["followers"][0]
            return lag["lag_records"] == 0 and lag["lag_bytes"] == 0
        assert _wait_for(caught_up, timeout=5.0)
    finally:
        client.stop()
        hub.stop()
        shadow.close()
        storage.close()


def test_idle_leader_ships_at_most_one_baseline(tmp_path):
    """An empty leader (stream position 0) serving a fresh follower
    (also at 0) must ship its empty baseline once and then block for
    traffic — the cursor==0 re-baseline clause must not refire every
    loop iteration on an idle shard, busy-shipping empty baselines."""
    storage = _leader(tmp_path)
    hub = ReplicationHub(storage)
    storage.attach_replicator(hub)
    shadow = _leader(tmp_path, "follower")
    client = ReplicationClient(shadow, ("127.0.0.1", hub.port)).start()
    try:
        assert client.wait_connected()
        assert _wait_for(lambda: client.status()["baselines"] >= 1)
        # a busy loop ships thousands in this window
        assert not _wait_for(
            lambda: (hub.status()["baselines_shipped"] > 1
                     or client.status()["baselines"] > 1), timeout=0.5)
        # the idle connection still streams once traffic arrives
        srv = _server(storage=storage)
        _drive(srv, n=3)
        assert client.wait_position(hub.position())
        assert shadow.state_digest() == storage.state_digest()
    finally:
        client.stop()
        hub.stop()
        shadow.close()
        storage.close()


def test_follower_survives_restart_and_resyncs(tmp_path):
    """A new hub process (fresh session nonce) invalidates stream
    positions: the follower resets and takes a fresh baseline."""
    storage = _leader(tmp_path)
    hub = ReplicationHub(storage)
    storage.attach_replicator(hub)
    srv = _server(storage=storage)
    _drive(srv, n=4)
    shadow = InMemoryStorage()
    client = ReplicationClient(shadow, ("127.0.0.1", hub.port)).start()
    try:
        assert client.wait_connected()
        assert client.wait_position(hub.position())
        hub.stop()
        # the just-closed follower connection can hold the port briefly
        deadline = time.monotonic() + 10.0
        while True:
            try:
                hub2 = ReplicationHub(storage, port=hub.port)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        storage.attach_replicator(hub2)
        _drive(srv, n=2, name="after")
        # the client's stale position satisfies wait_position until it
        # has re-handshaken, so wait for the *new session* to catch up
        def resynced():
            st = client.status()
            return st["session"] == hub2.session and \
                st["pos"] >= hub2.position()
        assert _wait_for(resynced)
        assert client.status()["session"] == hub2.session
        assert shadow.state_digest() == storage.state_digest()
        assert client.status()["resyncs"] >= 1
        hub2.stop()
    finally:
        client.stop()
        storage.close()


def test_semisync_acks_wait_for_a_follower(tmp_path):
    storage = _leader(tmp_path)
    hub = ReplicationHub(storage)
    # semisync with nobody listening degrades to async instantly
    storage.attach_replicator(hub, semisync=True)
    srv = _server(storage=storage)
    _drive(srv, n=2)

    shadow = InMemoryStorage()
    client = ReplicationClient(shadow, ("127.0.0.1", hub.port)).start()
    try:
        assert client.wait_connected()
        assert _wait_for(_registered(hub))
        _drive(srv, n=4, name="synced")
        # every acked write has been acknowledged by the follower: the
        # write path waited, so there is no residual lag to wait out
        st = hub.status()
        assert any(f["acked"] >= st["pos"] for f in st["followers"])
        assert st["semisync_degraded"] == 0
    finally:
        client.stop()
        hub.stop()
        storage.close()


# --------------------------------------------------------------------- #
# corrupt-in-flight shipping is rejected, never adopted
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mangle", ["torn", "bitflip"])
def test_corrupt_shipped_payload_rejected_and_reshipped(tmp_path, mangle):
    storage = _leader(tmp_path)
    hub = ReplicationHub(storage)
    storage.attach_replicator(hub)
    srv = _server(storage=storage)
    _drive(srv, n=5)

    shadow = InMemoryStorage()
    client = ReplicationClient(shadow, ("127.0.0.1", hub.port)).start()
    try:
        assert client.wait_position(hub.position(), timeout=15.0)
        # corrupt the next shipped record frame in flight: the follower
        # must reject it (short read / checksum) and re-request — the
        # mangled bytes are never adopted into the shadow store
        faults.install({"torn_ship": {"mode": "nth", "n": 1,
                                      "arg": mangle}}, seed=7)
        _drive(srv, n=4, name="after-fault")
        assert client.wait_position(hub.position(), timeout=15.0)
        assert shadow.state_digest() == storage.state_digest()
        st = client.status()
        if mangle == "bitflip":
            # same length, wrong bytes: caught by checksum before replay
            assert st["rejects"] >= 1
        assert faults.injector().stats()["fired"].get("torn_ship") == 1
        assert hub.status()["pos"] == st["pos"]
    finally:
        client.stop()
        hub.stop()
        storage.close()


def test_partitioned_follower_catches_up_after_heal(tmp_path):
    storage = _leader(tmp_path)
    hub = ReplicationHub(storage)
    storage.attach_replicator(hub)
    srv = _server(storage=storage)
    _drive(srv, n=3)
    faults.install({"partition_follower": {"mode": "always"}}, seed=1)
    shadow = InMemoryStorage()
    client = ReplicationClient(shadow, ("127.0.0.1", hub.port),
                               retry_interval=0.01).start()
    try:
        # the partition holds across several reconnect attempts
        assert _wait_for(lambda: faults.injector().stats()["fired"].get(
            "partition_follower", 0) >= 3)
        assert not client.connected()
        assert client.position() == 0
        faults.install({})               # heal the partition
        assert client.wait_connected(timeout=10.0)
        assert client.wait_position(hub.position())
        assert shadow.state_digest() == storage.state_digest()
    finally:
        client.stop()
        hub.stop()
        storage.close()


# --------------------------------------------------------------------- #
# exactly-once tells (idempotency keys + dedup window)
# --------------------------------------------------------------------- #
def test_tell_idempotency_key_replays_original_result():
    srv = _server()
    cl = Client(DirectTransport(srv), srv.tokens.issue("t"))
    study = ClientStudy(name="idem", client=cl, properties=dict(_SPACE),
                        sampler={"name": "random"})
    t = study.ask()
    first = srv.op_tell(t.uid, 0.25, "completed", "key-1")
    again = srv.op_tell(t.uid, 999.0, "failed", "key-1")
    assert again == first                # replay, not a second finalize
    trial = srv.storage.get_trial(t.uid)
    assert trial.state.value == "completed" and trial.value == 0.25
    # a *different* key is a genuine duplicate finalize -> 409
    from repro_torch.core.api import ApiError
    with pytest.raises(ApiError) as e:
        srv.op_tell(t.uid, 1.0, "completed", "key-2")
    assert e.value.status == 409


def _config(name):
    from repro_torch.core.types import StudyConfig
    return StudyConfig(name=name, properties=dict(_SPACE),
                       sampler={"name": "random"})


def test_dedup_window_is_bounded_fifo():
    storage = InMemoryStorage()
    study, _created = storage.get_or_create_study(_config("fifo"))
    key = study.key
    for i in range(_DEDUP_WINDOW + 8):
        storage.note_idempotency(key, f"k{i}", {"i": i})
    assert storage.idempotent_result(key, "k0") is None      # evicted
    assert storage.idempotent_result(
        key, f"k{_DEDUP_WINDOW + 7}") == {"i": _DEDUP_WINDOW + 7}


def test_dedup_window_survives_recovery_and_replication(tmp_path):
    storage = _leader(tmp_path)
    hub = ReplicationHub(storage)
    storage.attach_replicator(hub)
    srv = _server(storage=storage)
    cl = Client(DirectTransport(srv), srv.tokens.issue("t"))
    study = ClientStudy(name="idem-d", client=cl, properties=dict(_SPACE),
                        sampler={"name": "random"})
    t = study.ask()
    first = srv.op_tell(t.uid, 0.5, "completed", "key-x")

    shadow = InMemoryStorage()
    client = ReplicationClient(shadow, ("127.0.0.1", hub.port)).start()
    try:
        assert client.wait_position(hub.position())
        # the follower replayed the idem record: a promoted leader gives
        # the same answer to the same retried tell
        assert shadow.idempotent_result(study.study_key, "key-x") == first
    finally:
        client.stop()
        hub.stop()
        storage.close()
    # and crash-recovery restores the window from the WAL
    recovered = DurableStorage(str(tmp_path / "leader"), fsync="off",
                               auto_compact=False)
    try:
        assert recovered.idempotent_result(study.study_key,
                                           "key-x") == first
    finally:
        recovered.close()


# --------------------------------------------------------------------- #
# health endpoint
# --------------------------------------------------------------------- #
def test_health_endpoint_reports_role_epoch_and_storage(tmp_path):
    storage = _leader(tmp_path, fsync="group")
    hub = ReplicationHub(storage)
    storage.attach_replicator(hub)
    srv = _server(storage=storage)
    _drive(srv, n=2)
    try:
        status, payload, _ = DirectTransport(srv).request_full(
            "GET", "/api/v2/health")          # unauthenticated by design
        assert status == 200
        assert payload["status"] == "ok" and payload["role"] == "leader"
        assert payload["epoch"] == 0
        assert payload["storage"]["backend"] == "durable"
        assert payload["storage"]["wal_records"] > 0
        assert payload["replication"]["pos"] == hub.position()
        # the port's addition: where this process's samplers compute
        assert payload["device"]["type"] == "cpu"
        assert payload["device"]["kernel_launches"]["tpe_score"] >= 0
    finally:
        hub.stop()
        storage.close()


# --------------------------------------------------------------------- #
# LOCK.meta names the holder (and calls out staleness)
# --------------------------------------------------------------------- #
def test_wal_lock_error_names_live_holder(tmp_path):
    from repro_torch.core import WalDirectoryLockedError
    root = str(tmp_path / "store")
    st = DurableStorage(root, fsync="off", auto_compact=False)
    try:
        with pytest.raises(WalDirectoryLockedError) as e:
            DurableStorage(root, fsync="off")
        msg = str(e.value)
        assert "locked by another live process" in msg
        assert f"holder meta: pid {os.getpid()}" in msg
        assert "(live)" in msg
    finally:
        st.close()
    assert not os.path.exists(os.path.join(root, "LOCK.meta"))


def test_stale_lock_meta_from_dead_pid_reported_as_stale(tmp_path):
    # burn a pid that is certainly dead now
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    meta = tmp_path / "LOCK.meta"
    meta.write_text(json.dumps({"pid": proc.pid, "host": "testhost",
                                "started_at": time.time()}))
    desc = _describe_lock_meta(str(meta))
    assert f"pid {proc.pid}" in desc and "on testhost" in desc
    assert "stale: meta pid is dead" in desc


# --------------------------------------------------------------------- #
# promotion helpers + fencing (in-process)
# --------------------------------------------------------------------- #
def test_recover_dir_state_is_readonly_and_reconcile_verifies(tmp_path):
    storage = _leader(tmp_path, fsync="always")
    srv = _server(storage=storage)
    _drive(srv, n=6)
    want = storage.state_digest()
    storage.close()

    before = sorted(os.listdir(tmp_path / "leader"))
    authority, meta = recover_dir_state(str(tmp_path / "leader"))
    assert authority.state_digest() == want
    assert meta["records_replayed"] > 0 and not meta["torn_tail"]
    assert sorted(os.listdir(tmp_path / "leader")) == before   # untouched

    follower = _leader(tmp_path, "f2")
    try:
        out = reconcile_with(follower, authority)
        assert out["digest_match"] and follower.state_digest() == want
        # idempotent: a caught-up store needs no drops or adopts
        again = reconcile_with(follower, authority)
        assert again == {"dropped": 0, "adopted": 0, "digest_match": True}
    finally:
        follower.close()


def test_fenced_worker_rejects_data_plane_but_answers_health():
    tokens = TokenManager("s")
    srv = _server(tokens=tokens)
    worker = FabricWorkerServer(srv, worker_id=3)
    srv.health_hook = worker.health_extra
    auth = {"Authorization": f"Bearer {tokens.issue('ctl')}"}
    status, out, _ = worker.handle_request("POST", "/fabric/fence",
                                           {"epoch": 2}, auth)
    assert status == 200 and out["fenced"]
    # stale fence (not newer than the current epoch) is refused
    status, out, _ = worker.handle_request("POST", "/fabric/fence",
                                           {"epoch": 0}, auth)
    assert status == 409 and out["error"]["code"] == "stale_epoch"
    # data plane: retryable 409 shard_failover
    status, out, hdrs = worker.handle_request(
        "POST", "/api/v2/studies", {"name": "x",
                                    "properties": dict(_SPACE)}, auth)
    assert status == 409 and out["error"]["code"] == "shard_failover"
    assert "Retry-After" in hdrs
    # health stays observable on a fenced worker
    status, health, _ = worker.handle_request("GET", "/api/v2/health")
    assert status == 200 and health["status"] == "fenced"
    assert health["epoch"] == 0


def test_clock_skewed_lease_expires_immediately():
    faults.install({"lease_skew": {"mode": "always",
                                   "arg": -3600.0}}, seed=0)
    srv = _server(lease_seconds=60.0)
    cl = Client(DirectTransport(srv), srv.tokens.issue("t"))
    study = ClientStudy(name="skew", client=cl, properties=dict(_SPACE),
                        sampler={"name": "random"})
    study.ask()
    # the skewed clock stamped a lease already in the past
    assert srv.sweep_expired() >= 1


def test_crash_before_fsync_loses_nothing_that_was_acked(tmp_path):
    """A worker that dies *inside* the fsync window must still recover
    every write it acknowledged before the crash (the injection point
    kills the process right before the fsync syscall; acked writes from
    earlier batches are already on stable storage or in the page
    cache)."""
    root = str(tmp_path / "crashy")
    prog = (
        "import repro_torch.core.faults as f\n"
        "f.load_from_env()\n"
        "from repro_torch.core import HopaasServer, DurableStorage\n"
        "srv = HopaasServer(storage=DurableStorage(%r, fsync='always',"
        " auto_compact=False), seed=0, device='cpu')\n"
        "cfg = {'name': 'c', 'properties': {'x': {'type': 'uniform',"
        " 'low': 0, 'high': 1}}, 'sampler': {'name': 'random'}}\n"
        "_created, res = srv.op_create_study(cfg)\n"
        "key = res['key']\n"
        "for i in range(50):\n"
        "    (t,) = srv.op_ask(key, 'w', 1)\n"
        "    srv.op_tell(t['uid'], float(i), 'completed')\n"
        "    print(t['uid'], flush=True)\n"
    ) % root
    env = dict(os.environ, REPRO_FAULTS=json.dumps(
        {"faults": {"crash_before_fsync": {"mode": "nth", "n": 40}}}))
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 137, proc.stderr   # died at the injection
    acked = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert acked                                  # made progress first
    store, meta = recover_dir_state(root)
    have = {t.uid for s in store.studies() for t in s.trials}
    assert set(acked) <= have, sorted(set(acked) - have)


# --------------------------------------------------------------------- #
# the wire format is shared with the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("direction", ["reference_hub_to_port_client",
                                       "port_hub_to_reference_client"])
def test_replication_crosses_packages(tmp_path, direction):
    from repro.core.durable import DurableStorage as RefDurable
    from repro.core.replication import ReplicationClient as RefClient
    from repro.core.replication import ReplicationHub as RefHub
    from repro.core.server import HopaasServer as RefServer
    from repro.core.storage import InMemoryStorage as RefMemory

    if direction == "reference_hub_to_port_client":
        storage = RefDurable(str(tmp_path / "leader"), fsync="off",
                             auto_compact=False)
        hub = RefHub(storage)
        srv = RefServer(storage=storage, seed=0)
        shadow = DurableStorage(str(tmp_path / "follower"), fsync="off",
                                auto_compact=False)
        client_cls = ReplicationClient
    else:
        storage = _leader(tmp_path)
        hub = ReplicationHub(storage)
        srv = _server(storage=storage)
        shadow = RefMemory()
        client_cls = RefClient
    storage.attach_replicator(hub)
    key, _ = _fill_mixed(srv, 5)                  # before the follower
    client = client_cls(shadow, ("127.0.0.1", hub.port)).start()
    try:
        assert client.wait_connected()
        assert client.wait_position(hub.position())   # the baseline
        assert shadow.state_digest() == storage.state_digest()
        _fill_mixed(srv, 4, name="live")          # streamed records
        assert client.wait_position(hub.position())
        assert shadow.state_digest() == storage.state_digest()
        assert client.status()["baselines"] == 1
        assert client.status()["records_applied"] > 0
    finally:
        client.stop()
        hub.stop()
        storage.close()
        if hasattr(shadow, "close"):
            shadow.close()


def _fill_mixed(srv, n, name="cross"):
    """Completed, pruned, failed and running trials, a report and an
    idempotent tell: every kind of WAL record the stream carries."""
    _, study = srv.op_create_study({
        "name": name, "properties": {"x": {"type": "uniform", "low": 0,
                                           "high": 1}},
        "sampler": {"name": "random"},
        "pruner": {"name": "median", "n_warmup_steps": 0}})
    key = study["key"]
    for i in range(n):
        (t,) = srv.op_ask(key, "w", 1)
        srv.op_report(t["uid"], 1, float(i))
        state = ("completed", "failed", "pruned")[i % 3]
        srv.op_tell(t["uid"], float(i), state, f"idem-{name}-{i}")
    srv.op_ask(key, "w", 1)                       # one left RUNNING
    return key, study


# --------------------------------------------------------------------- #
# every injection site sits on a live path
# --------------------------------------------------------------------- #
def test_every_injection_site_is_reached_by_normal_operation(tmp_path):
    """Disarmed injectors still count arrivals, so one end-to-end drive
    (durable server + replicated follower) proves each named site of the
    port sits on a live code path."""
    storage = DurableStorage(str(tmp_path / "leader"), fsync="always",
                             auto_compact=False)
    hub = ReplicationHub(storage)
    storage.attach_replicator(hub)
    srv = _server(storage=storage, lease_seconds=60.0)
    cl = Client(DirectTransport(srv), srv.tokens.issue("t"))
    study = ClientStudy(name="sites", client=cl, properties=dict(_SPACE),
                        sampler={"name": "random"})
    shadow = InMemoryStorage()
    client = ReplicationClient(shadow, ("127.0.0.1", hub.port)).start()
    try:
        t = study.ask()
        study.tell(t, value=abs(t.x))
        assert client.wait_position(hub.position(), timeout=15.0)
    finally:
        client.stop()
        hub.stop()
        storage.close()
    arrivals = faults.injector().stats()["arrivals"]
    for site in ("crash_before_fsync", "crash_after_fsync", "lease_skew",
                 "torn_ship", "partition_follower"):
        assert arrivals.get(site, 0) >= 1, (site, arrivals)


# --------------------------------------------------------------------- #
# chaos: the acceptance scenarios on the real fabric
# --------------------------------------------------------------------- #
def _fabric(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("spawn_timeout", 120.0)
    return ShardFabric(**kw)


def _fab_client(fab):
    tok = fab.issue_token("t")
    return Client(HttpTransport(fab.host, fab.port), tok,
                  retry=_PATIENT), tok


def _fab_study(cl, name):
    return ClientStudy(name=name, client=cl, properties=dict(_SPACE),
                       sampler={"name": "random"})


@pytest.mark.chaos
def test_kill_the_leader_mid_campaign_loses_no_acked_tell():
    """The acceptance drill: SIGKILL the owning leader while a threaded
    campaign asks/tells through the router.  The monitor must promote
    the most-caught-up follower with a digest matching the dead
    leader's WAL, no acked tell may vanish, no completion may double
    count, and the availability gap must stay under 5 s."""
    fab = _fabric(workers=2, replicas=1, replication="semisync",
                  fsync="always", respawn_poll=0.1,
                  lease_seconds=5.0).start()
    try:
        cl, _tok = _fab_client(fab)
        study = _fab_study(cl, "killdrill")
        key = study._ensure_key()
        wid = fab.owner_of(key)

        stop = threading.Event()
        told: list[str] = []
        done_at: list[float] = []
        errors: list[str] = []
        lock = threading.Lock()

        def campaign():
            local = _fab_study(_fab_client(fab)[0], "killdrill")
            while not stop.is_set():
                try:
                    t = local.ask()
                    local.tell(t, value=abs(t.x))
                    with lock:
                        told.append(t.uid)
                        done_at.append(time.monotonic())
                except Exception as e:            # pragma: no cover
                    errors.append(repr(e))
                    return

        threads = [threading.Thread(target=campaign) for _ in range(3)]
        for th in threads:
            th.start()
        # the campaign in full flight
        assert _wait_for(lambda: len(told) >= 10 or errors)
        old_pid = fab._workers[wid].pid
        killed_at = time.monotonic()
        fab.kill_worker(wid, sig=signal.SIGKILL)
        fab.wait_respawn(wid, old_pid, timeout=120)
        # keep telling past the failover
        assert _wait_for(lambda: errors or sum(
            t > killed_at for t in list(done_at)) >= 10, timeout=60.0)
        stop.set()
        for th in threads:
            th.join(timeout=30)
        assert not errors, errors

        event = [e for e in fab.events if e["event"] == "failover"][-1]
        assert event["worker"] == wid and event["epoch"] >= 1
        # promoted state matches the dead leader's WAL exactly
        assert event["digest_match"] is True
        assert fab.failovers >= 1

        # bounded unavailability: the first acked tell after the kill
        # landed within the 5 s budget
        after = [t for t in done_at if t > killed_at]
        assert after, "campaign never recovered after the kill"
        assert min(after) - killed_at < 5.0

        # zero lost acked tells, zero double counts
        completed = {t["uid"] for t in cl.iter_trials(key,
                                                      state="completed")}
        assert set(told) <= completed
        assert len(told) == len(set(told))
        assert cl.study(key)["n_completed"] == len(completed)
    finally:
        fab.stop()


@pytest.mark.chaos
def test_deposed_leader_is_fenced_on_return():
    """SIGSTOP wedges the leader (hung, not dead): the monitor promotes
    a follower, and when the old leader resumes it gets fenced — its
    data plane answers a retryable 409 with the stale epoch, so it can
    never ack a write the promoted leader doesn't have."""
    fab = _fabric(workers=2, replicas=1, replication="semisync",
                  fsync="always", respawn_poll=0.1,
                  hang_grace=0.8).start()
    try:
        cl, tok = _fab_client(fab)
        study = _fab_study(cl, "fence")
        key = study._ensure_key()
        wid = fab.owner_of(key)
        for _ in range(5):
            t = study.ask()
            study.tell(t, value=abs(t.x))

        old = fab._workers[wid]
        old_pid, old_port = old.pid, old.port
        fab.kill_worker(wid, sig=signal.SIGSTOP)
        wp = fab.wait_respawn(wid, old_pid, timeout=120)
        assert wp.pid != old_pid
        # service continues through the promoted follower
        t = study.ask()
        study.tell(t, value=abs(t.x))

        os.kill(old_pid, signal.SIGCONT)
        assert _wait_for(lambda: any(e["event"] == "fence"
                                     for e in fab.events), timeout=30.0)
        fence = [e for e in fab.events if e["event"] == "fence"]
        assert fence and fence[-1]["epoch"] >= 1

        # a client still pointed at the deposed leader gets the
        # retryable failover signal, never a stale ack
        raw = HttpTransport(fab.host, old_port, timeout=5.0)
        status, payload, _ = raw.request_full(
            "POST", f"/api/v2/studies/{key}/trials:ask",
            {"worker_id": "t"},
            headers={"Authorization": f"Bearer {tok}"})
        assert status == 409
        assert payload["error"]["code"] == "shard_failover"
        assert "fenced by epoch" in payload["error"]["message"]

        # fleet health shows exactly one leader for this wid, new epoch
        entries = [w for w in fab.health()["workers"]
                   if w["worker"] == wid and "error" not in w]
        roles = [w["role"] for w in entries]
        assert roles.count("leader") == 1
        assert max(w["epoch"] for w in entries) >= 1
    finally:
        fab.stop()


@pytest.mark.chaos
def test_fabric_health_reports_followers_and_lag():
    fab = _fabric(workers=2, replicas=1, fsync="off",
                  respawn_poll=0.2).start()
    try:
        cl, _tok = _fab_client(fab)
        study = _fab_study(cl, "lag")
        study._ensure_key()
        for _ in range(4):
            t = study.ask()
            study.tell(t, value=abs(t.x))
        health = fab.health()
        assert health["replicas"] == 1
        roles = [w.get("role") for w in health["workers"]]
        assert roles.count("leader") == 2 and roles.count("follower") == 2
        # per-worker health through the data plane answers from any role
        follower = next(w for w in health["workers"]
                        if w.get("role") == "follower")
        host, port = follower["endpoint"]
        status, payload, _ = HttpTransport(host, port).request_full(
            "GET", "/api/v2/health")
        assert status == 200 and payload["status"] == "follower"
        assert payload["replication"]["client"]["connected"] is True
    finally:
        fab.stop()


@pytest.mark.chaos
def test_cold_start_adopts_highest_epoch_replica_root(tmp_path):
    """After an in-flight failover (follower promoted, epoch bumped,
    writes landing in ``worker-N-replica-M/``), a full-fleet SIGKILL +
    restart on the same journal root must boot the shard from the
    highest journaled epoch — every acked post-failover tell is served
    by the reborn fleet, digest-verified, not silently dropped by an
    epoch-0 boot from ``worker-N/``."""
    root = str(tmp_path)
    fab = _fabric(workers=2, replicas=1, replication="semisync",
                  fsync="always", respawn_poll=0.1, root=root).start()
    told: list[str] = []
    try:
        cl, _tok = _fab_client(fab)
        study = _fab_study(cl, "coldstart")
        key = study._ensure_key()
        wid = fab.owner_of(key)
        for _ in range(4):
            t = study.ask()
            study.tell(t, value=abs(t.x))
            told.append(t.uid)

        # in-flight failover: the follower takes over at a bumped epoch
        old_pid = fab._workers[wid].pid
        fab.kill_worker(wid, sig=signal.SIGKILL)
        fab.wait_respawn(wid, old_pid, timeout=120)
        assert any(e["event"] == "failover" for e in fab.events)
        promoted_epoch = fab._workers[wid].epoch
        assert promoted_epoch >= 1
        # acked post-failover tells: these land in a replica-M root
        for _ in range(4):
            t = study.ask()
            study.tell(t, value=abs(t.x))
            told.append(t.uid)
    finally:
        # full-fleet kill: no graceful drain, the page cache + fsynced
        # WALs are all that survives
        fab._stop_event.set()
        if fab._monitor is not None:
            fab._monitor.join(timeout=10.0)
        with fab._fleet_lock:
            procs = [wp.proc for wp in fab._workers.values()]
            procs += [fp.proc for fols in fab._followers.values()
                      for fp in fols]
            procs += [wp.proc for wp in fab._deposed]
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        fab.stop()

    fab2 = _fabric(workers=2, replicas=1, replication="semisync",
                   fsync="always", respawn_poll=0.1, root=root).start()
    try:
        adopts = [e for e in fab2.events if e["event"] == "cold_start_adopt"]
        assert adopts, "cold start ignored the higher-epoch replica root"
        event = next(e for e in adopts if e["worker"] == wid)
        assert event["epoch"] > promoted_epoch
        assert event["digest_match"] is True
        assert fab2._workers[wid].epoch == event["epoch"]

        # every acked tell — before and after the in-flight failover —
        # is served by the reborn fleet
        cl2, _tok2 = _fab_client(fab2)
        completed = {t["uid"] for t in cl2.iter_trials(key,
                                                       state="completed")}
        assert set(told) <= completed
        assert cl2.study(key)["n_completed"] == len(completed)

        # the fleet keeps working at the adopted epoch (new followers
        # get fresh replica roots, no collision with the adopted one)
        study2 = _fab_study(cl2, "coldstart")
        t = study2.ask()
        study2.tell(t, value=abs(t.x))
    finally:
        fab2.stop()
