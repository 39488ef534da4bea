"""The port's gang launcher and its workers' protocol
(``xgboost_tpu_torch/parallel/launch.py``, ``gang.py``, ``mock.py``) on
the CPU, against the JAX package's functions and its
``tests/test_launch.py`` cases.

Pure parts are held equal to the JAX package's on the same inputs:
``plan_degrade``, ``PartitionClock`` on a mock clock, the coordinator
state file (round trip, CRC corruption, each package reading the
other's), ``FaultInjector``.  The launcher's state machine runs on
workers that only beat their heartbeat through the port's
``mock.begin_round`` (the JAX ``_GANG_SCRIPT`` pattern) or that only
sleep; the launches that take several attempts are started at once, in
a module fixture, each with its own ``--metrics-file``, and read
afterwards.  Watchdog, lease and partition windows are a few seconds.
"""

import os
import re
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from xgboost_tpu.parallel import gang as jgang  # noqa: E402
from xgboost_tpu.parallel import launch as jlaunch  # noqa: E402
from xgboost_tpu.parallel import mock as jmock  # noqa: E402
from xgboost_tpu_torch.parallel import gang as tgang  # noqa: E402
from xgboost_tpu_torch.parallel import launch  # noqa: E402
from xgboost_tpu_torch.parallel import mock as tmock  # noqa: E402
from xgboost_tpu_torch.reliability.rc import (COORD_FENCED_RC,  # noqa: E402
                                              STALL_RC)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a worker of the real gang protocol: each round boundary is the port's
# mock.begin_round (gang hook, heartbeat), then a done marker
GANG_SCRIPT = """\
import os, sys, time
sys.path.insert(0, {repo!r})
from xgboost_tpu_torch.parallel import gang, mock
for v in range({rounds}):
    mock.begin_round(v)
    time.sleep({sleep})
gang.mark_done()
"""

# beats once, then hangs on trial 0 and exits clean on any later trial
STALL_SCRIPT = """\
import os, sys, time
hb = os.environ.get("XGBTPU_HEARTBEAT_DIR")
if hb:
    with open(os.path.join(hb, "hb-" + os.environ["XGBTPU_WORKER_ID"]),
              "w") as f:
        f.write("0")
if int(os.environ.get("XGBTPU_NUM_TRIAL", "0")) == 0:
    time.sleep(600)
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    for k in (launch.COORD_ENV, launch.RANK_ENV, launch.NWORKER_ENV,
              "XGBTPU_FAULTS", "XGBTPU_HEARTBEAT_DIR", tgang.GANG_DIR_ENV):
        if k not in extra:
            env.pop(k, None)
    return env


def read_prom(path):
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                name, _, value = line.rpartition(" ")
                out[name] = float(value)
    return out


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The multi-attempt launches, started at once: {name: (rc, stderr,
    metrics, dir)}."""
    root = tmp_path_factory.mktemp("gang")
    gang_worker = root / "gang_worker.py"
    gang_worker.write_text(GANG_SCRIPT.format(repo=REPO, rounds=12,
                                              sleep=0.3))
    staller = root / "staller.py"
    staller.write_text(STALL_SCRIPT)
    flaky = root / "flaky.py"
    flaky.write_text("import os, sys\n"
                     "if os.environ['XGBTPU_NUM_TRIAL'] == '0':\n"
                     "    sys.exit(3)\n")
    py = sys.executable
    plan = {
        # host loss on rank 0 at round 1, then degrade, then grow-back
        "hostloss": (["-n", "2", "--keepalive", "--standalone",
                      "--degrade-after", "3", "--restart-backoff-sec",
                      "0.05"], [py, str(gang_worker)],
                     {"XGBTPU_FAULTS": "host_loss@t0.r0.v1."}),
        # a 30 s partition window at round 1, fencing after 2 s
        "fence": (["-n", "1", "--keepalive", "--standalone",
                   "--gang-partition-sec", "2", "--restart-backoff-sec",
                   "0.05"], [py, str(gang_worker)],
                  {"XGBTPU_FAULTS": "partition=30.0@t0.r0.v1."}),
        "stall": (["-n", "2", "--keepalive", "--standalone",
                   "--watchdog-stall-sec", "1.5", "--restart-backoff-sec",
                   "0.05"], [py, str(staller)], {}),
        "stall_rc": (["-n", "1", "--standalone", "--watchdog-stall-sec",
                      "1.5"], [py, str(staller)], {}),
        "flaky": (["-n", "2", "--keepalive", "--restart-backoff-sec",
                   "0.05"], [py, str(flaky)], {}),
    }
    procs, dirs = {}, {}
    for name, (flags, cmd, extra) in plan.items():
        d = dirs[name] = root / name
        d.mkdir()
        if name == "hostloss":
            flags = flags + ["--gang-dir", str(d / "g")]
        procs[name] = subprocess.Popen(
            [py, "-m", "xgboost_tpu_torch.parallel.launch", *flags,
             "--timeout-sec", "240", "--metrics-file", str(d / "m.prom"),
             "--", *cmd], cwd=str(d), env=_env(**extra),
            stderr=subprocess.PIPE, text=True)

    # a replacement registers once the host-loss gang runs degraded
    stop = threading.Event()

    def grow_when_degraded():
        state = dirs["hostloss"] / "g" / "coord-state.json"
        while not stop.is_set():
            try:
                if b'"degraded": true' in state.read_bytes():
                    (dirs["hostloss"] / "g" / "grow").touch()
                    return
            except OSError:
                pass
            time.sleep(0.05)
    t = threading.Thread(target=grow_when_degraded, daemon=True)
    t.start()
    out = {}
    for name, p in procs.items():
        _, err = p.communicate(timeout=300)
        out[name] = (p.returncode, err, read_prom(dirs[name] / "m.prom"),
                     dirs[name])
    stop.set()
    t.join(timeout=5)
    return out


def test_host_loss_degrades_and_grow_back_restores(launches):
    """A permanent host loss (``HOST_LOSS_RC`` and a tombstone) re-plans
    the gang one rank smaller at once; while degraded, a ``grow`` file
    re-expands it to full size, and the last attempt runs at W = 2."""
    rc, err, m, _ = launches["hostloss"]
    assert rc == 0, err[-3000:]
    assert m['xgbtpu_launch_restarts_total{reason="host_loss"}'] == 1
    assert m['xgbtpu_launch_restarts_total{reason="growback"}'] == 1
    assert m["xgbtpu_launch_growbacks_total"] == 1
    assert m["xgbtpu_launch_mesh_size"] == 2
    assert m["xgbtpu_launch_degraded"] == 0
    assert "[gang] HOST LOSS" in err
    assert "[launch] DEGRADE: re-planning 2x1 -> 1x1 (host loss" in err
    assert "[launch] GROW-BACK" in err


def test_partition_window_self_fences_and_restarts(launches):
    """A worker that cannot see the coordinator's beacon past
    ``--gang-partition-sec`` self-fences (``FENCE_RC``); keepalive
    restarts the gang with reason ``fence``."""
    rc, err, m, _ = launches["fence"]
    assert rc == 0, err[-3000:]
    assert m['xgbtpu_launch_restarts_total{reason="fence"}'] == 1
    assert "[gang] partition window 30.0s open" in err
    assert "[gang] FENCED" in err
    assert "died (rc=143, trial 0)" in err
    assert "reason fence" in err


def test_watchdog_kills_and_restarts_a_stalled_gang(launches):
    rc, err, m, _ = launches["stall"]
    assert rc == 0, err[-3000:]
    assert m['xgbtpu_launch_restarts_total{reason="stall"}'] == 1
    assert "[launch] STALL" in err
    assert "restarting all 2 workers, trial 1 (reason stall" in err


def test_watchdog_without_keepalive_returns_stall_rc(launches):
    rc, err, _, _ = launches["stall_rc"]
    assert rc == STALL_RC
    assert "[launch] STALL" in err


def test_keepalive_restarts_a_dead_gang(launches):
    rc, err, m, _ = launches["flaky"]
    assert rc == 0, err[-3000:]
    assert m['xgbtpu_launch_restarts_total{reason="death"}'] == 1
    assert m["xgbtpu_launch_worker_deaths_total"] == 1
    assert re.search(r"worker [01] died \(rc=3, trial 0\)", err)


def test_a_rank_ends_with_its_process_group(tmp_path):
    """A rank's own child goes with it when the launcher ends the gang:
    each rank runs in a session of its own and is ended by its group."""
    code = ("import subprocess, sys, time\n"
            "c = subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(120)'])\n"
            "open('child', 'w').write(str(c.pid))\n"
            "time.sleep(120)\n")
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = launch.launch_local(1, [sys.executable, "-c", code],
                                 standalone=True, timeout_sec=3)
    finally:
        os.chdir(old)
    assert rc == 124
    pid = int((tmp_path / "child").read_text())
    deadline = time.monotonic() + 10
    while launch._pid_alive(pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not launch._pid_alive(pid)


def test_coordinator_restart_adopts_a_live_gang(tmp_path, capfd):
    """A coordinator restarted on a previous holder's snapshot whose
    ranks all live adopts them (no respawn), reads their clean exits
    from done markers and removes the snapshot."""
    gang_dir = tmp_path / "gang"
    gang_dir.mkdir()
    state = str(gang_dir / "coord-state.json")
    sentinel = tmp_path / "respawned"
    # the orphan must not be our child (a zombie still answers kill 0)
    spawner = subprocess.run(
        [sys.executable, "-c",
         "import subprocess, sys\n"
         "p = subprocess.Popen([sys.executable, '-c', "
         "\"import os, sys, time; time.sleep(1.2); \"\n"
         "    \"open(os.path.join(sys.argv[1], 'done-0'), 'w')"
         ".write('done')\", sys.argv[1]])\n"
         "print(p.pid)\n", str(gang_dir)],
        capture_output=True, text=True, timeout=30)
    pid = int(spawner.stdout.strip())
    try:
        launch._write_state(state, {
            "full_n": 1, "cur_n": 1, "cur_devices": None,
            "degraded": False, "trial": 2, "hb_dir": None,
            "gang_dir": str(gang_dir),
            "workers": [{"rank": 0, "pid": pid}]}, "pid-dead")
        rc = launch.launch_local(
            1, [sys.executable, "-c",
                f"open({str(sentinel)!r}, 'w').write('x')"],
            standalone=True, gang_dir=str(gang_dir), state_path=state)
    finally:
        try:
            os.kill(pid, 9)
        except OSError:
            pass
    assert rc == 0
    assert not sentinel.exists(), "adoption must not respawn the gang"
    assert not os.path.exists(state), "success removes the snapshot"
    assert "[launch] re-adopting live gang" in capfd.readouterr().err


def test_superseded_coordinator_exits_without_reaping(tmp_path, capfd):
    """A coordinator that sees the state file's holder change exits
    ``COORD_FENCED_RC`` and leaves the ranks to the new holder."""
    gang_dir = tmp_path / "gang"
    gang_dir.mkdir()
    state = str(gang_dir / "coord-state.json")
    out = {}

    def run():
        out["rc"] = launch.launch_local(
            1, [sys.executable, "-c", "import time; time.sleep(60)"],
            standalone=True, gang_dir=str(gang_dir), state_path=state)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 20
    st = None
    while time.monotonic() < deadline:
        st = launch._read_state(state)
        if st and st.get("workers"):
            break
        time.sleep(0.05)
    assert st and st.get("workers"), "launcher never snapshotted"
    pid = int(st["workers"][0]["pid"])
    launch._write_state(state, st, "intruder")
    t.join(timeout=20)
    assert not t.is_alive()
    try:
        assert out["rc"] == COORD_FENCED_RC
        assert launch._pid_alive(pid), "the new holder's rank was reaped"
    finally:
        launch._signal_group(pid, 9)
    assert "[launch] coordinator fenced" in capfd.readouterr().err


def test_standby_takes_over_a_dead_primarys_gang(tmp_path, capfd):
    """``--standby`` waits while the primary renews its lease, then takes
    the gang over: the primary's snapshot with a live rank is adopted,
    and its done marker ends the launch at 0."""
    gang_dir = tmp_path / "gang"
    gang_dir.mkdir()
    state = str(gang_dir / "coord-state.json")
    rank = subprocess.Popen(
        [sys.executable, "-c",
         "import os, sys, time; time.sleep(2.5); "
         "open(os.path.join(sys.argv[1], 'done-0'), 'w').write('d')",
         str(gang_dir)])
    launch._write_state(state, {
        "full_n": 1, "cur_n": 1, "cur_devices": None, "degraded": False,
        "trial": 0, "hb_dir": None, "gang_dir": str(gang_dir),
        "workers": [{"rank": 0, "pid": rank.pid}]}, "primary")

    def renew():   # the primary's lease for ~1 s, then it dies
        for _ in range(5):
            os.utime(state, None)
            time.sleep(0.2)
    t = threading.Thread(target=renew, daemon=True)
    t.start()
    t0 = time.monotonic()
    threading.Thread(target=rank.wait, daemon=True).start()  # no zombie
    rc = launch.launch_local(1, [sys.executable, "-c", "raise SystemExit(7)"],
                             standalone=True, gang_dir=str(gang_dir),
                             state_path=state, standby=True,
                             coord_lease_sec=0.6)
    t.join()
    assert rc == 0
    assert time.monotonic() - t0 > 1.0
    err = capfd.readouterr().err
    assert "standby takeover" in err and "re-adopting live gang" in err


def test_stale_lease_wait_blocks_until_renewals_stop(tmp_path):
    state = tmp_path / "coord-state.json"
    state.write_text("{}")

    def renew():
        for _ in range(8):
            os.utime(state, None)
            time.sleep(0.15)
    t = threading.Thread(target=renew, daemon=True)
    t0 = time.monotonic()
    t.start()
    launch._wait_for_stale_lease(str(state), 0.6, poll=0.05)
    elapsed = time.monotonic() - t0
    t.join()
    assert 1.2 < elapsed < 8.0


# ------------------------------------------------- parity, pure parts
@pytest.mark.parametrize("n,dev,mn", [(4, 4, 1), (4, 2, 1), (4, 1, 1),
                                      (2, None, 1), (1, None, 1),
                                      (1, 1, 1), (2, None, 2), (5, None, 3),
                                      (3, 8, 2)])
def test_plan_degrade_equals_jax(n, dev, mn):
    assert launch.plan_degrade(n, dev, mn) == jlaunch.plan_degrade(n, dev,
                                                                   mn)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("partition_sec", [0.0, 1.0, 2.5])
def test_partition_clock_equals_jax(partition_sec):
    """The same beacon and window schedule on a mock clock gives the
    same states in both packages."""
    script = [("obs", 1.0), ("tick", 0.5), ("obs", 1.0), ("win", 3.0),
              ("tick", 0.4), ("obs", 2.0), ("tick", 0.7), ("obs", 3.0),
              ("tick", 2.0), ("obs", 3.0), ("tick", 0.5), ("obs", 4.0),
              ("tick", 1.2), ("obs", None), ("tick", 1.5), ("obs", None),
              ("obs", 5.0)]
    out = []
    for mod in (tgang, jgang):
        clock = _Clock()
        pc = mod.PartitionClock(partition_sec, monotonic=clock)
        states = []
        for op, arg in script:
            if op == "tick":
                clock.t += arg
            elif op == "win":
                pc.open_window(arg)
            else:
                states.append((pc.observe(arg), pc.window_open()))
        out.append(states)
    assert out[0] == out[1]
    assert ("fence", False) in out[0] or partition_sec == 0


def test_state_file_round_trip_corruption_and_cross_reads(tmp_path,
                                                          capfd):
    """The coordinator snapshot carries the ring's CRC footer: a round
    trip restores it, each package reads the other's, and a flipped byte
    makes it unusable (a fresh start)."""
    st = {"full_n": 2, "cur_n": 1, "cur_devices": None, "degraded": True,
          "trial": 3, "hb_dir": None, "gang_dir": str(tmp_path),
          "workers": [{"rank": 0, "pid": 12345}]}
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    launch._write_state(a, st, "pid777")
    jlaunch._write_state(b, st, "pid777")
    assert open(a, "rb").read() == open(b, "rb").read()
    assert launch._read_state(b) == jlaunch._read_state(a) == dict(
        st, holder="pid777")
    raw = bytearray(open(a, "rb").read())
    raw[10] ^= 0x20
    open(a, "wb").write(bytes(raw))
    capfd.readouterr()
    assert launch._read_state(a) is None
    assert "unusable" in capfd.readouterr().err


@pytest.mark.parametrize("spec,trial", [
    ([(2, 1, 0)], 0), ([(2, 1, 0)], 1), ([(0, 0, 0), (3, 2, 0)], 0),
    ([(1, 0, 0, "stall"), (1, 1, 0)], 0), ([(4, 5, 1)], 1)])
def test_fault_injector_equals_jax(spec, trial, monkeypatch):
    """The same spec fires at the same (version, seqno) in both
    packages; a stall is reported without sleeping here."""
    monkeypatch.setattr(time, "sleep", lambda s: None)

    def fired(mod):
        inj = mod.FaultInjector(spec, trial, stall_sec=0.0)
        hits = []
        for v in range(6):
            inj.begin_round(v)
            for s in range(6):
                try:
                    inj.collective()
                except mod.WorkerFailure as e:
                    hits.append((v, s, str(e)))
        return hits
    assert fired(tmock) == fired(jmock)
    with pytest.raises(ValueError, match="unknown mock fault kind"):
        tmock.FaultInjector([(1, 2, 3, "explode")])


def test_heartbeat_gang_hook_and_done_marker(tmp_path, monkeypatch):
    """``mock.begin_round``: the heartbeat under XGBTPU_HEARTBEAT_DIR,
    a host-loss tombstone in the gang dir with the exit code
    ``HOST_LOSS_RC``, and ``mark_done``'s marker."""
    from xgboost_tpu_torch.reliability import faults
    from xgboost_tpu_torch.reliability.rc import HOST_LOSS_RC
    tgang._reset()
    monkeypatch.setenv("XGBTPU_HEARTBEAT_DIR", str(tmp_path))
    monkeypatch.setenv(tgang.GANG_DIR_ENV, str(tmp_path))
    monkeypatch.setenv("XGBTPU_WORKER_ID", "3")
    monkeypatch.setenv("XGBTPU_NUM_TRIAL", "1")
    monkeypatch.delenv(tgang.PARTITION_SEC_ENV, raising=False)
    tmock.begin_round(4)
    assert (tmp_path / "hb-3").read_text() == "4"
    tgang.mark_done()
    assert (tmp_path / "done-3").exists()
    died = []
    monkeypatch.setattr(tgang, "_die", lambda rc: died.append(rc))
    faults.inject("host_loss", path_sub="t1.r3.v5.")
    try:
        tmock.begin_round(5)
    finally:
        faults.clear_faults()
    assert died == [HOST_LOSS_RC]
    assert tgang.live_tombstones(str(tmp_path)) == ["3"]
