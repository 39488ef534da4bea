"""Rank rendezvous and the local gang launcher (port of
``xgboost_tpu/parallel/launch.py``; the reference's tracker and
``rabit_demo.py``).

Local usage, N ranks on one host::

    python -m xgboost_tpu_torch.parallel.launch -n 4 [--keepalive] \\
        python -m xgboost_tpu_torch train.conf

(``python -m xgboost_tpu_torch.launch`` is the same command.)  Cluster
usage: run the same worker command on every host with ``XGBTPU_COORD``
(host:port of rank 0), ``XGBTPU_NUM_WORKER`` and ``XGBTPU_WORKER_ID``
exported, or under a scheduler whose own rank variables
:func:`~xgboost_tpu_torch.parallel.submit.scheduler_rank` reads
(``parallel/submit.py`` writes the mpirun, qsub and srun lines);
:func:`init_worker` calls ``torch.distributed.init_process_group(
init_method="tcp://COORD")``.

The backend is read from what the process can observe: NCCL when the
rank runs on a GPU and every rank on its host has a card of its own
(``XGBTPU_LOCAL_WORKERS`` ranks on the host, the world by default),
gloo otherwise, on the CPU and for several ranks on one card (NCCL
refuses two ranks on one card).  Nothing tries one and falls back to
the other.  A rank binds ``cuda:(local_rank % device_count)``, its local
rank ``XGBTPU_LOCAL_RANK`` (the rank by default).

The launcher supervises the gang (:func:`launch_local`): keepalive
restarts of the whole gang from the checkpoint ring, the heartbeat stall
watchdog, degrade to a smaller world and grow-back, coordinator state
with re-adoption of a live gang, a warm standby coordinator and, on the
workers' side (``parallel/gang.py``), partition fencing.  Each rank runs
in a session of its own and is ended by its process group, so that a
rank blocked in a collective, or one stalled with its CUDA context open,
goes with everything it started.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from xgboost_tpu_torch.reliability.rc import (COORD_FENCED_RC,  # noqa: F401
                                              STALL_RC)

COORD_ENV = "XGBTPU_COORD"
NWORKER_ENV = "XGBTPU_NUM_WORKER"
RANK_ENV = "XGBTPU_WORKER_ID"
TRIAL_ENV = "XGBTPU_NUM_TRIAL"
LOCAL_RANK_ENV = "XGBTPU_LOCAL_RANK"
LOCAL_WORKERS_ENV = "XGBTPU_LOCAL_WORKERS"

#: the grow-back signal in the gang dir: a replacement worker (or the
#: operator) touches it to ask a degraded gang to re-expand to full size
#: at the next segment boundary
GROW_SIGNAL = "grow"
#: the supervisor's tick: rank exits, heartbeats, the beacon and the
#: lease are looked at this often
_POLL_SEC = 0.2


def _local_rank() -> int:
    return int(os.environ.get(LOCAL_RANK_ENV, os.environ.get(RANK_ENV, 0)))


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked, else
    ``cuda:(local_rank % device_count)``."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU is available; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def pick_backend(device: torch.device) -> str:
    """``"nccl"`` when this rank is on a card and every rank of its host
    has a card of its own, else ``"gloo"``."""
    if device.type != "cuda":
        return "gloo"
    import torch.distributed as dist
    local = int(os.environ.get(LOCAL_WORKERS_ENV,
                               os.environ.get(NWORKER_ENV, 1)))
    if dist.is_nccl_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def init_worker(device=None) -> bool:
    """Join the world named by the launcher's (or a scheduler's)
    environment; True when distributed mode is on (``XGBTPU_COORD``
    set).  Call before any device use: it binds the rank's card as the
    current CUDA device and installs the world (``set_mesh``).
    ``device="cpu"`` keeps the rank on the CPU (gloo)."""
    coord = os.environ.get(COORD_ENV)
    if not coord:
        return False
    if RANK_ENV in os.environ:
        n = int(os.environ[NWORKER_ENV])
        rank = int(os.environ[RANK_ENV])
    else:
        # a scheduler's worker (mpirun, srun, qsub; parallel/submit.py):
        # rank and world from the scheduler's variables
        from xgboost_tpu_torch.parallel.submit import scheduler_rank
        rw = scheduler_rank()
        if rw is None:
            raise RuntimeError(
                f"{COORD_ENV} is set but no rank source found: export "
                f"{RANK_ENV}/{NWORKER_ENV} or launch under a scheduler "
                "(OpenMPI/PMI/Slurm/SGE)")
        rank, sched_n = rw
        n = int(os.environ.get(NWORKER_ENV, sched_n))
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = pick_backend(dev)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coord}", world_size=n,
        rank=rank, **kw)
    from xgboost_tpu_torch.parallel.mesh import data_parallel_mesh, set_mesh
    set_mesh(data_parallel_mesh())
    return True


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _signal_group(pid: int, sig: int) -> None:
    """``sig`` to the process group an adopted worker ``pid`` leads, or
    to ``pid`` alone when it leads none (started by someone else)."""
    try:
        if os.getpgid(pid) == pid:
            os.killpg(pid, sig)
        else:
            os.kill(pid, sig)
    except OSError:
        pass  # gone between the check and the signal


def _kill_group(pgid: int, sig: int) -> None:
    """``sig`` to the process group of a rank this launcher started (in
    a session of its own, so its pid is its group's id; the kernel
    reuses no pid while its group lives)."""
    try:
        os.killpg(pgid, sig)
    except OSError:
        pass  # the group has ended


def _reap(procs: List[Optional[subprocess.Popen]],
          grace: float = 3.0) -> None:
    """SIGTERM every rank's process group, SIGKILL what is left after
    ``grace`` seconds, and wait for every rank.  A survivor blocked in
    a collective of a doomed gang may not end on SIGTERM; it is about to
    be replaced from the checkpoint ring anyway."""
    procs = [q for q in procs if q is not None]
    for q in procs:
        _kill_group(q.pid, signal.SIGTERM)
    deadline = time.monotonic() + grace
    for q in procs:
        try:
            q.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for q in procs:
        # the group too: a rank's own children outlive it otherwise
        _kill_group(q.pid, signal.SIGKILL)
        q.wait()


def _latest_heartbeat(hb_dir: str) -> Optional[float]:
    """The newest ``hb-*`` mtime of the attempt's ranks (comparable only
    with other mtimes of the same file system), None before any."""
    latest = None
    try:
        names = os.listdir(hb_dir)
    except OSError:
        return None
    for name in names:
        if not name.startswith("hb-"):
            continue
        try:
            m = os.stat(os.path.join(hb_dir, name)).st_mtime
        except OSError:
            continue  # racing a rewrite; the next poll sees it
        if latest is None or m > latest:
            latest = m
    return latest


def plan_degrade(n: int, local_devices: Optional[int],
                 min_workers: int = 1
                 ) -> Optional[Tuple[int, Optional[int]]]:
    """The largest viable smaller gang, or None when already minimal:
    device counts halve first, then workers step down by one, never
    below ``min_workers``.  The port's ranks hold one device each, so
    its launcher passes ``local_devices=None``."""
    if local_devices is not None and local_devices > 1:
        return n, local_devices // 2
    if n > max(1, min_workers):
        return n - 1, local_devices
    return None


def _write_state(state_path: str, state: dict, holder: str) -> None:
    """Snapshot the coordinator's state (roster, trial, plan) atomically
    with the CRC footer of a ring member: a restarted coordinator that
    re-adopted workers off a torn snapshot would be its own split
    brain."""
    from xgboost_tpu_torch.reliability.integrity import (add_footer,
                                                         atomic_write)
    payload = json.dumps(dict(state, holder=holder),
                         sort_keys=True).encode()
    atomic_write(state_path, add_footer(payload))


def _read_state(state_path: str) -> Optional[dict]:
    """A verified coordinator snapshot, or None when it is missing or
    unusable (a corrupt snapshot means a fresh start, not a crash)."""
    from xgboost_tpu_torch.reliability.integrity import (read_file,
                                                         verify_model_bytes)
    try:
        raw = read_file(state_path)
    except OSError:
        return None
    try:
        payload = verify_model_bytes(raw, name=state_path, warn=False)
        return json.loads(payload.decode())
    except ValueError as e:
        from xgboost_tpu_torch.obs import event
        event("launch.state_corrupt", path=state_path, error=str(e))
        print(f"[launch] coordinator state {state_path} unusable "
              f"({e}); starting fresh", file=sys.stderr)
        return None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # alive, not ours to signal


def _reap_pids(pids: List[int], grace: float = 3.0) -> None:
    """:func:`_reap` for adopted workers, which this coordinator did not
    start and cannot ``wait()``: SIGTERM, poll within the grace, then
    SIGKILL."""
    for pid in pids:
        if _pid_alive(pid):
            _signal_group(pid, signal.SIGTERM)
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        if not any(_pid_alive(p) for p in pids):
            return
        time.sleep(0.1)
    for pid in pids:
        if _pid_alive(pid):
            _signal_group(pid, signal.SIGKILL)
    while any(_pid_alive(p) for p in pids):
        time.sleep(0.05)


def _touch(path: str) -> None:
    """Bump a beacon file's mtime (created at the first touch); never
    raises: a beacon failure must not kill a healthy coordinator."""
    try:
        os.utime(path, None)
    except OSError:
        try:
            with open(path, "a"):
                pass
        except OSError as e:
            from xgboost_tpu_torch.obs.metrics import swallowed_error
            swallowed_error("parallel.launch.beacon", e)


def _wait_for_stale_lease(state_path: str, lease_sec: float,
                          poll: float = 0.25) -> None:
    """The standby's wait: the primary renews its lease by bumping the
    state file's mtime every poll tick; block until that has not
    happened for ``lease_sec`` (or the file has not appeared for that
    long), measured on the monotonic clock."""
    last_mtime: Optional[float] = None
    last_change = time.monotonic()
    while True:
        try:
            m = os.stat(state_path).st_mtime
        except OSError:
            m = None
        if m is not None and m != last_mtime:
            last_mtime = m
            last_change = time.monotonic()
        elif time.monotonic() - last_change > lease_sec:
            return
        time.sleep(poll)


def launch_local(n: int, cmd: List[str], keepalive: bool = False,
                 max_restarts: int = 10,
                 watchdog_stall_sec: float = 0.0,
                 restart_backoff_sec: float = 0.5,
                 standalone: bool = False,
                 degrade_after: int = 0,
                 min_workers: int = 1,
                 gang_partition_sec: float = 0.0,
                 gang_dir: Optional[str] = None,
                 state_path: Optional[str] = None,
                 standby: bool = False,
                 coord_lease_sec: float = 10.0,
                 timeout_sec: float = 0.0) -> int:
    """Spawn ``n`` ranks running ``cmd`` on this host and supervise them
    (the ``rabit_demo.py`` submitter).  Returns 0 when the gang ends
    with every rank at 0, else a rank's non-zero code (the first seen),
    :data:`STALL_RC`, :data:`COORD_FENCED_RC`, or 124 past
    ``timeout_sec`` (0 = no limit) for the whole launch.

    - ``keepalive``: a rank's non-zero exit restarts the WHOLE gang with
      ``XGBTPU_NUM_TRIAL`` bumped and a fresh coordinator port (a
      process group cannot take a restarted rank back, and gloo's store
      must never meet the last attempt's port); training resumes from
      ``checkpoint_dir``.  Restarts draw on ``max_restarts``, with
      jittered exponential backoff from ``restart_backoff_sec``
      (``reliability/deadline.backoff_delay``, capped at 30 s).
    - ``watchdog_stall_sec > 0``: every rank touches ``hb-<rank>`` in a
      fresh per-attempt heartbeat dir at each round
      (``mock.begin_round``); when no rank's newest heartbeat has
      changed for that long (startup counts), the gang is killed and,
      with keepalive, restarted as for a death; without it the launch
      returns :data:`STALL_RC`.
    - ``standalone``: no ``XGBTPU_COORD``; the ranks run alone and the
      launcher only restarts and watches them.
    - The gang features arm with any of ``degrade_after``,
      ``gang_partition_sec``, ``gang_dir``, ``state_path`` or
      ``standby``.  After ``degrade_after`` failed attempts in a row at
      the current size, or at once on a host loss (a rank's
      ``HOST_LOSS_RC`` or ``lost-<rank>`` tombstone), the gang is
      re-planned one rank smaller (:func:`plan_degrade`, never below
      ``min_workers``) and resumes from the ring; while degraded a
      ``grow`` file in the gang dir re-expands it to full size at once
      (the ring's last member is the segment boundary).
      ``gang_partition_sec``: the launcher touches the ``coord`` beacon
      every poll tick and a rank that sees it stale that long
      self-fences.  ``state_path`` (default
      ``<gang_dir>/coord-state.json``): the roster, trial and plan are
      snapshot at every attempt, so a coordinator restarted on the same
      path re-adopts a live gang (pids polled, clean exits read from
      ``done-<rank>`` markers).  ``standby``: wait until the primary's
      lease (the state file's mtime, bumped every tick) is
      ``coord_lease_sec`` stale, then take over; a superseded primary
      exits :data:`COORD_FENCED_RC` without touching the ranks."""
    from xgboost_tpu_torch.obs import event
    from xgboost_tpu_torch.obs.metrics import reliability_metrics
    from xgboost_tpu_torch.parallel import gang as gangmod
    from xgboost_tpu_torch.reliability.deadline import backoff_delay

    rm = reliability_metrics()
    t_launch = time.monotonic()
    gang_on = bool(degrade_after or gang_partition_sec > 0 or gang_dir
                   or state_path or standby)
    own_gang_dir = False
    if gang_on:
        if gang_dir is None:
            gang_dir = tempfile.mkdtemp(prefix="xgbtpu_gang_")
            own_gang_dir = True
        else:
            os.makedirs(gang_dir, exist_ok=True)
        if state_path is None:
            state_path = os.path.join(gang_dir, "coord-state.json")
    holder = f"pid{os.getpid()}"

    if standby:
        print(f"[launch] standby coordinator: watching {state_path} "
              f"(lease {coord_lease_sec}s)", file=sys.stderr)
        _wait_for_stale_lease(state_path, coord_lease_sec)
        event("launch.standby_takeover", state_path=state_path,
              holder=holder)
        print(f"[launch] standby takeover: lease stale, {holder} is "
              "now the coordinator", file=sys.stderr)

    hb_root = None
    if watchdog_stall_sec > 0:
        hb_root = tempfile.mkdtemp(prefix="xgbtpu_hb_")

    # the plan: full size as asked; shrinks on degrade, back on grow
    cur_n = n
    degraded = False
    trial = 0
    fails_at_size = 0

    # a previous holder's snapshot with every rank alive (or done):
    # adopt the gang, do not orphan or needlessly kill it
    adopt_pids: Optional[Dict[int, int]] = None
    adopt_hb_dir: Optional[str] = None
    if gang_on and os.path.exists(state_path):
        st = _read_state(state_path)
        if st and int(st.get("full_n", -1)) == n:
            trial = int(st.get("trial", 0))
            cur_n = int(st.get("cur_n", n))
            degraded = bool(st.get("degraded"))
            workers = {int(w["rank"]): int(w["pid"])
                       for w in st.get("workers", [])}
            live = {r: p for r, p in workers.items() if _pid_alive(p)}
            done_marks = {r for r in workers
                          if os.path.exists(os.path.join(
                              gang_dir, f"done-{r}"))}
            if workers and all(r in live or r in done_marks
                               for r in workers):
                adopt_pids = workers
                adopt_hb_dir = st.get("hb_dir")
            elif live:
                # a partial gang is broken: end the stragglers, restart
                _reap_pids(list(live.values()))

    def snapshot(workers: Dict[int, int], hb_dir: Optional[str]) -> None:
        _write_state(state_path, {
            "full_n": n, "cur_n": cur_n, "cur_devices": None,
            "degraded": degraded, "trial": trial, "hb_dir": hb_dir,
            "gang_dir": gang_dir,
            "workers": [{"rank": r, "pid": p} for r, p in workers.items()],
        }, holder)

    procs: List[subprocess.Popen] = []
    live_pids: Dict[int, int] = {}
    used_ports: set = set()
    try:
        while True:
            rm.launch_mesh_size.set(cur_n)
            rm.launch_degraded.set(1 if degraded else 0)
            t_attempt = time.perf_counter()
            adopted = adopt_pids is not None
            grow_path = (os.path.join(gang_dir, GROW_SIGNAL)
                         if gang_on else None)

            if adopted:
                live_pids = dict(adopt_pids)
                adopt_pids = None
                hb_dir = adopt_hb_dir
                event("launch.adopt", trial=trial,
                      workers=sorted(live_pids.values()))
                print(f"[launch] re-adopting live gang "
                      f"{sorted(live_pids.items())} (trial {trial})",
                      file=sys.stderr)
                snapshot(live_pids, hb_dir)
                procs = []
            else:
                # a fresh port each attempt, never an earlier one's: the
                # last attempt's store may still hold its socket
                port = free_port()
                while port in used_ports:
                    port = free_port()
                used_ports.add(port)
                coord = f"127.0.0.1:{port}"
                hb_dir = None
                if hb_root is not None:
                    # a fresh beacon dir each attempt: the last trial's
                    # heartbeats must not vouch for this one
                    hb_dir = os.path.join(hb_root, f"t{trial}")
                    os.makedirs(hb_dir, exist_ok=True)
                if gang_on:
                    # the last attempt's done markers must not vouch
                    # for this attempt's ranks
                    for name in os.listdir(gang_dir):
                        if name.startswith("done-"):
                            try:
                                os.remove(os.path.join(gang_dir, name))
                            except OSError:
                                pass  # racing another cleaner
                    _touch(os.path.join(gang_dir, gangmod.BEACON_NAME))

                def spawn(rank: int) -> subprocess.Popen:
                    env = dict(os.environ)
                    if not standalone:
                        env[COORD_ENV] = coord
                    env[NWORKER_ENV] = str(cur_n)
                    env[RANK_ENV] = str(rank)
                    env[LOCAL_RANK_ENV] = str(rank)
                    env[LOCAL_WORKERS_ENV] = str(cur_n)
                    env[TRIAL_ENV] = str(trial)
                    if hb_dir is not None:
                        env["XGBTPU_HEARTBEAT_DIR"] = hb_dir
                    if gang_on:
                        env[gangmod.GANG_DIR_ENV] = gang_dir
                        if gang_partition_sec > 0:
                            env[gangmod.PARTITION_SEC_ENV] = str(
                                gang_partition_sec)
                        if degraded:
                            env[gangmod.DEGRADED_ENV] = "1"
                        else:
                            env.pop(gangmod.DEGRADED_ENV, None)
                    # a session of its own: ended by its process group
                    return subprocess.Popen(cmd, env=env,
                                            start_new_session=True)

                procs = [spawn(r) for r in range(cur_n)]
                live_pids = {}
                if gang_on:
                    snapshot({r: p.pid for r, p in enumerate(procs)},
                             hb_dir)

            procs_left: List[Optional[subprocess.Popen]] = list(procs)
            done_ranks: set = set()
            # progress = the newest heartbeat's mtime changed since the
            # last poll; the silence is measured on the monotonic clock
            last_progress = time.monotonic()
            last_hb_seen: Optional[float] = None
            failed_rc = None
            host_lost = stalled = grow = superseded = timed_out = False
            tick = 0

            def gang_alive() -> bool:
                if adopted:
                    return any(r not in done_ranks for r in live_pids)
                return any(p is not None for p in procs_left)

            while gang_alive() and failed_rc is None:
                time.sleep(_POLL_SEC)
                tick += 1
                if timeout_sec and time.monotonic() - t_launch > timeout_sec:
                    timed_out = True
                    break
                if gang_on:
                    # the coordinator's beacon (ranks fence off its
                    # staleness) and the lease a standby watches
                    _touch(os.path.join(gang_dir, gangmod.BEACON_NAME))
                    _touch(state_path)
                    if tick % 10 == 0:
                        st = _read_state(state_path)
                        if st is not None and st.get("holder") != holder:
                            superseded = True
                            break
                    if degraded and os.path.exists(grow_path):
                        grow = True
                        try:
                            os.remove(grow_path)
                        except OSError:
                            pass  # consumed either way
                        break
                if adopted:
                    for r, pid in live_pids.items():
                        if r in done_ranks or _pid_alive(pid):
                            continue
                        if os.path.exists(os.path.join(
                                gang_dir, f"done-{r}")):
                            done_ranks.add(r)
                            continue
                        failed_rc = 1  # not our child: its code is unknown
                        rm.launch_worker_deaths.inc()
                        event("launch.worker_death", rank=r, rc=None,
                              trial=trial, adopted=True)
                        print(f"[launch] adopted worker {r} (pid {pid})"
                              f" died without a done marker "
                              f"(trial {trial})", file=sys.stderr)
                        break
                else:
                    for r, p in enumerate(procs_left):
                        if p is None or p.poll() is None:
                            continue
                        if p.returncode == 0:
                            procs_left[r] = None
                        else:
                            failed_rc = p.returncode
                            if p.returncode == gangmod.HOST_LOSS_RC:
                                host_lost = True
                            rm.launch_worker_deaths.inc()
                            event("launch.worker_death", rank=r,
                                  rc=p.returncode, trial=trial)
                            print(f"[launch] worker {r} died "
                                  f"(rc={p.returncode}, trial {trial})",
                                  file=sys.stderr)
                            break
                if (failed_rc is None and hb_dir is not None
                        and gang_alive()):
                    hb = _latest_heartbeat(hb_dir)
                    if hb is not None and hb != last_hb_seen:
                        last_hb_seen = hb
                        last_progress = time.monotonic()
                    silent = time.monotonic() - last_progress
                    if silent > watchdog_stall_sec:
                        stalled = True
                        event("launch.stall", trial=trial,
                              silent_sec=round(silent, 2),
                              stall_window_sec=watchdog_stall_sec)
                        print(f"[launch] STALL: no rank advanced for "
                              f"{silent:.1f}s (> {watchdog_stall_sec}s"
                              f", trial {trial}); killing the gang",
                              file=sys.stderr)
                        break

            if superseded:
                # a standby holds the lease: the ranks are its own now
                event("launch.coord_fenced", trial=trial, holder=holder)
                print(f"[launch] coordinator fenced: state holder "
                      f"changed under {holder}; exiting "
                      f"rc={COORD_FENCED_RC} without touching the "
                      "gang", file=sys.stderr)
                return COORD_FENCED_RC
            if timed_out:
                print(f"[launch] ranks still running after {timeout_sec} s;"
                      " ending them", file=sys.stderr)
                if adopted:
                    _reap_pids([p for r, p in live_pids.items()
                                if r not in done_ranks])
                else:
                    _reap(procs_left)
                return 124
            if failed_rc is None and not stalled and not grow:
                if gang_on:
                    try:
                        os.remove(state_path)  # done: nothing to adopt
                    except OSError:
                        pass
                return 0
            t_detect = time.perf_counter()
            if adopted:
                _reap_pids([p for r, p in live_pids.items()
                            if r not in done_ranks])
            else:
                _reap(procs_left)

            if grow:
                trial += 1
                prev = cur_n
                cur_n = n
                degraded = False
                fails_at_size = 0
                rm.launch_growbacks.inc()
                rm.launch_restarts.inc("growback")
                event("launch.growback", trial=trial, from_size=prev,
                      to_size=cur_n)
                print(f"[launch] GROW-BACK: replacement registered; "
                      f"re-expanding {prev}x1 -> {cur_n}x1 from the last "
                      f"segment boundary (trial {trial})", file=sys.stderr)
                continue  # a healthy gang was cut: restart at once

            if not keepalive or trial >= max_restarts:
                return STALL_RC if stalled else failed_rc
            trial += 1
            fails_at_size += 1
            tombs = gangmod.live_tombstones(gang_dir) if gang_on else []
            reason = ("stall" if stalled
                      else "host_loss" if host_lost or tombs
                      else "fence" if failed_rc == gangmod.FENCE_RC
                      else "death")
            rm.launch_restarts.inc(reason)
            event("launch.restart", reason=reason, trial=trial,
                  attempt_sec=round(t_detect - t_attempt, 2))

            # re-plan smaller at once on a host loss, or after
            # degrade_after failures in a row at this size; the ring's
            # last member is the resume point at either size
            if gang_on and (host_lost or tombs
                            or (degrade_after > 0
                                and fails_at_size >= degrade_after)):
                plan = plan_degrade(cur_n, None, min_workers)
                why = ("host loss" if host_lost or tombs
                       else "restart budget")
                if plan is not None:
                    prev = cur_n
                    cur_n = plan[0]
                    degraded = True
                    fails_at_size = 0
                    event("launch.degrade", trial=trial,
                          reason=why.replace(" ", "_"), from_size=prev,
                          to_size=cur_n)
                    print(f"[launch] DEGRADE: re-planning {prev}x1 -> "
                          f"{cur_n}x1 ({why}, trial {trial}); resuming "
                          "from the last segment boundary",
                          file=sys.stderr)
                    for t in tombs:  # consumed: no longer scheduled
                        try:
                            os.remove(os.path.join(gang_dir, f"lost-{t}"))
                        except OSError:
                            pass
                else:
                    print(f"[launch] cannot degrade below {cur_n}x1; "
                          "retrying at the same size", file=sys.stderr)

            # a crash loop must not spin the host it recovers on
            delay = backoff_delay(trial, base=restart_backoff_sec,
                                  cap=30.0)
            print(f"[launch] restarting all {cur_n} workers, trial "
                  f"{trial} (reason {reason}, attempt ran "
                  f"{t_detect - t_attempt:.2f}s, "
                  f"reap {time.perf_counter() - t_detect:.2f}s, "
                  f"backoff {delay:.2f}s)", file=sys.stderr)
            time.sleep(delay)
    except BaseException:
        # ended from outside (SIGTERM through main(), an interrupt): the
        # ranks go with the launcher
        _reap(procs)
        _reap_pids(list(live_pids.values()))
        raise
    finally:
        if hb_root is not None:
            shutil.rmtree(hb_root, ignore_errors=True)
        if own_gang_dir:
            shutil.rmtree(gang_dir, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m xgboost_tpu_torch.parallel.launch",
        description="spawn and supervise N ranks of a worker command on "
                    "this host")
    ap.add_argument("-n", "--nworker", type=int, required=True)
    ap.add_argument("--timeout-sec", type=float, default=0.0,
                    help="end the ranks after this long (0 = no limit)")
    ap.add_argument("--keepalive", action="store_true",
                    help="restart the gang when a rank dies nonzero (and "
                         "when the stall watchdog kills it)")
    ap.add_argument("--watchdog-stall-sec", type=float, default=0.0,
                    help="kill (and with --keepalive restart) the gang "
                         "when no rank has beaten its heartbeat (once a "
                         "round) for this long; must cover startup and "
                         "the slowest round (0 = off)")
    ap.add_argument("--max-restarts", type=int, default=10,
                    help="gang restarts (death, stall, fence, host loss) "
                         "before giving up")
    ap.add_argument("--restart-backoff-sec", type=float, default=0.5,
                    help="base backoff between gang restarts (doubles a "
                         "trial, jittered, capped at 30 s)")
    ap.add_argument("--standalone", action="store_true",
                    help="supervise without a rendezvous (no "
                         "XGBTPU_COORD): keepalive and the watchdog only")
    ap.add_argument("--degrade-after", type=int, default=0,
                    help="after this many failed attempts in a row at the "
                         "current size (at once on a host loss), re-plan "
                         "the gang one rank smaller and resume from the "
                         "last segment boundary (0 = off)")
    ap.add_argument("--min-workers", type=int, default=1,
                    help="never degrade below this many ranks")
    ap.add_argument("--gang-partition-sec", type=float, default=0.0,
                    help="ranks self-fence (no checkpoint or beacon "
                         "writes, exit 143) after this long without a "
                         "fresh coordinator beacon (0 = off)")
    ap.add_argument("--gang-dir", default=None,
                    help="the gang protocol's directory (beacon, "
                         "tombstones, grow signal); default: a fresh "
                         "temporary directory, removed at the end")
    ap.add_argument("--state-path", default=None,
                    help="the coordinator's state snapshot (CRC-footered "
                         "JSON, written atomically): restart with the same "
                         "path to re-adopt a live gang (default: "
                         "<gang-dir>/coord-state.json)")
    ap.add_argument("--standby", action="store_true",
                    help="warm standby: wait until the primary's lease "
                         "on --state-path is stale, then take over and "
                         "adopt its ranks")
    ap.add_argument("--coord-lease-sec", type=float, default=10.0,
                    help="the coordinator's lease: the primary bumps the "
                         "state file's mtime every poll tick; a standby "
                         "takes over after this long without a bump")
    ap.add_argument("--metrics-file", default=None,
                    help="write this process's metrics (the "
                         "xgbtpu_launch_* series among them) as "
                         "Prometheus text to this file when the launch "
                         "ends, for a textfile collector")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.cmd and args.cmd[0] == "--":
        args.cmd = args.cmd[1:]
    if not args.cmd:
        ap.error("missing worker command")

    def on_term(signum, frame):
        raise SystemExit(128 + signum)  # launch_local reaps the ranks
    signal.signal(signal.SIGTERM, on_term)
    try:
        return launch_local(
            args.nworker, args.cmd, keepalive=args.keepalive,
            max_restarts=args.max_restarts,
            watchdog_stall_sec=args.watchdog_stall_sec,
            restart_backoff_sec=args.restart_backoff_sec,
            standalone=args.standalone, degrade_after=args.degrade_after,
            min_workers=args.min_workers,
            gang_partition_sec=args.gang_partition_sec,
            gang_dir=args.gang_dir, state_path=args.state_path,
            standby=args.standby, coord_lease_sec=args.coord_lease_sec,
            timeout_sec=args.timeout_sec)
    finally:
        if args.metrics_file:
            from xgboost_tpu_torch.obs.metrics import registry
            from xgboost_tpu_torch.reliability.integrity import atomic_write
            atomic_write(args.metrics_file, registry().render().encode(),
                         durable=False)


if __name__ == "__main__":
    sys.exit(main())
