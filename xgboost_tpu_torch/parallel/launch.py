"""Rank rendezvous and the local launcher (port of the rendezvous part
of ``xgboost_tpu/parallel/launch.py``; the reference's tracker and
``rabit_demo.py``).

Local usage, N ranks on one host::

    python -m xgboost_tpu_torch.parallel.launch -n 4 \\
        python -m xgboost_tpu_torch train.conf

Cluster usage: run the same worker command on every host with
``XGBTPU_COORD`` (host:port of rank 0), ``XGBTPU_NUM_WORKER`` and
``XGBTPU_WORKER_ID`` exported; :func:`init_worker` reads them and calls
``torch.distributed.init_process_group(init_method="tcp://COORD")``.

The backend is read from what the process can observe: NCCL when the
rank runs on a GPU and every rank on its host has a card of its own
(``XGBTPU_LOCAL_WORKERS`` ranks on the host, the world by default),
gloo otherwise, on the CPU and for several ranks on one card (NCCL
refuses two ranks on one card).  Nothing tries one and falls back to
the other.  A rank binds ``cuda:(local_rank % device_count)``, its local
rank ``XGBTPU_LOCAL_RANK`` (the rank by default).

The launcher's fault tolerance (keepalive restarts, the stall watchdog,
``plan_degrade``, coordinator state and standby, grow-back) and the
scheduler submitters are ROADMAP.md section 1 item 13c: those options
raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

import torch

COORD_ENV = "XGBTPU_COORD"
NWORKER_ENV = "XGBTPU_NUM_WORKER"
RANK_ENV = "XGBTPU_WORKER_ID"
LOCAL_RANK_ENV = "XGBTPU_LOCAL_RANK"
LOCAL_WORKERS_ENV = "XGBTPU_LOCAL_WORKERS"

_ITEM_13C = "ROADMAP.md section 1 item 13c"


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
    """Join the world named by the launcher's environment; True when
    distributed mode is on (``XGBTPU_COORD`` set).  Call before any
    device use: it binds the rank's card as the current CUDA device and
    installs the world (``set_mesh``).
    ``device="cpu"`` keeps the rank on the CPU (gloo)."""
    coord = os.environ.get(COORD_ENV)
    if not coord:
        return False
    if RANK_ENV not in os.environ or NWORKER_ENV not in os.environ:
        raise NotImplementedError(
            f"{COORD_ENV} is set without {RANK_ENV} / {NWORKER_ENV}: ranks "
            f"from a scheduler's environment (mpirun, srun, qsub) are "
            f"{_ITEM_13C}")
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    n, rank = int(os.environ[NWORKER_ENV]), int(os.environ[RANK_ENV])
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


def _reap(procs: List[Optional[subprocess.Popen]],
          grace: float = 3.0) -> None:
    """Terminate, then kill, every live child, and wait for them all."""
    for q in procs:
        if q is not None and q.poll() is None:
            q.terminate()
    for q in procs:
        if q is None:
            continue
        try:
            q.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            q.kill()
            q.wait()


def launch_local(n: int, cmd: List[str], poll_sec: float = 0.1,
                 timeout_sec: float = 0.0) -> int:
    """Spawn ``n`` ranks running ``cmd`` on this host with the rendezvous
    environment (a fresh coordinator port), wait for them and reap them.
    Returns 0 when every rank exits 0, else the first non-zero exit code
    seen; once a rank fails the others are terminated (they would wait
    in a collective for it), and a run past ``timeout_sec`` (0 = none)
    is ended with code 124."""
    port = free_port()
    procs: List[subprocess.Popen] = []
    for r in range(n):
        env = dict(os.environ)
        env.update({COORD_ENV: f"127.0.0.1:{port}", NWORKER_ENV: str(n),
                    RANK_ENV: str(r), LOCAL_RANK_ENV: str(r),
                    LOCAL_WORKERS_ENV: str(n)})
        procs.append(subprocess.Popen(cmd, env=env))
    t0 = time.monotonic()
    rc = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                rc = bad[0]
                break
            if all(c == 0 for c in codes):
                break
            if timeout_sec and time.monotonic() - t0 > timeout_sec:
                print(f"[launch] ranks still running after {timeout_sec} s;"
                      " ending them", file=sys.stderr)
                rc = 124
                break
            time.sleep(poll_sec)
    finally:
        _reap(procs)
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m xgboost_tpu_torch.parallel.launch",
        description="spawn N ranks of a worker command on this host")
    ap.add_argument("-n", "--nworker", type=int, required=True)
    ap.add_argument("--timeout-sec", type=float, default=0.0,
                    help="end the ranks after this long (0 = no limit)")
    for flag in ("--keepalive", "--standalone", "--standby"):
        ap.add_argument(flag, action="store_true",
                        help=f"not ported ({_ITEM_13C})")
    for flag in ("--watchdog-stall-sec", "--degrade-after",
                 "--gang-partition-sec"):
        ap.add_argument(flag, type=float, default=0.0,
                        help=f"not ported ({_ITEM_13C})")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.cmd and args.cmd[0] == "--":
        args.cmd = args.cmd[1:]
    if not args.cmd:
        ap.error("missing worker command")
    unported = [f for f in ("keepalive", "standalone", "standby",
                            "watchdog_stall_sec", "degrade_after",
                            "gang_partition_sec") if getattr(args, f)]
    if unported:
        raise NotImplementedError(
            f"--{unported[0].replace('_', '-')}: the launcher's fault "
            f"tolerance is {_ITEM_13C}")
    return launch_local(args.nworker, args.cmd,
                        timeout_sec=args.timeout_sec)


if __name__ == "__main__":
    sys.exit(main())
