"""Cluster job submitters (port of ``xgboost_tpu/parallel/submit.py``;
the reference's ``rabit_mpi.py``, ``rabit_sge.py``).

A submitter starts the same worker command N times on a cluster; each
worker learns (coordinator, world, rank) from the ``XGBTPU_*``
variables or from its scheduler's own (:func:`scheduler_rank`, which
``parallel/launch.init_worker`` reads when ``XGBTPU_WORKER_ID`` is
absent).  Rank 0 serves ``torch.distributed``'s TCP store at the
coordinator address.

Usage::

    python -m xgboost_tpu_torch.parallel.submit -n 8 --mode mpi \\
        --coord host0:9876 -- python -m xgboost_tpu_torch train.conf

``--mode local`` runs the port's gang launcher
(:func:`~xgboost_tpu_torch.parallel.launch.launch_local`); ``--dry-run``
prints the scheduler's command (or job script) instead of running it.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import tempfile
from typing import List, Optional, Tuple

from xgboost_tpu_torch.parallel.launch import (COORD_ENV, NWORKER_ENV,
                                               RANK_ENV, free_port,
                                               launch_local)

# the schedulers' rank and world variables, in the order they are read
_RANK_VARS = ("OMPI_COMM_WORLD_RANK", "PMIX_RANK", "PMI_RANK",
              "SLURM_PROCID")
_WORLD_VARS = ("OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS")


def scheduler_rank() -> Optional[Tuple[int, int]]:
    """``(rank, world)`` from a scheduler's variables, or None.  SGE
    array tasks count from 1 (``SGE_TASK_ID``); MPI and Slurm ranks
    from 0."""
    for rv in _RANK_VARS:
        if rv in os.environ:
            rank = int(os.environ[rv])
            for wv in _WORLD_VARS:
                if wv in os.environ:
                    return rank, int(os.environ[wv])
    if "SGE_TASK_ID" in os.environ and "SGE_TASK_LAST" in os.environ:
        return (int(os.environ["SGE_TASK_ID"]) - 1,
                int(os.environ["SGE_TASK_LAST"]))
    return None


def mpi_command(n: int, coord: str, cmd: List[str]) -> List[str]:
    """The ``mpirun`` line: the coordinator fixed at submit time, each
    worker's rank from its OpenMPI / PMI variables."""
    return (["mpirun", "-n", str(n),
             "-x", f"{COORD_ENV}={coord}",
             "-x", f"{NWORKER_ENV}={n}"] + cmd)


def sge_script(n: int, coord: str, cmd: List[str]) -> str:
    """A ``qsub`` array-job script: tasks 1..N are ranks 0..N-1."""
    quoted = " ".join(shlex.quote(c) for c in cmd)
    return (
        "#!/bin/bash\n"
        f"#$ -t 1-{n}\n"
        "#$ -cwd\n"
        f"export {COORD_ENV}={shlex.quote(coord)}\n"
        f"export {NWORKER_ENV}={n}\n"
        f"export {RANK_ENV}=$((SGE_TASK_ID-1))\n"
        f"exec {quoted}\n")


def slurm_command(n: int, coord: str, cmd: List[str]) -> List[str]:
    """The ``srun`` line; ranks come from ``SLURM_PROCID``."""
    return (["srun", f"--ntasks={n}",
             f"--export=ALL,{COORD_ENV}={coord},{NWORKER_ENV}={n}"] + cmd)


def submit(n: int, cmd: List[str], mode: str = "local",
           coord: Optional[str] = None, keepalive: bool = False,
           dry_run: bool = False) -> int:
    """Submit ``cmd`` as an ``n``-rank job."""
    if mode == "local":
        if dry_run:
            print(f"[submit] local gang: {n} x {' '.join(cmd)}")
            return 0
        return launch_local(n, cmd, keepalive=keepalive)
    if coord is None:
        # the submitting host fronts the store only under mpirun, when
        # rank 0 lands here; the schedulers need an explicit --coord
        if mode == "mpi":
            coord = f"{os.uname().nodename}:{free_port()}"
        else:
            raise ValueError(
                f"--mode {mode} needs --coord host:port (the address "
                "where rank 0's torch.distributed store will listen)")
    if mode == "mpi":
        line = mpi_command(n, coord, cmd)
        if dry_run:
            print(" ".join(shlex.quote(c) for c in line))
            return 0
        return subprocess.call(line)
    if mode == "sge":
        script = sge_script(n, coord, cmd)
        if dry_run:
            print(script, end="")
            return 0
        # written whole, then renamed: qsub must never read a torn script
        from xgboost_tpu_torch.reliability.integrity import atomic_write
        path = os.path.join(tempfile.mkdtemp(prefix="xgtpu-submit-"),
                            "job.sh")
        atomic_write(path, script.encode(), durable=False)
        return subprocess.call(["qsub", path])
    if mode == "slurm":
        line = slurm_command(n, coord, cmd)
        if dry_run:
            print(" ".join(shlex.quote(c) for c in line))
            return 0
        return subprocess.call(line)
    raise ValueError(f"unknown submit mode {mode!r} "
                     "(local | mpi | sge | slurm)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m xgboost_tpu_torch.parallel.submit",
        description="submit an N-rank distributed job "
                    "(rabit_mpi/sge submitter analog)")
    ap.add_argument("-n", "--nworker", type=int, required=True)
    ap.add_argument("--mode", default="local",
                    choices=("local", "mpi", "sge", "slurm"))
    ap.add_argument("--coord", default=None,
                    help="host:port of rank 0's torch.distributed store")
    ap.add_argument("--keepalive", action="store_true")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the scheduler command, do not execute")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.cmd and args.cmd[0] == "--":
        args.cmd = args.cmd[1:]
    if not args.cmd:
        ap.error("missing worker command")
    return submit(args.nworker, args.cmd, mode=args.mode, coord=args.coord,
                  keepalive=args.keepalive, dry_run=args.dry_run)


if __name__ == "__main__":
    sys.exit(main())
