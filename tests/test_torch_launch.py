"""The port's launcher and the CLI as ranks of a world
(``xgboost_tpu_torch/parallel/launch.py``, ``cli.py``), on the CPU over
gloo.

``python -m xgboost_tpu_torch.parallel.launch -n N cmd ...`` spawns N
ranks with ``XGBTPU_COORD`` / ``XGBTPU_NUM_WORKER`` / ``XGBTPU_WORKER_ID``
and returns the first non-zero exit code; the CLI under it trains
``dsplit=row``, rank 0 alone writes the model, and a resume is rank 0's
checkpoint broadcast to every rank.  The CLI runs are started at once
and read afterwards, so the spawns overlap.  Models are compared byte
for byte (``hist_precision=fixed``) where the runs' arguments are the
same, and by their arrays (trees and cuts) where an argument differs,
since the model header records every parameter given.
"""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xgboost_tpu_torch.parallel import launch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = {"objective": "binary:logistic", "max_depth": "3", "eta": "0.5",
        "max_bin": "16", "hist_precision": "fixed", "device_sketch": "0",
        "dsplit": "row", "silent": "0", "eval_train": "1"}


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("XLA_FLAGS", launch.COORD_ENV, launch.RANK_ENV,
              launch.NWORKER_ENV):
        env.pop(k, None)
    return env


def write_svm(path, X, y):
    with open(path, "w") as f:
        for row, lab in zip(X, y):
            f.write(f"{lab:g} " + " ".join(f"{j}:{v:g}"
                                           for j, v in enumerate(row)) + "\n")


def cli(world, cwd, *args):
    """The CLI on the CPU, under the launcher when ``world`` > 0."""
    cmd = [sys.executable, "-m", "xgboost_tpu_torch", "run.conf",
           "device=cpu", *args]
    if world:
        cmd = [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch",
               "-n", str(world), "--timeout-sec", "240", *cmd]
    return subprocess.Popen(cmd, cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every CLI run, started at once: {name: (rc, stdout, stderr, dir)}."""
    rng = np.random.RandomState(0)
    X = np.round(rng.randn(403, 5), 4).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    plan = {
        "one": (0, ["shard_load=0", "model_out=m.model"]),
        "two": (2, ["shard_load=0", "model_out=m.model"]),
        "split": (2, ["device_sketch=1", "model_out=m.model"]),
        "replicated": (2, ["device_sketch=1", "shard_load=0",
                           "model_out=m.model"]),
        "ckpt": (2, ["shard_load=0", "num_round=2", "checkpoint_dir=ck",
                     "model_out=half.model"]),
        "bad": (2, ["data=missing.svm"]),
    }
    procs = {}
    for name, (world, args) in plan.items():
        d = tmp_path_factory.mktemp(name)
        write_svm(str(d / "train.svm"), X, y)
        with open(d / "run.conf", "w") as f:
            f.write("".join(f"{k} = {v}\n" for k, v in CONF.items()))
            f.write("data = train.svm\nnum_round = 4\n")
        procs[name] = (cli(world, str(d), *args), d)
    out = {}
    for name, (p, d) in procs.items():
        so, se = p.communicate(timeout=300)
        out[name] = (p.returncode, so, se, d)
    # the resume: the same ring, four rounds, under a new world
    d = out["ckpt"][3]
    p = cli(2, str(d), "shard_load=0", "checkpoint_dir=ck",
            "model_out=m.model")
    so, se = p.communicate(timeout=300)
    out["resume"] = (p.returncode, so, se, d)
    return out


def _model(run):
    return (run[3] / "m.model").read_bytes()


def _state(run):
    import xgboost_tpu_torch as xt
    return xt.Booster(model_file=str(run[3] / "m.model"),
                      device="cpu").gbtree.get_state()


def _same_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _eval_lines(run):
    return [ln for ln in run[2].splitlines()
            if re.match(r"\[\d+\]\t", ln)]


def test_launched_cli_model_equals_world_one(runs):
    """``launch -n 2 python -m xgboost_tpu_torch conf``: rank 0 writes a
    model byte-equal to the world-one CLI run, with its eval lines."""
    for name in ("one", "two"):
        assert runs[name][0] == 0, runs[name][2][-2000:]
    assert _model(runs["two"]) == _model(runs["one"])
    assert _eval_lines(runs["two"]) == _eval_lines(runs["one"])
    assert len(_eval_lines(runs["two"])) == 4    # rank 1 is silenced


def test_split_loaded_cli_equals_replicated_load(runs):
    """``shard_load=1`` (the default under a launcher): each rank parses
    its block of the text, and the model is byte-equal to the
    replicated load with the device sketch."""
    for name in ("split", "replicated"):
        assert runs[name][0] == 0, runs[name][2][-2000:]
    _same_arrays(_state(runs["split"]), _state(runs["replicated"]))
    assert _eval_lines(runs["split"]) == _eval_lines(runs["replicated"])


def test_resume_broadcasts_rank0_checkpoint(runs):
    """Two rounds with a checkpoint ring, then four: rank 0 resumes at
    round 2 and broadcasts the model to rank 1, and the final model is
    the uninterrupted run's."""
    assert runs["ckpt"][0] == 0, runs["ckpt"][2][-2000:]
    assert runs["resume"][0] == 0, runs["resume"][2][-2000:]
    assert "[ckpt] resume at round 2" in runs["resume"][2]
    _same_arrays(_state(runs["resume"]), _state(runs["two"]))


def test_fatal_error_ends_the_ranks(runs):
    """A rank that fails ends its process at once with the worker crash
    code (41), and the launcher returns it."""
    from xgboost_tpu_torch.reliability.rc import WORKER_CRASH_RC
    assert runs["bad"][0] == WORKER_CRASH_RC
    assert "missing.svm" in runs["bad"][2]


def test_launcher_returns_first_failure_without_hanging(tmp_path):
    """One rank exits 3 while the other would wait a minute: the launcher
    returns 3 at once and reaps the survivor."""
    code = ("import os, sys, time\n"
            f"r = int(os.environ['{launch.RANK_ENV}'])\n"
            "assert os.environ['XGBTPU_NUM_WORKER'] == '2'\n"
            "assert os.environ['XGBTPU_COORD'].startswith('127.0.0.1:')\n"
            "time.sleep(0.3) if r else time.sleep(60)\n"
            "sys.exit(3 if r else 0)\n")
    t0 = time.perf_counter()
    rc = subprocess.run(
        [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch", "-n",
         "2", sys.executable, "-c", code], env=_env(), cwd=str(tmp_path),
        timeout=120).returncode
    assert rc == 3
    assert time.perf_counter() - t0 < 30


def test_launcher_every_rank_zero_is_zero(tmp_path):
    code = ("import os\n"
            f"open('r' + os.environ['{launch.RANK_ENV}'], 'w').write('x')\n")
    rc = subprocess.run(
        [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch", "-n",
         "3", "--", sys.executable, "-c", code], env=_env(),
        cwd=str(tmp_path), timeout=120).returncode
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == ["r0", "r1", "r2"]


def test_init_worker_reads_the_environment(monkeypatch):
    from xgboost_tpu_torch.parallel import mesh_available
    for k in (launch.COORD_ENV, launch.RANK_ENV, launch.NWORKER_ENV):
        monkeypatch.delenv(k, raising=False)
    assert launch.init_worker("cpu") is False
    assert not mesh_available(1)          # no process group: no world
    monkeypatch.setenv(launch.COORD_ENV, "127.0.0.1:1")
    for k in ("OMPI_COMM_WORLD_RANK", "PMIX_RANK", "PMI_RANK",
              "SLURM_PROCID", "SGE_TASK_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no rank source found"):
        launch.init_worker("cpu")


def test_backend_and_device_choice(monkeypatch):
    """gloo on the CPU; a rank's device is its local rank modulo the
    cards (no card here: the CPU only when asked)."""
    assert launch.pick_backend(torch.device("cpu")) == "gloo"
    assert launch.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.rank_device()


def test_data_mesh_blocks_match_the_jax_layout():
    """Rank r's block of N rows padded to the world: ``[r m, (r + 1) m)``
    with ``m = (N + (-N) % W) / W``; the blocks tile the padded rows."""
    from xgboost_tpu_torch.parallel.dp import pad_rows, shard_rows
    from xgboost_tpu_torch.parallel.mesh import DataMesh
    for n in (1, 7, 501, 1000):
        for w in (1, 2, 3, 4, 8):
            blocks = [DataMesh(r, w, "cpu").block(n) for r in range(w)]
            m = (n + pad_rows(n, w)) // w
            assert blocks == [(r * m, (r + 1) * m, m) for r in range(w)]
            x = np.arange(n)
            got = np.concatenate([shard_rows(DataMesh(r, w, "cpu"), x,
                                             fill=-1) for r in range(w)])
            assert got.shape == (w * m,)
            np.testing.assert_array_equal(got[:n], x)
            assert (got[n:] == -1).all()
            t = torch.arange(n)
            tgot = torch.cat([shard_rows(DataMesh(r, w, "cpu"), t, fill=-1)
                              for r in range(w)])
            np.testing.assert_array_equal(tgot.numpy(), got)
