"""Fault injection and recovery in the port (``mock=``, ``keepalive=``,
the gang launcher's restarts; ``xgboost_tpu_torch/parallel/mock.py``,
``cli.py``, ``parallel/launch.py``) against the JAX package's
``tests/test_recovery.py`` and ``tests/test_launch.py`` cases, on the
CPU.

In process: the same ``mock=`` spec fires at the same ``[mock]``
coordinates in both CLIs, and the port's model killed and restarted
from the checkpoint ring (``keepalive=1``) is the JAX CLI's
uninterrupted model byte for byte.  Model headers record every
argument, so each reference run gets the same arguments, relative paths
in a directory of its own, and ``XGBTPU_NUM_TRIAL=9``, a trial no
coordinate names: it runs uninterrupted.

Under the launcher (started at once in a module fixture, gloo ranks,
``device=cpu``, ``hist_precision=fixed``): a rank-tagged death at
W = 2 with ``--keepalive``; a stall composed with a death under the
watchdog; a W = 2 checkpoint ring resumed at W = 4.  Each final model is
byte-equal to an uninterrupted world of one with the same arguments.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu.cli import main as jax_main  # noqa: E402
from xgboost_tpu_torch.cli import main as port_main  # noqa: E402
from xgboost_tpu_torch.parallel import gang, launch, mock  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_multiclass(path, n=400, f=6, n_class=3, seed=0):
    """``tests/test_recovery.py``'s data: 3 classes, some sparsity."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    y = (X[:, 0] * 3 + X[:, 1]).astype(int) % n_class
    with open(path, "w") as fh:
        for i in range(n):
            feats = " ".join(f"{j}:{X[i, j]:.6f}" for j in range(f)
                             if X[i, j] > 0.15)
            fh.write(f"{y[i]} {feats}\n")


def write_binary(path, n, f, seed):
    rng = np.random.RandomState(seed)
    X = np.round(rng.rand(n, f), 4)
    y = (X[:, 0] > 0.5).astype(int)
    with open(path, "w") as fh:
        for i in range(n):
            fh.write(f"{y[i]} " + " ".join(f"{j}:{X[i, j]:g}"
                                           for j in range(f)) + "\n")


def run_in(main, d, argv, trial=None):
    """``main(argv)`` in directory ``d`` at ``XGBTPU_NUM_TRIAL=trial``
    (unset when None): (rc, stderr, model bytes)."""
    os.makedirs(d, exist_ok=True)
    old, saved = os.getcwd(), os.environ.get("XGBTPU_NUM_TRIAL")
    os.chdir(d)
    if trial is None:
        os.environ.pop("XGBTPU_NUM_TRIAL", None)
    else:
        os.environ["XGBTPU_NUM_TRIAL"] = str(trial)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = main(list(argv))
    finally:
        os.chdir(old)
        if saved is None:
            os.environ.pop("XGBTPU_NUM_TRIAL", None)
        else:
            os.environ["XGBTPU_NUM_TRIAL"] = saved
    with open(os.path.join(d, "m.model"), "rb") as f:
        return rc, err.getvalue(), f.read()


def mock_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("[mock]")]


@pytest.fixture(scope="module")
def mc_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mc")
    write_multiclass(str(d / "train.libsvm"))
    write_binary(str(d / "bin.libsvm"), 400, 6, 3)
    return d


MC = ["data=../train.libsvm", "task=train", "num_round=6", "silent=2",
      "objective=multi:softmax", "num_class=3", "max_depth=3", "eta=0.5",
      "max_bin=16", "save_period=0", "model_out=m.model",
      "checkpoint_dir=ck", "keepalive=1"]


@pytest.mark.parametrize("spec,n_deaths", [
    ("0,3,1,0", 1),            # dies mid-round, between class trees
    ("0,2,0,0;0,4,2,1", 2),    # dies twice, the second after a restart
])
def test_kill_restart_equals_the_jax_uninterrupted_model(mc_data, spec,
                                                         n_deaths):
    """Train, die at the coordinates, restart from the ring in process:
    the port's model is the JAX CLI's uninterrupted model byte for byte,
    and the deaths fire at the JAX CLI's coordinates."""
    argv = MC + [f"mock={spec}"]
    tag = spec.replace(",", "_").replace(";", "-")
    rc, _, ref = run_in(jax_main, str(mc_data / f"jref{tag}"), argv, 9)
    assert rc == 0
    rc, jerr, _ = run_in(jax_main, str(mc_data / f"jmock{tag}"), argv)
    assert rc == 0
    rc, err, got = run_in(port_main, str(mc_data / f"port{tag}"),
                          argv + ["device=cpu"])
    assert rc == 0
    assert len(mock_lines(err)) == n_deaths, err
    assert mock_lines(err) == mock_lines(jerr)
    assert got == ref


@pytest.mark.parametrize("params,spec", [
    (["data=../bin.libsvm", "objective=binary:logistic",
      "rounds_per_dispatch=2"], "2,0,0"),
    (["data=../train.libsvm", "objective=multi:softprob", "num_class=3",
      "num_parallel_tree=2"], "1,5,0;3,2,1"),
    (["data=../bin.libsvm", "objective=binary:logistic",
      "updater=grow_colmaker,prune"], "0,1,0,0;0,3,0,1"),
], ids=["segments", "forest", "exact"])
def test_same_spec_fires_at_the_same_coordinates(mc_data, params, spec):
    """One spec, both CLIs: the same ``[mock]`` lines (version, seqno,
    trial), one seqno a tree on the batched, the per-tree exact and the
    segmented paths; the port's restarted model equals its own
    uninterrupted one byte for byte."""
    base = ["task=train", "num_round=5",
            "silent=2", "max_depth=3", "eta=0.5", "max_bin=16",
            "model_out=m.model", "checkpoint_dir=ck", "keepalive=1",
            f"mock={spec}"] + params
    tag = params[-1].replace("=", "_").replace(",", "_")
    rc, jerr, _ = run_in(jax_main, str(mc_data / f"jc{tag}"), base)
    assert rc == 0
    rc, err, got = run_in(port_main, str(mc_data / f"pc{tag}"),
                          base + ["device=cpu"])
    assert rc == 0
    assert mock_lines(err) and mock_lines(err) == mock_lines(jerr)
    rc, _, ref = run_in(port_main, str(mc_data / f"pr{tag}"),
                        base + ["device=cpu"], 9)
    assert rc == 0 and got == ref


@pytest.mark.parametrize("val", [
    "0,1,0", "1,2,3,4", "stall:1,2,0", "die:0,1,2,0;stall:3,4,5",
    "2,0,0;1,3,1,1"])
def test_mock_spec_parses_as_the_jax_cli(val):
    from xgboost_tpu.cli import BoostLearnTask as J
    from xgboost_tpu_torch.cli import BoostLearnTask as T
    j, t = J(), T()
    j.set_param("mock", val)
    t.set_param("mock", val)
    assert t.mock_spec == j.mock_spec
    assert ("mock", val) in t.learner_params    # recorded, as in JAX


@pytest.mark.parametrize("val", ["boom:1,2,3", "1,2", "1,2,3,4,5"])
def test_bad_mock_spec_raises(val):
    from xgboost_tpu_torch.cli import BoostLearnTask
    with pytest.raises(ValueError, match="mock="):
        BoostLearnTask().set_param("mock", val)


def test_kill_without_keepalive_raises(mc_data):
    with pytest.raises(mock.WorkerFailure, match=r"\[mock\] die at "
                       r"version=1 seqno=0 trial=0"):
        port_main(["data=" + str(mc_data / "train.libsvm"), "task=train",
                   "num_round=3", "silent=2", "objective=multi:softmax",
                   "num_class=3", "max_bin=16", "device=cpu",
                   f"model_out={mc_data / 'nk.model'}", "mock=0,1,0,0"])


def test_injection_fires_in_the_booster_api():
    """``update`` and ``boost`` carry the round as the version, before
    its trees' launches."""
    rng = np.random.RandomState(0)
    X = rng.rand(200, 4).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    d = xt.DMatrix(X, label=y)
    mock.set_fault_injection([(1, 0, 0)], trial=0)
    try:
        bst = xt.Booster({"objective": "binary:logistic", "max_depth": 2},
                         cache=[d], device="cpu")
        bst.update(d, 0)
        with pytest.raises(mock.WorkerFailure, match="version=1 seqno=0"):
            bst.update(d, 1)
        # the restarted trial sails past round 1 and dies in boost at
        # round num_boosted_rounds = 2
        mock.set_fault_injection([(1, 0, 0), (2, 0, 1)], trial=1)
        bst.update(d, 1)
        g, h = np.zeros(200, np.float32), np.ones(200, np.float32)
        with pytest.raises(mock.WorkerFailure,
                           match="version=2 seqno=0 trial=1"):
            bst.boost(d, g, h)
        assert mock.active()
    finally:
        mock.clear_fault_injection()
    assert not mock.active()


def test_fenced_rank_writes_no_checkpoint(mc_data, monkeypatch):
    """The ring's second lock: once fenced, segment ends write no
    checkpoint (a ``ckpt.fenced_skip`` event each) and the clean exit
    touches no done marker."""
    import xgboost_tpu_torch.obs as obs
    events = []
    monkeypatch.setattr(obs, "event",
                        lambda name, **kw: events.append((name, kw)))
    gdir = mc_data / "fence_gang"
    gdir.mkdir()
    monkeypatch.setenv(gang.GANG_DIR_ENV, str(gdir))
    monkeypatch.setattr(gang, "_fenced", True)
    rc, _, _ = run_in(port_main, str(mc_data / "fenced"),
                      MC[:-1] + ["rounds_per_dispatch=2", "device=cpu"])
    assert rc == 0
    assert not os.path.exists(mc_data / "fenced" / "ck") or not os.listdir(
        mc_data / "fenced" / "ck")
    assert [kw["version"] for n, kw in events
            if n == "ckpt.fenced_skip"] == [2, 4, 6]
    assert not os.path.exists(gdir / "done-0")


# ------------------------------------------------------ under the launcher
CONF = {"objective": "binary:logistic", "max_depth": "3", "eta": "0.5",
        "max_bin": "16", "hist_precision": "fixed", "device_sketch": "0",
        "dsplit": "row", "silent": "0", "data": "../train.svm",
        "shard_load": "0", "model_out": "m.model", "checkpoint_dir": "ck"}
STALL_S = 20


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in (launch.COORD_ENV, launch.RANK_ENV, launch.NWORKER_ENV,
              "XGBTPU_NUM_TRIAL", "XGBTPU_FAULTS", "XLA_FLAGS"):
        env.pop(k, None)
    return env


def _launch(d, flags, args):
    os.makedirs(d)
    return subprocess.Popen(
        [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch", *flags,
         "--timeout-sec", "300", "--", sys.executable, "-m",
         "xgboost_tpu_torch", "../run.conf", "device=cpu", *args],
        cwd=d, env=_env(), stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each launch with its world-of-one reference: {name: (rc, stderr,
    model bytes, reference bytes)}."""
    root = tmp_path_factory.mktemp("worlds")
    write_binary(str(root / "train.svm"), 400, 5, 9)
    with open(root / "run.conf", "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in CONF.items()))
    plan = {
        # rank 1 dies at round 2; the gang restarts from the ring
        "death": (["-n", "2", "--keepalive", "--restart-backoff-sec",
                   "0.1"], ["num_round=4", "rounds_per_dispatch=1",
                            "mock=1,2,0,0"]),
        # trial 0 hangs at round 2 (no ring member yet), the watchdog
        # restarts the gang, trial 1 dies at round 3 after the round-2
        # member, trial 2 resumes at round 2
        "stall": (["-n", "1", "--standalone", "--keepalive",
                   "--watchdog-stall-sec", str(STALL_S),
                   "--restart-backoff-sec", "0.1"],
                  ["num_round=4", "rounds_per_dispatch=2",
                   "mock=stall:2,0,0;die:3,0,1"]),
        # two rounds at W = 2 into the ring, then four at W = 4
        "ring": (["-n", "2"], ["num_round=2"]),
    }
    procs = {name: _launch(str(root / name), flags, args)
             for name, (flags, args) in plan.items()}
    refs = {}
    for name, (_, args) in plan.items():
        if name == "ring":
            args = ["num_round=4"]
        rc, _, refs[name] = run_in(port_main, str(root / f"{name}_ref"),
                                   ["../run.conf", "device=cpu", *args], 9)
        assert rc == 0
    out = {}
    for name, p in procs.items():
        _, err = p.communicate(timeout=400)
        out[name] = [p.returncode, err]
    p = subprocess.Popen(
        [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch", "-n",
         "4", "--timeout-sec", "300", "--", sys.executable, "-m",
         "xgboost_tpu_torch", "../run.conf", "device=cpu", "num_round=4"],
        cwd=str(root / "ring"), env=_env(), stderr=subprocess.PIPE,
        text=True)
    _, err = p.communicate(timeout=400)
    out["ring4"] = [p.returncode, err]
    for name in plan:
        path = root / name / "m.model"
        out[name] += [path.read_bytes() if path.exists() else None,
                      refs[name]]
    return out


def test_rank_specific_death_restarts_the_gang(worlds):
    """``mock=1,2,0,0`` under ``launch -n 2 --keepalive``: rank 1 alone
    dies, the launcher restarts the whole gang once, rank 0 resumes from
    its ring, and the model is the world of one's, byte for byte."""
    rc, err, got, ref = worlds["death"]
    assert rc == 0, err[-3000:]
    assert mock_lines(err) == [
        "[mock] die at version=2 seqno=0 trial=0; dead"]
    assert "restarting all 2 workers, trial 1 (reason death" in err
    assert "[ckpt] resume at round 2" in err
    assert got == ref


def test_stall_composed_with_death_under_the_watchdog(worlds):
    """The stall fires at round 2 of trial 0, the watchdog restarts the
    gang; trial 1 dies at round 3 and keepalive restarts it; the final
    model is the uninterrupted one's, byte for byte."""
    rc, err, got, ref = worlds["stall"]
    assert rc == 0, err[-3000:]
    assert "[mock] stall at version=2 seqno=0 trial=0" in err
    assert "[launch] STALL" in err and "reason stall" in err
    assert "[mock] die at version=3 seqno=0 trial=1" in err
    assert "reason death" in err
    assert "[ckpt] resume at round 2" in err
    assert got == ref


def test_ring_of_two_ranks_resumes_at_four(worlds):
    """A W = 2 ring resumed by a W = 4 world at round 2: the model of
    four rounds is the world of one's, byte for byte."""
    assert worlds["ring"][0] == 0, worlds["ring"][1][-3000:]
    rc, err = worlds["ring4"]
    assert rc == 0, err[-3000:]
    assert "[ckpt] resume at round 2" in err
    assert worlds["ring"][2] == worlds["ring"][3]
