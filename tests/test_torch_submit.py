"""The port's scheduler submitters, the cost model and the launch metric
series (``xgboost_tpu_torch/parallel/submit.py``, ``commcost.py``,
``obs/metrics.py``) against the JAX package's, on the CPU.

Pure functions are held equal to their JAX counterparts on the same
arguments: ``scheduler_rank`` under each scheduler's variables, the
mpirun / qsub / srun lines and script, ``submit --dry-run``,
``hist_psum_bytes``, ``hlo_collectives`` on one HLO text and
``project_round_time`` where the fit's configuration is the call's.
``project_round_time`` at another configuration is the port's deliberate
difference (the fit is not used there).  ``init_worker`` takes its rank
from a scheduler's variables when the launcher's are absent.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from xgboost_tpu.parallel import commcost as jcc  # noqa: E402
from xgboost_tpu.parallel import submit as jsub  # noqa: E402
from xgboost_tpu_torch.parallel import commcost as tcc  # noqa: E402
from xgboost_tpu_torch.parallel import launch  # noqa: E402
from xgboost_tpu_torch.parallel import submit as tsub  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED_VARS = ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "PMIX_RANK",
              "PMI_RANK", "PMI_SIZE", "SLURM_PROCID", "SLURM_NTASKS",
              "SGE_TASK_ID", "SGE_TASK_LAST")
CMD = ["python", "-m", "xgboost_tpu_torch", "train conf.txt", "x=1"]


@pytest.fixture
def no_sched(monkeypatch):
    for k in SCHED_VARS + (launch.COORD_ENV, launch.RANK_ENV,
                           launch.NWORKER_ENV):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", [
    {},
    {"OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "8"},
    {"PMIX_RANK": "2", "PMI_SIZE": "4"},
    {"PMI_RANK": "1", "PMI_SIZE": "2", "SLURM_NTASKS": "9"},
    {"SLURM_PROCID": "5", "SLURM_NTASKS": "6"},
    {"SLURM_PROCID": "5"},                       # no world: not a source
    {"SGE_TASK_ID": "4", "SGE_TASK_LAST": "4"},
    {"SGE_TASK_ID": "4"},
    {"OMPI_COMM_WORLD_RANK": "0", "SLURM_NTASKS": "3", "SGE_TASK_ID": "2",
     "SGE_TASK_LAST": "7"},
], ids=["none", "ompi", "pmix", "pmi", "slurm", "slurm-noworld", "sge",
        "sge-nolast", "mixed"])
def test_scheduler_rank_equals_jax(no_sched, env):
    for k, v in env.items():
        no_sched.setenv(k, v)
    assert tsub.scheduler_rank() == jsub.scheduler_rank()


@pytest.mark.parametrize("n,coord", [(1, "h0:1"), (8, "host-0:9876"),
                                     (3, "10.0.0.1:29500")])
def test_submitter_commands_equal_jax(n, coord):
    """The mpirun and srun lines and the qsub script, byte for byte."""
    assert tsub.mpi_command(n, coord, CMD) == jsub.mpi_command(n, coord, CMD)
    assert tsub.slurm_command(n, coord, CMD) == jsub.slurm_command(
        n, coord, CMD)
    assert tsub.sge_script(n, coord, CMD) == jsub.sge_script(n, coord, CMD)


@pytest.mark.parametrize("mode", ["local", "mpi", "sge", "slurm"])
def test_dry_run_prints_what_jax_prints(mode, capsys):
    args = ["-n", "4", "--mode", mode, "--coord", "h0:9876", "--dry-run",
            "--"] + CMD
    assert tsub.main(args) == 0
    port = capsys.readouterr().out
    assert jsub.main(args) == 0
    assert port == capsys.readouterr().out


def test_scheduler_modes_need_a_coordinator():
    for mode in ("sge", "slurm"):
        with pytest.raises(ValueError, match="needs --coord"):
            tsub.submit(2, CMD, mode=mode, dry_run=True)
    with pytest.raises(ValueError, match="unknown submit mode"):
        tsub.submit(2, CMD, mode="yarn", coord="h:1", dry_run=True)


def test_submit_local_runs_the_gang_launcher(tmp_path):
    """``--mode local`` is the port's launcher: every rank runs with the
    rendezvous environment and the job's code is the ranks' code."""
    code = ("import os\n"
            "open('r' + os.environ['XGBTPU_WORKER_ID'], 'w').write("
            "os.environ['XGBTPU_NUM_WORKER'])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    rc = subprocess.run(
        [sys.executable, "-m", "xgboost_tpu_torch.parallel.submit", "-n",
         "2", "--", sys.executable, "-c", code], cwd=str(tmp_path),
        env=env, timeout=120).returncode
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == ["r0", "r1"]
    assert (tmp_path / "r1").read_text() == "2"


def test_init_worker_takes_a_schedulers_rank(no_sched, tmp_path):
    """``XGBTPU_COORD`` without ``XGBTPU_WORKER_ID``: the rank and world
    come from Slurm's variables (a world of one here), and the rank
    joins it over gloo."""
    import torch.distributed as dist
    from xgboost_tpu_torch.parallel import set_mesh
    no_sched.setenv(launch.COORD_ENV, f"127.0.0.1:{launch.free_port()}")
    no_sched.setenv("SLURM_PROCID", "0")
    no_sched.setenv("SLURM_NTASKS", "1")
    assert not dist.is_initialized()
    try:
        assert launch.init_worker("cpu") is True
        assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def test_alias_module_is_the_launcher(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-m", "xgboost_tpu_torch.launch",
                        "--help"], capture_output=True, text=True, env=env,
                       timeout=120)
    assert p.returncode == 0
    for flag in ("--keepalive", "--watchdog-stall-sec", "--degrade-after",
                 "--standby", "--gang-partition-sec", "--standalone"):
        assert flag in p.stdout


# ------------------------------------------------------------ commcost
@pytest.mark.parametrize("depth,f,b,stat", [(6, 28, 64, 8), (1, 1, 1, 8),
                                            (8, 93, 256, 4), (0, 5, 16, 8)])
def test_hist_psum_bytes_equal_jax(depth, f, b, stat):
    assert tcc.hist_psum_bytes(depth, f, b, stat) == jcc.hist_psum_bytes(
        depth, f, b, stat)


HLO = """\
HloModule m
ENTRY %main {
  %p = f32[32,28,64,2]{3,2,1,0} parameter(0)
  %all-reduce.3 = f32[32,28,64,2]{3,2,1,0} all-reduce(f32[32,28,64,2]{3,2,1,0} %p), replica_groups={}
  ROOT %ar.1 = (f32[4,28]{1,0}, s32[8]{0}) all-reduce(f32[4,28]{1,0} %a, s32[8]{0} %b)
  %ags = (f32[16]{0}, f32[64]{0}, u32[], u32[]) all-gather-start(f32[16]{0} %x)
  %agd = f32[64]{0} all-gather-done((f32[16]{0}, f32[64]{0}) %ags)
  %rss = (f32[64]{0}, f32[16]{0}, u32[]) reduce-scatter-start(f32[64]{0} %y)
  %cp = bf16[3,5]{1,0} collective-permute(bf16[3,5]{1,0} %all-reduce.3)
  %add = f32[4]{0} add(f32[4]{0} %all-reduce.3, f32[4]{0} %q)
  %pr = pred[7]{0} all-reduce(pred[7]{0} %z)
}
"""


def test_hlo_collectives_equal_jax():
    got = tcc.hlo_collectives(HLO)
    assert got == jcc.hlo_collectives(HLO)
    assert [op for op, _, _ in got] == [
        "all-reduce", "all-reduce", "all-gather", "reduce-scatter",
        "collective-permute", "all-reduce"]


@pytest.mark.parametrize("rows,chips", [(1_000_000, 1), (1_000_000, 4),
                                        (250_000, 16)])
def test_projection_at_the_fits_config_equals_jax(rows, chips):
    """At the configuration ROUND_MODEL.json was fitted at, both
    packages use the fit and agree."""
    fit = tcc.fitted_round_model()
    cfg = fit["config"]
    args = (rows, cfg["max_depth"], cfg["n_feat"], cfg["n_bin"], chips,
            0.0144, 1_000_000)
    got = tcc.project_round_time(*args)
    assert got == jcc.project_round_time(*args)
    assert got["fitted"] and got["fixed_round_s"] == fit["fixed_round_s"]


def test_projection_at_another_config_takes_the_anchor():
    """The deliberate difference: at a configuration the fit was not made
    at, the port takes the 4 ms intercept and the anchor's slope
    (``fitted`` False); the JAX package takes the fit regardless."""
    fit = tcc.fitted_round_model()
    args = (1_000_000, fit["config"]["max_depth"] + 2, 93, 256, 4, 0.0244,
            500_000)
    got = tcc.project_round_time(*args)
    assert not got["fitted"]
    assert got["fixed_round_s"] == 0.004
    assert got["per_row_s"] == (0.0244 - 0.004) / 500_000
    assert jcc.project_round_time(*args)["fitted"]
    assert tcc.fitted_round_model(8, 93, 256) is None
    assert tcc.fitted_round_model(fit["config"]["max_depth"]) is fit


# ------------------------------------------------------ launch metrics
def test_launch_series_are_the_jax_groups():
    """The ``xgbtpu_launch_*`` series of the port's reliability group:
    the JAX group's names, help texts and types (each package's
    process-wide group, read and not changed)."""
    from xgboost_tpu.obs.metrics import reliability_metrics as jax_group
    from xgboost_tpu_torch.obs.metrics import reliability_metrics

    def launch_lines(text):
        return sorted(ln for ln in text.splitlines()
                      if "xgbtpu_launch_" in ln and ln.startswith("#"))
    got = launch_lines(reliability_metrics().render())
    assert len(got) == 12
    assert got == launch_lines(jax_group().render())


def test_launch_series_scrape_through_metrics_port(tmp_path):
    """``metrics_port=`` serves the reliability group, launch series
    included, on ``/metrics``."""
    import urllib.request

    from xgboost_tpu_torch.obs import (reliability_metrics,
                                       start_metrics_server,
                                       stop_metrics_server)
    reliability_metrics().launch_restarts.inc("stall")
    srv = start_metrics_server(port=0)
    try:
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/metrics", timeout=10) as r:
            text = r.read().decode()
    finally:
        stop_metrics_server()
    for name in ("xgbtpu_launch_worker_deaths_total",
                 "xgbtpu_launch_restarts_total", "xgbtpu_launch_mesh_size",
                 "xgbtpu_launch_degraded", "xgbtpu_launch_fence_total",
                 "xgbtpu_launch_growbacks_total"):
        assert f"# TYPE {name} " in text, name
    assert 'xgbtpu_launch_restarts_total{reason="stall"}' in text
