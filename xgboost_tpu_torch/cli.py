"""The command line: ``python -m xgboost_tpu_torch <config>
[name=value ...]`` (port of ``xgboost_tpu/cli.py``).

A config file of ``name = value`` pairs plus ``name=value`` overrides,
dispatching ``task=train|pred|eval|dump|serve|pipeline|lanes`` with the JAX
package's parameter names (``num_round``, ``save_period``, ``model_in``,
``model_out``, ``model_dir``, ``eval[name]=path``, ``test:data``,
``name_pred``, ``pred_margin``, ``ntree_limit``, ``fmap``,
``name_dump``, ``dump_stats``, ``eval_train``, ``checkpoint_dir``).
Every parameter also goes to the learner, as in the reference, except
``device`` (``cuda``, the default, or ``cpu``): the task consumes it,
so a model written here has the header the JAX CLI writes for the same
config.

``checkpoint_dir`` keeps a ring of the two newest
``ckpt-<version>.model`` files, written at the end of every round
segment; each is written atomically with its CRC footer, and on restart
a newest member that fails verification is quarantined and the older
one used.  The continuous trainer resumes from the same ring.

``profile=1`` prints the round profiler's ``[prof]`` line a round and
its summary at the end of ``task=train``; ``profile=2`` also writes a
``torch.profiler`` trace of the run into ``profile_dir``
(``./xgtpu_profile`` by default), as the JAX CLI writes its
``jax.profiler`` trace.  Row and column sampling, ``num_roots`` with a
``root_index`` in a buffer and ``XGBTPU_HIST_SUBTRACTION=1`` train as in
the JAX CLI.

The JAX CLI keeps a persistent jit cache beside the ring; the port has
no counterpart: its kernels are built once by ``nvcc`` into
``xgboost_tpu_torch/_build/`` and reused by every later run.

``task=serve`` runs the HTTP prediction service
(:mod:`xgboost_tpu_torch.serving`) on ``model_in`` or a ``catalog=``
manifest, with the ``serve_*`` and catalog parameters; ``faults=`` arms
the I/O and serving fault registry (``reliability/faults.py``) before
the task runs.

``task=fleet_router`` runs the fleet's front door
(:mod:`xgboost_tpu_torch.fleet`) with the ``fleet_*`` and tenant-quota
parameters, and ``task=placer`` the catalog placement controller
(:mod:`xgboost_tpu_torch.placer`) with the ``placer_*`` ones; neither
does device work, so neither reads ``device=``.  ``metrics_port=N``
serves live ``/metrics`` and ``/healthz`` during ``task=train`` and
``task=pipeline`` (0 = ephemeral, -1 = off).

Row-split distributed training (:mod:`xgboost_tpu_torch.parallel`):
under ``XGBTPU_COORD`` / ``XGBTPU_NUM_WORKER`` / ``XGBTPU_WORKER_ID``
(``python -m xgboost_tpu_torch.parallel.launch -n N python -m
xgboost_tpu_torch <config>``, or a scheduler exporting them) the task
joins the world before any device use, ``dsplit`` defaults to ``row``,
ranks other than 0 are silenced and leave ``pred`` / ``eval`` / ``dump``
to rank 0, rank 0 alone writes models and checkpoints, and a resume is
rank 0's checkpoint broadcast to every rank.  The training text is
split-loaded per rank (``shard_load=1``, the default; ``shard_load=0``
loads it whole on every rank).  A fatal error ends the rank's process at
once, so the launcher sees it die.

Fault injection and recovery (``xgboost_tpu/cli.py:186-216, 376-406``):
``mock=[kind:][rank,]version,seqno,ntrial[;...]`` arms the collective
seam (:mod:`xgboost_tpu_torch.parallel.mock`): the rank-tagged form
fires on that rank only, three fields on every rank, ``stall:`` hangs
instead of dying; ``keepalive=1`` restarts training in process from
the checkpoint ring on a simulated death when the run is not
distributed.  Under a launcher the death ends the rank with the worker
crash code and the launcher restarts the gang.  A clean exit touches the
gang's ``done-<rank>`` marker, and a rank that has self-fenced writes no
checkpoint (``parallel/gang.py``).

Not ported, raising ``NotImplementedError`` with its ROADMAP.md section 1
item: ``stream`` (item 15).
"""

from __future__ import annotations

import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from xgboost_tpu_torch.config import (CATALOG_PARAMS, FLEET_PARAMS,
                                      LANE_PARAMS, PIPELINE_PARAMS,
                                      PLACER_PARAMS, SERVE_PARAMS,
                                      parse_config_file)

# process start, for the resume line's recovery cost
_T0 = time.perf_counter()

_USAGE = """\
Usage: python -m xgboost_tpu_torch <config> [name=value ...]

Tasks (task=...):
  train   train a model (data=..., num_round=..., model_out=...)
  pred    write predictions (model_in=..., test:data=..., name_pred=...)
  eval    print eval metrics (model_in=..., eval[name]=path)
  dump    dump trees as text (model_in=..., name_dump=...)
  serve   HTTP prediction service (model_in=...; see parameters below,
          or `python -m xgboost_tpu_torch.serving --help`): one CUDA
          graph per row bucket, hot reload, feature store, catalog
  fleet_router
          fleet front door (xgboost_tpu_torch.fleet): replicas started
          with serve_router_url=... register here; dispatch is
          least-loaded (/predict) or consistent-hash (/predict_by_id),
          with circuit breakers, load shedding, and canary rollout
          (quickstart: xgboost_tpu_torch/tools/launch_fleet.py)
  pipeline
          continuous training (xgboost_tpu_torch.pipeline): warm-start
          from the published model, append pipeline_rounds_per_cycle
          trees on fresh data, gate the candidate against the incumbent
          on a holdout, and atomically publish it
  lanes   gang-batched multi-tenant continuous training
          (xgboost_tpu_torch.pipeline.lanes): one pipeline per lanes=
          tenant, same-shape lanes stacked into one histogram launch a
          level (XGBTPU_LANE_STACK=0 for the host loop); per-lane gate
          and publish knobs ride the pipeline_* table
  stream  streaming drift-aware training -- not ported (ROADMAP.md
          item 15)
  placer  autonomous catalog placement (xgboost_tpu_torch.placer):
          watch the router's per-tenant load, bin-pack placer_catalog
          models onto in-rotation replicas within their device budgets
          (CUDA-graph pools included), and converge the fleet by
          pushing manifest deltas (elastic resizing rides
          xgboost_tpu_torch/tools/launch_fleet.py --supervise)

Device: device=cuda (the default; raises without a GPU) or device=cpu.

Observability: obs_log=PATH appends a JSONL event log;
metrics_port=N serves live /metrics + /healthz during task=train and
task=pipeline (0 = ephemeral, -1 = off).

task=serve parameters:
{serve_params}

task=fleet_router parameters:
{fleet_params}

catalog parameters (multi-model serving, task=serve + task=fleet_router):
{catalog_params}

task=placer parameters (autonomous placement + elastic fleet):
{placer_params}

Faults: faults="kind[=arg][@path][*times];..." arms the I/O and serving
fault registry (torn_write, bit_flip, enospc, slow_read, read_flip,
reload, slow_replica; XGBTPU_FAULTS in the environment does the same).
mock="[stall:][rank,]version,seqno,ntrial;..." kills (or hangs) a worker
at a round's tree launch; keepalive=1 restarts it in process from the
checkpoint ring (under python -m xgboost_tpu_torch.parallel.launch
--keepalive the launcher restarts the gang).

task=pipeline parameters:
{pipeline_params}

task=lanes parameters (gang-batched multi-tenant training):
{lane_params}
"""

# name -> (ROADMAP.md section 1 item, what it is)
_UNPORTED_TASKS = {"stream": (15, "streaming continuous training")}


class BoostLearnTask:
    """Training / prediction task state (reference BoostLearnTask,
    ``xgboost_tpu/cli.py:107``)."""

    def __init__(self):
        self.silent = 0
        self.use_buffer = 1
        self.num_round = 10
        self.save_period = 0
        self.eval_train = 0
        self.pred_margin = 0
        self.ntree_limit = 0
        self.dump_stats = 0
        self.save_base64 = 0
        self.task = "train"
        self.device = "cuda"
        self.shard_load = 1  # per-rank split loading in distributed mode
        self.rank = 0        # this process's rank under a launcher
        self._distributed = False
        self.train_path = ""
        self.test_path = ""
        self.model_in: Optional[str] = None
        self.model_out: Optional[str] = None
        self.save_final = True  # model_out=NONE skips the final save
        self.model_dir = "./"
        self.name_fmap = ""
        self.name_pred = "pred.txt"
        self.name_dump = "dump.txt"
        self.checkpoint_dir: Optional[str] = None
        self.eval_names: List[str] = []
        self.eval_paths: List[str] = []
        self.learner_params: List[Tuple[str, str]] = []
        self.pipeline_params = {k: v
                                for k, (v, _) in PIPELINE_PARAMS.items()}
        self.lane_params = {k: v for k, (v, _) in LANE_PARAMS.items()}
        self.serve_params = {k: v for k, (v, _) in SERVE_PARAMS.items()}
        self.catalog_params = {k: v for k, (v, _) in CATALOG_PARAMS.items()}
        self.fleet_params = {k: v for k, (v, _) in FLEET_PARAMS.items()}
        self.placer_params = {k: v for k, (v, _) in PLACER_PARAMS.items()}
        self.faults_spec: Optional[str] = None
        # mock= coordinates (rank, version, seqno, ntrial, kind); rank -1
        # is every rank
        self.mock_spec: List[Tuple[int, int, int, int, str]] = []
        self.keepalive = 0  # restart on a simulated death, in process

    # ------------------------------------------------------------- params
    _OWN = {
        "silent": int, "use_buffer": int, "num_round": int,
        "save_period": int, "eval_train": int, "pred_margin": int,
        "ntree_limit": int, "dump_stats": int, "save_base64": int,
        "shard_load": int,
    }

    def set_param(self, name: str, val: str) -> None:
        if name == "device":
            self.device = val   # the task's, never the learner's
            return
        if name in self._OWN:
            setattr(self, name, self._OWN[name](val))
        elif name == "task":
            self.task = val
        elif name == "data":
            self.train_path = val
        elif name == "test:data":
            self.test_path = val
        elif name == "model_in":
            self.model_in = None if val == "NULL" else val
        elif name == "model_out":
            # NULL: a numbered file; NONE: no final save
            # (reference xgboost_main.cpp:218-224)
            self.model_out = None if val in ("NULL", "NONE") else val
            self.save_final = val != "NONE"
        elif name == "model_dir":
            self.model_dir = val
        elif name == "fmap":
            self.name_fmap = "" if val == "NULL" else val
        elif name == "name_dump":
            self.name_dump = val
        elif name == "name_pred":
            self.name_pred = val
        elif name == "checkpoint_dir":
            self.checkpoint_dir = val
        elif name == "mock":
            # the reference AllreduceMock spec "rank,version,seqno,ntrial"
            # (allreduce_mock.h:57-63); three fields apply to every rank,
            # ";" separates coordinates, a "stall:" prefix hangs there
            for part in val.split(";"):
                kind = "die"
                if ":" in part:
                    k, _, part = part.partition(":")
                    kind = k.strip()
                    if kind not in ("die", "stall"):
                        raise ValueError(
                            f"mock={part!r}: unknown kind {kind!r} "
                            "(die|stall)")
                nums = [int(x) for x in part.split(",") if x.strip() != ""]
                if len(nums) == 3:
                    nums = [-1] + nums  # any rank
                if len(nums) != 4:
                    raise ValueError(
                        f"mock={part!r}: expected "
                        "[kind:][rank,]version,seqno,ntrial")
                self.mock_spec.append(tuple(nums) + (kind,))
        elif name == "keepalive":
            self.keepalive = int(val)
        elif name == "faults":
            # the I/O and serving fault registry (reliability/faults.py)
            self.faults_spec = val
        elif name in self.serve_params:
            self.serve_params[name] = type(SERVE_PARAMS[name][0])(val)
        elif name in self.catalog_params:
            self.catalog_params[name] = type(CATALOG_PARAMS[name][0])(val)
        elif name in self.fleet_params:
            self.fleet_params[name] = type(FLEET_PARAMS[name][0])(val)
        elif name in self.placer_params:
            self.placer_params[name] = type(PLACER_PARAMS[name][0])(val)
        elif name in self.pipeline_params:
            self.pipeline_params[name] = type(PIPELINE_PARAMS[name][0])(val)
        elif name in self.lane_params:
            self.lane_params[name] = type(LANE_PARAMS[name][0])(val)
        else:
            m = re.match(r"eval\[([^\]]+)\]", name)
            if m:
                self.eval_names.append(m.group(1))
                self.eval_paths.append(val)
                return
        # every parameter also cascades into the learner (reference
        # xgboost_main.cpp:95 "learner.SetParam(name, val)")
        self.learner_params.append((name, val))

    # ---------------------------------------------------------------- run
    def run(self, argv: List[str]) -> int:
        if not argv:
            from xgboost_tpu_torch.config import (catalog_params_help,
                                                  fleet_params_help,
                                                  lane_params_help,
                                                  pipeline_params_help,
                                                  placer_params_help,
                                                  serve_params_help)
            print(_USAGE.format(serve_params=serve_params_help(),
                                fleet_params=fleet_params_help(),
                                placer_params=placer_params_help(),
                                catalog_params=catalog_params_help(),
                                pipeline_params=pipeline_params_help(),
                                lane_params=lane_params_help()))
            return 0
        if os.path.exists(argv[0]) or "=" not in argv[0]:
            for name, val in parse_config_file(argv[0]):
                self.set_param(name, val)
            rest = argv[1:]
        else:
            rest = argv
        for arg in rest:
            name, eq, val = arg.partition("=")
            if eq:
                self.set_param(name, val)
        if self.model_out == "stdout" or self.name_pred == "stdout":
            self.set_param("silent", "1")
            self.save_period = 0
        if self.faults_spec:
            from xgboost_tpu_torch.reliability import faults
            faults.install_spec(self.faults_spec)
        # a rank of a launched world (parallel/launch.py or a scheduler
        # exporting XGBTPU_COORD): join it before any device use, train
        # dsplit=row, silence the other ranks, save from rank 0 only
        # (reference xgboost_main.cpp:48-50, :242-245)
        from xgboost_tpu_torch.parallel.launch import init_worker
        if self.task not in ("fleet_router", "placer"):
            self._distributed = init_worker(self.device)
        if self._distributed:
            import torch.distributed as dist
            self.rank = dist.get_rank()
            if not any(k == "dsplit" for k, _ in self.learner_params):
                self.set_param("dsplit", "row")
            if self.rank != 0:
                self.silent = max(self.silent, 2)
                if self.task != "train":
                    # pred / eval / dump are one rank's work (and
                    # concurrent writes of one output would race)
                    _leave_world()
                    return 0
            # a fatal error ends this rank at once: the other ranks wait
            # in a collective, and the launcher must see it die
            try:
                rc = self._dispatch_marked()
            except SystemExit:
                raise
            except BaseException:
                import traceback
                from xgboost_tpu_torch.reliability.rc import WORKER_CRASH_RC
                traceback.print_exc()
                sys.stderr.flush()
                os._exit(WORKER_CRASH_RC)
            _leave_world()
            return rc
        return self._dispatch_marked()

    def _dispatch_marked(self) -> int:
        """Dispatch, then touch the gang's ``done-<rank>`` marker on
        success: a re-adopting coordinator cannot ``wait()`` a worker it
        did not start (``xgboost_tpu/cli.py:339-348``)."""
        rc = self._dispatch()
        if rc == 0:
            from xgboost_tpu_torch.parallel import gang
            gang.mark_done()
        return rc

    def _setup_obs(self) -> None:
        """``obs_log=`` (or ``XGBTPU_OBS_LOG``) opens the JSONL event
        log; ``metrics_port=`` serves live ``/metrics`` + ``/healthz``
        from a daemon thread during ``task=train|pipeline``
        (``xgboost_tpu/cli.py:350-375``); rank r of a launched world
        writes ``<obs_log>.rank<r>`` and serves on ``metrics_port + r``."""
        from xgboost_tpu_torch import obs
        params = self._params_dict()
        obs_path = params.get("obs_log") or os.environ.get("XGBTPU_OBS_LOG")
        if obs_path:
            if self.rank != 0:
                obs_path = f"{obs_path}.rank{self.rank}"
            obs.configure_log(obs_path)
        port = int(params.get("metrics_port", -1))
        if port >= 0 and self.task in ("train", "pipeline"):
            # rank r serves its own collective stats on port + r
            srv = obs.start_metrics_server(
                port=port + self.rank if port > 0 else 0, rank=self.rank)
            if self.silent < 2:
                print(f"[obs] training metrics on "
                      f"http://{srv.host}:{srv.port}/metrics "
                      f"(rank {self.rank})", file=sys.stderr)

    def _dispatch(self) -> int:
        if self.task in _UNPORTED_TASKS:
            item, what = _UNPORTED_TASKS[self.task]
            raise NotImplementedError(
                f"task={self.task} ({what}) is ROADMAP.md section 1 item "
                f"{item}")
        if self.task in ("fleet_router", "placer"):
            # host-side control planes: no device, no learner
            self._setup_obs()
            return (self.task_fleet_router() if self.task == "fleet_router"
                    else self.task_placer())
        tasks = {"train": self.task_train, "pred": self.task_pred,
                 "eval": self.task_eval, "dump": self.task_dump,
                 "serve": self.task_serve,
                 "pipeline": self.task_pipeline, "lanes": self.task_lanes}
        if self.task not in tasks:
            raise ValueError(f"unknown task {self.task!r}")
        from xgboost_tpu_torch.learner import resolve_device
        self.device = resolve_device(self.device)
        self._setup_obs()
        if self.task == "train" and self.mock_spec:
            return self._train_injected()
        return tasks[self.task]()

    def _train_injected(self) -> int:
        """``task=train`` with ``mock=`` armed (``xgboost_tpu/cli.py:
        379-406``): this rank's coordinates installed at the trial
        ``XGBTPU_NUM_TRIAL``; with ``keepalive=1`` and no launcher, a
        simulated death restarts training from the checkpoint ring at the
        next trial (the ``rabit_demo.py:26-40`` keepalive loop, in
        process).  Under a launcher the death propagates and ends the
        rank, and the launcher restarts the gang."""
        from xgboost_tpu_torch.parallel import mock
        trial = int(os.environ.get("XGBTPU_NUM_TRIAL", "0"))
        mine = [spec[1:] for spec in self.mock_spec
                if spec[0] in (-1, self.rank)]
        while True:
            mock.set_fault_injection(mine, trial)
            try:
                return self.task_train()
            except mock.WorkerFailure as e:
                restart = self.keepalive and not self._distributed
                print(f"{e}; " + ("restarting" if restart else "dead"),
                      file=sys.stderr)
                if not restart:
                    raise
                trial += 1
            finally:
                mock.clear_fault_injection()

    # ------------------------------------------------------------ helpers
    def _params_dict(self) -> Dict[str, str]:
        from xgboost_tpu_torch.config import params_to_dict
        return params_to_dict(self.learner_params)

    def _load_data(self, path: str):
        from xgboost_tpu_torch.data import DMatrix
        return DMatrix(path, silent=self.silent != 0)

    def _make_booster(self, cache=()):
        from xgboost_tpu_torch.learner import Booster
        bst = Booster(self._params_dict(), cache=list(cache),
                      device=self.device)
        if self.model_in:
            bst.load_model(self.model_in)
            bst.set_param(self._params_dict())
        return bst

    def _load_train_data(self):
        """The training data: split-loaded per rank under a launcher with
        ``dsplit=row`` (``xgboost_tpu/cli.py:436-474``; the reference's
        rank / npart partition of text loads), when the data is a libsvm
        text file and every eval metric of ``eval_train`` has a partial-sum
        form; else the whole matrix on every rank.  ``shard_load=0`` opts
        out."""
        path = self.train_path
        params = self._params_dict()
        from xgboost_tpu_torch.metrics import _DIST_METRICS
        metrics = params.get("eval_metric", [])
        metrics = [metrics] if isinstance(metrics, str) else list(metrics)
        eligible = (
            self._distributed and self.shard_load
            and params.get("dsplit", "row") == "row"
            and params.get("booster", "gbtree") != "gblinear"
            and not str(params.get("objective", "")).startswith("rank:")
            and "grow_colmaker" not in str(params.get("updater", ""))
            and (not self.eval_train
                 or all(m.partition("@")[0] in _DIST_METRICS
                        for m in metrics))
            and not path.startswith(("ext:", "!")) and "#" not in path
            and path != "stdin" and os.path.exists(path)
            and _looks_like_text(path))
        if eligible:
            from xgboost_tpu_torch.parallel.sharded import ShardedDMatrix
            return ShardedDMatrix(path, silent=self.silent != 0)
        return self._load_data(path)

    def _save(self, bst, i: Optional[int] = None) -> None:
        if self.rank != 0:   # rank-0-only saves (xgboost_main.cpp:242-245)
            return
        if i is None:
            path = self.model_out
        else:
            path = os.path.join(self.model_dir, f"{i + 1:04d}.model")
        bst.save_model(path, save_base64=bool(self.save_base64))

    # -------------------------------------------------------------- train
    def _train_rounds(self, bst, data, evals, start_round: int,
                      start: float) -> None:
        """The round loop (reference TaskTrain round loop,
        ``xgboost_main.cpp:175-229``) on ``Booster.update_many``'s
        segments: eval lines and numbered saves each round or at
        ``save_period``, checkpoints at segment ends."""

        def plan_cb(k: int) -> None:
            if self.silent or not k:
                return
            n = self.num_round - start_round
            print(f"fusing rounds {start_round}..{self.num_round - 1} "
                  f"in segments of {k} ({-(-n // k)} device dispatches)",
                  file=sys.stderr)

        def round_cb(i: int) -> None:
            if not self.silent:
                print(f"boosting round {i}, "
                      f"{time.perf_counter() - start:.0f} sec elapsed",
                      file=sys.stderr)

        def eval_cb(i: int, msg: str) -> None:
            if self.silent < 2:
                print(msg, file=sys.stderr)

        def seg_cb(last_i: int) -> None:
            if self.save_period != 0 \
                    and (last_i + 1) % self.save_period == 0:
                self._save(bst, last_i)
            if self.checkpoint_dir and self.rank == 0:
                from xgboost_tpu_torch.parallel import gang
                if gang.fenced():
                    # a fenced worker never races its replacement on the
                    # ring (xgboost_tpu/cli.py:528-540); the fence exits
                    # at the round boundary, this is a second lock
                    from xgboost_tpu_torch.obs import event
                    event("ckpt.fenced_skip", version=last_i + 1)
                    return
                _save_checkpoint(self.checkpoint_dir, bst, last_i + 1)

        bst.update_many(data, start_round, self.num_round - start_round,
                        evals=evals or None, plan_callback=plan_cb,
                        round_callback=round_cb, eval_callback=eval_cb,
                        segment_callback=seg_cb,
                        boundary_align=self.save_period)

    def task_train(self) -> int:
        data = self._load_train_data()
        evals = [(self._load_data(p), n)
                 for p, n in zip(self.eval_paths, self.eval_names)]
        if self.eval_train:
            evals.append((data, "train"))
        bst = self._make_booster(cache=[data] + [d for d, _ in evals])
        start_round = 0
        if self.checkpoint_dir:
            if self.rank == 0:   # other ranks get rank 0's resume below
                bst, start_round = _load_checkpoint(
                    self.checkpoint_dir, bst, self._params_dict())
            if self._distributed:
                bst, start_round = _broadcast_checkpoint(
                    bst, start_round, self.rank, self._params_dict())
            if start_round and self.rank == 0:
                print(f"[ckpt] resume at round {start_round} "
                      f"({time.perf_counter() - _T0:.2f}s from process "
                      "start)", file=sys.stderr)
        start = time.perf_counter()
        self._train_rounds(bst, data, evals, start_round, start)
        # no final save when save_period divides num_round, even with
        # model_out set (reference xgboost_main.cpp:219-225)
        if self.save_final and (self.save_period == 0
                                or self.num_round % self.save_period != 0):
            if self.model_out is not None:
                self._save(bst)
            else:
                self._save(bst, self.num_round - 1)
        # profile=1|2: the summary, and the trace written
        from xgboost_tpu_torch.learner import finish_profile
        finish_profile(bst)
        if not self.silent:
            print(f"\nupdating end, "
                  f"{time.perf_counter() - start:.0f} sec in all",
                  file=sys.stderr)
        return 0

    # --------------------------------------------------------------- pred
    def task_pred(self) -> int:
        data = self._load_data(self.test_path)
        if not self.model_in:
            raise ValueError("model_in not specified")
        bst = self._make_booster()
        if not self.silent:
            print("start prediction...")
        preds = bst.predict(data, output_margin=self.pred_margin != 0,
                            ntree_limit=self.ntree_limit)
        if not self.silent:
            print(f"writing prediction to {self.name_pred}")
        if self.name_pred == "stdout":
            for p in preds.reshape(-1):
                sys.stdout.write(f"{p:g}\n")
        else:
            # streamed into a staged file: a killed job leaves the old
            # output or the new one, never a torn prefix
            from xgboost_tpu_torch.reliability.integrity import atomic_writer
            with atomic_writer(self.name_pred) as f:
                for p in preds.reshape(-1):
                    f.write(f"{p:g}\n".encode())
        return 0

    # --------------------------------------------------------------- eval
    def task_eval(self) -> int:
        if not self.model_in:
            raise ValueError("model_in not specified")
        evals = [(self._load_data(p), n)
                 for p, n in zip(self.eval_paths, self.eval_names)]
        bst = self._make_booster(cache=[d for d, _ in evals])
        print(bst.eval_set(evals, 0), file=sys.stderr)
        return 0

    # --------------------------------------------------------------- dump
    def task_dump(self) -> int:
        if not self.model_in:
            raise ValueError("model_in not specified")
        self._make_booster().dump_model(self.name_dump, self.name_fmap,
                                        with_stats=self.dump_stats != 0)
        return 0

    # -------------------------------------------------------------- serve
    def task_serve(self) -> int:
        """The HTTP prediction service (``xgboost_tpu/cli.py:644-680``) on
        ``model_in``, or on a ``catalog=`` manifest where bare
        ``/predict`` serves the default model and ``?model=NAME`` picks
        one, on this task's device."""
        sp = self.serve_params
        cp = self.catalog_params
        if not (self.model_in or cp["catalog"]):
            raise ValueError("model_in not specified (or pass "
                             "catalog=name=path,...)")
        from xgboost_tpu_torch.serving import run_server
        run_server(
            self.model_in or "",
            host=sp["serve_host"], port=sp["serve_port"],
            min_bucket=sp["serve_min_bucket"],
            max_bucket=sp["serve_max_bucket"],
            max_batch_rows=sp["serve_max_batch_rows"],
            max_wait_ms=sp["serve_max_wait_ms"],
            max_queue_rows=sp["serve_queue_rows"],
            poll_sec=sp["serve_poll_sec"],
            keep_versions=sp["serve_keep_versions"],
            warmup=bool(sp["serve_warmup"]),
            drain_sec=sp["serve_drain_sec"],
            max_body_mb=sp["serve_max_body_mb"],
            featurestore_mb=sp["serve_featurestore_mb"],
            catalog=cp["catalog"],
            catalog_default=cp["catalog_default"],
            catalog_mb=cp["serve_catalog_mb"],
            catalog_hysteresis_sec=cp["catalog_hysteresis_sec"],
            router_url=sp["serve_router_url"],
            replica_id=sp["serve_replica_id"],
            advertise_url=sp["serve_advertise_url"],
            quiet=self.silent != 0, block=True, device=self.device)
        return 0

    # ------------------------------------------------------- fleet_router
    def task_fleet_router(self) -> int:
        """Run the fleet routing front door (``xgboost_tpu/cli.py:681``).
        Replicas join with ``task=serve serve_router_url=http://host:port``;
        the router itself does no device work."""
        from xgboost_tpu_torch.fleet import run_router
        fp = self.fleet_params
        cp = self.catalog_params
        run_router(
            host=fp["fleet_host"], port=fp["fleet_port"],
            lease_sec=fp["fleet_lease_sec"], hc_sec=fp["fleet_hc_sec"],
            inflight_budget=fp["fleet_inflight"],
            breaker_failures=fp["fleet_breaker_failures"],
            breaker_cooldown_sec=fp["fleet_breaker_cooldown_sec"],
            retry=bool(fp["fleet_retry"]),
            forward_timeout=fp["fleet_timeout_sec"],
            max_body_mb=fp["fleet_max_body_mb"],
            deadline_ms=fp["fleet_deadline_ms"],
            slow_eject_factor=fp["fleet_slow_eject_factor"],
            slow_eject_cooldown_sec=fp["fleet_slow_eject_cooldown_sec"],
            state_path=fp["fleet_state_path"],
            tenant_inflight=cp["tenant_inflight"],
            tenant_rate=cp["tenant_rate"],
            tenant_burst=cp["tenant_burst"],
            rollout_defaults={
                "canaries": fp["fleet_canaries"],
                "soak_sec": fp["fleet_soak_sec"],
                "gate_error_rate": fp["fleet_gate_error_rate"],
                "gate_p99_ms": fp["fleet_gate_p99_ms"],
            },
            quiet=self.silent != 0, block=True)
        return 0

    # ------------------------------------------------------------- placer
    def task_placer(self) -> int:
        """Run the autonomous placement controller
        (``xgboost_tpu/cli.py:714``) against a fleet router:
        watch per-tenant load, bin-pack the ``placer_catalog`` models
        onto in-rotation replicas, push manifest deltas until the fleet
        converges.  Loops until SIGTERM/Ctrl-C."""
        from xgboost_tpu_torch.catalog import parse_manifest
        from xgboost_tpu_torch.placer import run_placer
        pp = self.placer_params
        router_url = pp["placer_router_url"]
        if not router_url:
            raise ValueError("task=placer requires placer_router_url=")
        if not pp["placer_catalog"]:
            raise ValueError("task=placer requires placer_catalog= "
                             "(name=path,... or a manifest file)")
        manifest = parse_manifest(pp["placer_catalog"])
        if self.silent < 2:
            print(f"[placer] managing {len(manifest)} tenant(s) on "
                  f"{router_url}", file=sys.stderr)
        run_placer(
            router_url, manifest,
            plan_path=pp["placer_plan_path"],
            placer_id=pp["placer_id"],
            tick_sec=pp["placer_tick_sec"],
            lease_sec=pp["placer_lease_sec"],
            replication=pp["placer_replication"],
            hot_replication=pp["placer_hot_replication"],
            hot_fraction=pp["placer_hot_fraction"],
            load_alpha=pp["placer_load_alpha"],
            block=True)
        return 0

    # ----------------------------------------------------------- pipeline
    def task_pipeline(self) -> int:
        """The continuous-training loop (``xgboost_tpu/cli.py:747``):
        train -> gate -> publish against the model file the serving
        tier polls; ``pipeline_data`` falls back to ``data=``."""
        from xgboost_tpu_torch.pipeline import run_pipeline
        pp = self.pipeline_params
        summary = run_pipeline(
            pp["pipeline_publish_path"],
            workdir=pp["pipeline_dir"],
            data=pp["pipeline_data"] or self.train_path,
            holdout=pp["pipeline_holdout"],
            rounds_per_cycle=pp["pipeline_rounds_per_cycle"],
            cycles=pp["pipeline_cycles"],
            metric=pp["pipeline_metric"],
            min_delta=pp["pipeline_min_delta"],
            max_regression=pp["pipeline_max_regression"],
            router_url=pp["pipeline_router_url"],
            publish_timeout_sec=pp["pipeline_publish_timeout_sec"],
            sleep_sec=pp["pipeline_sleep_sec"],
            params=self._params_dict(),
            quiet=self.silent != 0, device=self.device)
        if self.silent < 2:
            print(f"[pipeline] done: {summary}", file=sys.stderr)
        return 0 if summary.get("errors", 0) == 0 else 1

    # -------------------------------------------------------------- lanes
    def task_lanes(self) -> int:
        """Gang-batched multi-tenant training (``xgboost_tpu/cli.py:775``):
        one pipeline per ``lanes=`` tenant; gate and publish knobs come
        from the pipeline_* table."""
        from xgboost_tpu_torch.catalog import parse_manifest
        from xgboost_tpu_torch.pipeline import run_tenant_lanes
        lp = self.lane_params
        pp = self.pipeline_params
        if not lp["lanes"]:
            raise ValueError("task=lanes requires lanes= "
                             "(name=publish_path,... or a manifest file)")
        data = lp["lane_data"] or self.train_path
        holdout = lp["lane_holdout"]
        lanes = {}
        for name, publish_path in parse_manifest(lp["lanes"]).items():
            lanes[name] = dict(
                publish_path=publish_path,
                workdir=os.path.join(lp["lanes_dir"], name),
                data=data.replace("{lane}", name),
                holdout=holdout.replace("{lane}", name),
                rounds_per_cycle=lp["lane_rounds_per_cycle"],
                cycles=lp["lane_cycles"],
                metric=pp["pipeline_metric"],
                min_delta=pp["pipeline_min_delta"],
                max_regression=pp["pipeline_max_regression"],
                router_url=pp["pipeline_router_url"],
                publish_timeout_sec=pp["pipeline_publish_timeout_sec"],
                sleep_sec=pp["pipeline_sleep_sec"],
                params=self._params_dict())
        stacked = None if lp["lane_stack"] < 0 else bool(lp["lane_stack"])
        if self.silent < 2:
            print(f"[lanes] training {len(lanes)} tenant lane(s) "
                  f"(stacked={'auto' if stacked is None else stacked})",
                  file=sys.stderr)
        out = run_tenant_lanes(
            lanes, quiet=self.silent != 0, stacked=stacked,
            max_workers=lp["lane_max_workers"] or None,
            window_sec=lp["lane_window_ms"] / 1000.0, device=self.device)
        errors = sum(1 for v in out.values() if v.get("status") != "ok")
        if self.silent < 2:
            for name in sorted(out):
                print(f"[lanes] {name}: {out[name]}", file=sys.stderr)
        return 0 if errors == 0 else 1


def main(argv: Optional[List[str]] = None) -> int:
    task = BoostLearnTask()
    task.set_param("seed", "0")
    return task.run(list(sys.argv[1:] if argv is None else argv))


# ------------------------------------------------------------ checkpoints
_RING_MEMBER = r"ckpt-\d{6}\.model"


def _ckpt_path(ckpt_dir: str, version: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt-{version:06d}.model")


def _save_checkpoint(ckpt_dir: str, bst, version: int) -> None:
    """Write checkpoint ``version`` and keep only the two newest ring
    members; the cost goes to a ``ckpt.save`` span and the
    ``xgbtpu_training_checkpoint_*`` counters."""
    from xgboost_tpu_torch.obs import span, training_metrics
    t0 = time.perf_counter()
    with span("ckpt.save", version=version):
        os.makedirs(ckpt_dir, exist_ok=True)
        bst.save_model(_ckpt_path(ckpt_dir, version))
        kept = sorted(f for f in os.listdir(ckpt_dir)
                      if re.fullmatch(_RING_MEMBER, f))
        for stale in kept[:-2]:
            os.remove(os.path.join(ckpt_dir, stale))
    tm = training_metrics()
    tm.checkpoints.inc()
    tm.checkpoint_seconds.inc(time.perf_counter() - t0)


def _load_checkpoint(ckpt_dir: str, bst, params: dict):
    """Resume from the newest verifiable ring member: ``(booster,
    version)``, version 0 when nothing loads.  A member that fails
    verification is quarantined as ``*.corrupt`` and the older one
    tried; one that cannot be read is left in place.  The bytes are
    read once, probed on a throwaway booster on the same device, and
    only then loaded into ``bst`` (a failed load could leave it half
    changed)."""
    if not os.path.isdir(ckpt_dir):
        return bst, 0
    from xgboost_tpu_torch.learner import Booster
    from xgboost_tpu_torch.obs import event, reliability_metrics, span
    from xgboost_tpu_torch.reliability.integrity import (quarantine,
                                                         read_file,
                                                         verify_model_bytes)
    found = sorted(f for f in os.listdir(ckpt_dir)
                   if re.fullmatch(_RING_MEMBER, f))
    for name in reversed(found):
        path = os.path.join(ckpt_dir, name)
        try:
            payload = verify_model_bytes(read_file(path), name=path)
            Booster(device=bst.device).load_raw(payload, name=path)
        except OSError as e:
            print(f"[ckpt] {name} unreadable ({e}); trying the older "
                  "ring member (file left in place)", file=sys.stderr)
            continue
        except Exception as e:  # noqa: BLE001 -- any corrupt member
            try:
                q_msg = f"quarantined as {os.path.basename(quarantine(path))}"
            except OSError as qe:
                q_msg = f"quarantine failed ({qe}); left in place"
            reliability_metrics().ring_fallbacks.inc()
            event("ckpt.ring_fallback", member=name, error=str(e))
            print(f"[ckpt] {name} failed verification ({e}); {q_msg}, "
                  "falling back to the older ring member", file=sys.stderr)
            continue
        with span("ckpt.load", member=name, version=int(name[5:11])):
            bst.load_raw(payload, name=path)
            bst.set_param(params)
        return bst, int(name[5:11])
    return bst, 0


def _broadcast_checkpoint(bst, start_round: int, rank: int, params: dict):
    """Rank 0's recovered model and round on every rank
    (``xgboost_tpu/cli.py:969-988``; ``rabit::LoadCheckPoint``), so every
    rank resumes at the same round without a shared file system."""
    from xgboost_tpu_torch.parallel.mesh import data_parallel_mesh
    payload = b""
    if rank == 0:   # the round, then the model when there is one
        payload = np.int64(start_round).tobytes() + (
            bst.save_raw() if start_round > 0 else b"")
    payload = data_parallel_mesh().broadcast_bytes(payload)
    rounds = int(np.frombuffer(payload[:8], np.int64)[0])
    if rounds and rank != 0:
        bst.load_raw(payload[8:])
        bst.set_param(params)
    return bst, rounds


def _leave_world() -> None:
    """Every rank leaves the process group together: a rank that exits
    while a peer's gloo connections are still open can end that peer
    with an abort."""
    import torch.distributed as dist
    from xgboost_tpu_torch.parallel.mesh import data_parallel_mesh, set_mesh
    data_parallel_mesh().barrier()
    set_mesh(None)
    dist.destroy_process_group()


def _looks_like_text(path: str) -> bool:
    """A libsvm text file, not a binary buffer: no NUL byte in its first
    bytes and no zip magic (``xgboost_tpu/cli.py:874-882``)."""
    try:
        with open(path, "rb") as f:
            head = f.read(256)
    except OSError:
        return False
    return bool(head) and b"\x00" not in head and not head.startswith(b"PK")


if __name__ == "__main__":
    sys.exit(main())
