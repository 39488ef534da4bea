"""ContinuousTrainer: the train → gate → publish cycle loop (port of
``xgboost_tpu/pipeline/trainer.py``).

One cycle (PIPELINE.md has the full state machine and failure matrix):

1. **warm-start** — load the incumbent from the publish path through
   the CRC-verified load path (``Booster.load_model``); cold start
   trains from scratch when nothing is published yet.
2. **train** — append ``rounds_per_cycle`` boosting rounds on the
   cycle's fresh data (the :class:`~.datasource.DataSource` seam)
   through the segmented round loop (``Booster.update_many``:
   ``rounds_per_dispatch`` rounds per segment), checkpointing
   at every segment boundary into the same two-member checkpoint ring
   the CLI uses — a SIGKILL mid-train (even mid-SEGMENT) resumes from
   the ring and, because the data source is deterministic per cycle
   and seeding is per-iteration, finishes bit-identical to an
   uninterrupted cycle.
3. **gate** — verify the candidate file's CRC, then score candidate vs
   incumbent on the held-out window (:class:`~.gate.EvalGate`).  A
   failing (or corrupt) candidate is quarantined and the incumbent
   keeps serving untouched.
4. **publish** — append the candidate's hash to the ``gated.log``
   ledger (fsync'd BEFORE any byte reaches the publish path — the
   chaos harness proves "no unverified/ungated model is ever served"
   against this ledger), then hand the candidate to the
   :class:`~.publisher.Publisher` (direct atomic swap).

Crash discipline: every persisted artifact is atomic (state file,
candidate, publish) or append-only (ledger), and the recorded phase is
re-entered conservatively on restart — a process that died anywhere
past training **re-gates** the candidate from its bytes rather than
trusting a pre-crash verdict.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
import time
from typing import Optional

from xgboost_tpu_torch.obs import event, span
from xgboost_tpu_torch.obs.metrics import pipeline_metrics
from xgboost_tpu_torch.pipeline.datasource import DataSource
from xgboost_tpu_torch.pipeline.gate import EvalGate
from xgboost_tpu_torch.pipeline.publisher import Publisher, PublishRejected

_STATE_FILE = "state.json"
_CANDIDATE = "candidate.model"
_GATED_LOG = "gated.log"


class ContinuousTrainer:
    """Owns one publish path: warm-starts from it, appends trees on
    fresh data, and republishes through the gate."""

    def __init__(self, publish_path: str, source: DataSource,
                 workdir: str, rounds_per_cycle: int = 5,
                 params: Optional[dict] = None,
                 gate: Optional[EvalGate] = None,
                 publisher: Optional[Publisher] = None,
                 quiet: bool = False, lane: str = "", device=None):
        self.publish_path = publish_path
        self.source = source
        self.workdir = workdir
        self.rounds_per_cycle = int(rounds_per_cycle)
        self.params = dict(params or {})
        # tenant lane name: tags every pipeline event/log line so N
        # concurrent per-model lanes stay attributable in one stream
        self.lane = lane
        self.gate = gate if gate is not None else EvalGate()
        self.publisher = (publisher if publisher is not None
                          else Publisher(publish_path))
        self.quiet = quiet
        # every booster of this trainer lives here ("cuda" by default)
        from xgboost_tpu_torch.learner import resolve_device
        self.device = resolve_device(device)
        self.ckpt_dir = os.path.join(workdir, "ckpt")
        self.candidate_path = os.path.join(workdir, _CANDIDATE)
        self.quarantine_dir = os.path.join(workdir, "quarantine")
        self.state_path = os.path.join(workdir, _STATE_FILE)
        self.gated_log = os.path.join(workdir, _GATED_LOG)
        # verified copy of the last published bytes: the incumbent's
        # ring replica (bit rot on the publish path restores from here)
        self.backup_path = os.path.join(workdir, "incumbent.model")
        self.metrics = pipeline_metrics()
        os.makedirs(workdir, exist_ok=True)

    # --------------------------------------------------------------- state
    def _read_state(self) -> dict:
        """The persisted cycle cursor.  Unreadable/missing state resets
        to a fresh cycle-0 train — the artifacts themselves (candidate
        CRC, ring verification, ledger) carry the safety, the state
        file only carries the cursor."""
        try:
            with open(self.state_path, encoding="utf-8") as f:
                st = json.load(f)
            return st if isinstance(st, dict) else {}
        except (OSError, ValueError):
            return {}

    def _write_state(self, st: dict) -> None:
        from xgboost_tpu_torch.reliability.integrity import atomic_write
        atomic_write(self.state_path,
                     (json.dumps(st, sort_keys=True) + "\n").encode())

    def _event(self, name: str, **kw) -> None:
        if self.lane:
            kw.setdefault("lane", self.lane)
        event(name, **kw)

    def _say(self, msg: str) -> None:
        if not self.quiet:
            tag = f"pipeline:{self.lane}" if self.lane else "pipeline"
            print(f"[{tag}] {msg}", file=sys.stderr)

    def _data(self, cycle: int):
        """Memoized per-cycle (dtrain, dholdout): the gate runs in the
        same process right after training, and re-parsing the cycle's
        files for it would double the ingest cost."""
        memo = getattr(self, "_data_memo", None)
        if memo is not None and memo[0] == cycle:
            return memo[1]
        data = self.source.next_cycle(cycle)
        self._data_memo = (cycle, data) if data is not None else None
        return data

    # ---------------------------------------------------------------- ring
    def _clear_ring(self) -> None:
        if not os.path.isdir(self.ckpt_dir):
            return
        for name in os.listdir(self.ckpt_dir):
            if re.fullmatch(r"ckpt-\d{6}\.model(\.corrupt\d*)?", name):
                try:
                    os.remove(os.path.join(self.ckpt_dir, name))
                except OSError:
                    pass  # best-effort cleanup

    # --------------------------------------------------------------- train
    def _load_incumbent(self):
        """The currently-published model, or None on cold start.

        A publish-path file that fails its CRC (bit rot, external
        tamper — never a torn publish, those are atomic) is healed from
        the incumbent ring replica (``incumbent.model``, the verified
        bytes of our last publish): the corrupt file is quarantined and
        the backup atomically restored, so pollers and replica restarts
        come back on a gated model.  With no restorable backup the
        cycle ABORTS (never silently train from scratch and publish
        OVER a lineage we merely failed to read)."""
        if not os.path.exists(self.publish_path):
            return None
        from xgboost_tpu_torch.learner import Booster
        from xgboost_tpu_torch.reliability.integrity import ModelIntegrityError
        bst = Booster(dict(self.params), device=self.device)
        try:
            bst.load_model(self.publish_path)  # CRC-verified
        except ModelIntegrityError as e:
            self._restore_incumbent(e)
            bst = Booster(dict(self.params), device=self.device)
            bst.load_model(self.publish_path)
        bst.set_param(dict(self.params))
        return bst

    def _restore_incumbent(self, cause: Exception) -> None:
        """Quarantine the corrupt publish-path file and restore the
        last published (verified, gated) bytes from the backup."""
        from xgboost_tpu_torch.reliability.integrity import (
            atomic_write, quarantine, read_file, verify_model_bytes)
        raw = read_file(self.backup_path)  # OSError -> cycle aborts
        verify_model_bytes(raw, name=self.backup_path)
        try:
            qpath = quarantine(self.publish_path)
        except OSError:
            qpath = None  # the restore still heals
        atomic_write(self.publish_path, raw)
        self._event("pipeline.incumbent_restored", path=self.publish_path,
              quarantined_as=qpath, cause=str(cause))
        self._say(f"publish path failed verification ({cause}); "
                  "restored the last published model from the backup")

    def _prepare_booster(self, bst, cycle: int) -> None:
        """Per-cycle booster hook, run after any ring resume and before
        the first boosted round.  The base trainer does nothing; the
        stream trainer reapplies drift state (cut rebinds, EMA-FS
        feature screens) that model bytes alone do not carry."""

    def _boost_rounds(self, bst, dtrain, it0: int, n_rounds: int,
                      segment_callback) -> None:
        """The cycle's boosting call — the one seam the gang-batched
        lane dispatcher (pipeline/lanes.py) overrides to route rounds
        through a shared multi-tenant dispatch instead of this
        booster's own ``update_many``.  Everything around it (resume,
        gate, publish, ledger) stays per-tenant and host-side."""
        bst.update_many(dtrain, it0, n_rounds,
                        segment_callback=segment_callback)

    def _train(self, cycle: int, st: dict) -> Optional[str]:
        """Train the cycle's candidate; returns its path, or None when
        the source has no fresh data yet."""
        data = self._data(cycle)
        if data is None:
            return None
        dtrain, _ = data
        resuming = (st.get("phase") == "train"
                    and st.get("cycle") == cycle
                    and os.path.isdir(self.ckpt_dir))
        if not resuming:
            self._clear_ring()
            self._write_state({"cycle": cycle, "phase": "train"})
        from xgboost_tpu_torch.cli import _load_checkpoint, _save_checkpoint
        from xgboost_tpu_torch.learner import Booster
        bst = self._load_incumbent()
        if bst is None:
            bst = Booster(dict(self.params), device=self.device)
        appended = 0
        if resuming:
            # mid-train SIGKILL: the ring holds the incumbent + the
            # rounds appended so far; a corrupt newest member falls
            # back to the older replica (cli._load_checkpoint)
            bst, appended = _load_checkpoint(self.ckpt_dir, bst,
                                             dict(self.params))
            if appended:
                self.metrics.resumes.inc()
                self._event("pipeline.resume", cycle=cycle, phase="train",
                      appended_rounds=appended)
                self._say(f"cycle {cycle}: resumed mid-train at "
                          f"appended round {appended}")
        # after the ring resume: ring bytes already carry any refreshed
        # cuts, but per-cycle state that is NOT serialized in model
        # bytes (e.g. the stream trainer's feature screen) must be
        # re-applied here, on fresh runs and resumes alike
        self._prepare_booster(bst, cycle)
        with span("pipeline.train", cycle=cycle, resumed=appended):
            if appended < self.rounds_per_cycle:
                # iteration index continues the incumbent's numbering,
                # so per-iteration seeding (fold_in) matches what one
                # long uninterrupted training run would have used
                it0 = (bst.gbtree.num_boosted_rounds
                       if bst.gbtree is not None else 0)
                base = it0 - appended  # the incumbent's own rounds

                def seg_cb(last_i: int) -> None:
                    # ring checkpoint at every segment boundary
                    # (per round when fusion is ineligible): a SIGKILL
                    # inside a segment resumes from the last boundary
                    # member and — deterministic per-iteration seeding —
                    # retrains the lost tail bit-identically
                    _save_checkpoint(self.ckpt_dir, bst,
                                     last_i + 1 - base)

                self._boost_rounds(bst, dtrain, it0,
                                   self.rounds_per_cycle - appended,
                                   seg_cb)
            bst.save_model(self.candidate_path)  # atomic + CRC
        self._write_state({"cycle": cycle, "phase": "gate"})
        return self.candidate_path

    # ---------------------------------------------------------------- gate
    def _judge(self, cycle: int) -> dict:
        """Verify + score the candidate file against the incumbent.
        Returns the verdict dict (``passed`` False for corrupt or
        gate-failing candidates)."""
        from xgboost_tpu_torch.learner import Booster
        from xgboost_tpu_torch.reliability.integrity import (
            read_file, verify_model_bytes)
        # the gate needs ONLY the holdout: a crash-recovery re-gate
        # must not wedge because the producer rotated the cycle's
        # train file away between the kill and the restart
        memo = getattr(self, "_data_memo", None)
        if memo is not None and memo[0] == cycle:
            holdout = memo[1][1]
        else:
            holdout = self.source.holdout_for(cycle)
        if holdout is None:
            raise RuntimeError(
                f"cycle {cycle}: holdout unavailable for the gate")
        with span("pipeline.gate", cycle=cycle):
            try:
                raw = read_file(self.candidate_path)
                cand = Booster(device=self.device)
                cand.load_raw(verify_model_bytes(raw,
                                                 name=self.candidate_path),
                              name=self.candidate_path)
            except (OSError, ValueError) as e:
                # ValueError covers ModelIntegrityError: a candidate
                # corrupted between save and gate never publishes
                return {"passed": False, "verified": False,
                        "reason": f"candidate failed verification: {e}"}
            verdict = self._judge_vs_incumbent(cand, holdout, cycle)
            verdict["verified"] = True
            verdict["model_hash"] = hashlib.sha256(raw).hexdigest()
        self._event("pipeline.gate", cycle=cycle, passed=verdict["passed"],
              metric=verdict.get("metric"),
              candidate=verdict.get("candidate"),
              incumbent=verdict.get("incumbent"),
              reason=verdict.get("reason"))
        return verdict

    def _publish_hash(self) -> Optional[str]:
        try:
            with open(self.publish_path, "rb") as f:
                return hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return None

    def _judge_vs_incumbent(self, cand, holdout, cycle: int) -> dict:
        """Run the gate, reusing the cached incumbent holdout score
        when the published bytes, the holdout object, and the gate are
        all unchanged — the incumbent's score can only move when a
        publish (or a bit-rot restore) lands, so steady-state cycles
        skip one full model load + one full holdout evaluation."""
        inc_hash = self._publish_hash()
        cache = getattr(self, "_incumbent_cache", None)
        gate_key = (id(self.gate), self.gate.metric)
        if (inc_hash is not None and cache is not None
                and cache["hash"] == inc_hash
                and cache["holdout_id"] == id(holdout)
                and cache["gate_key"] == gate_key):
            verdict = self.gate.judge(cand, None, holdout, cycle,
                                      incumbent_score=cache["score"])
            inc_trees = cache["num_trees"]
        else:
            incumbent = (self._load_incumbent()
                         if inc_hash is not None else None)
            verdict = self.gate.judge(cand, incumbent, holdout, cycle)
            inc_trees = (incumbent.gbtree.num_trees
                         if incumbent is not None
                         and incumbent.gbtree is not None else 0)
            if incumbent is not None and verdict.get(
                    "incumbent") is not None:
                # re-hash AFTER the load: _load_incumbent may have
                # healed a corrupt publish path from the backup
                self._incumbent_cache = {
                    "hash": self._publish_hash(),
                    "holdout_id": id(holdout), "gate_key": gate_key,
                    "score": verdict["incumbent"],
                    "num_trees": inc_trees}
        verdict["new_trees"] = cand.gbtree.num_trees - inc_trees
        return verdict

    def _quarantine(self, cycle: int, verdict: dict) -> None:
        """Move the rejected candidate aside (numbered, never clobbers
        an earlier cycle's evidence) so the publish path can never pick
        it up and a post-mortem can inspect it."""
        if not os.path.exists(self.candidate_path):
            return
        os.makedirs(self.quarantine_dir, exist_ok=True)
        dest = os.path.join(self.quarantine_dir,
                            f"cycle-{cycle:04d}.model")
        i = 1
        while os.path.exists(dest):
            dest = os.path.join(self.quarantine_dir,
                                f"cycle-{cycle:04d}.model.{i}")
            i += 1
        os.replace(self.candidate_path, dest)
        self.metrics.quarantines.inc()
        self._event("pipeline.quarantine", cycle=cycle, quarantined_as=dest,
              reason=verdict.get("reason"))
        self._say(f"cycle {cycle}: candidate quarantined as {dest} "
                  f"({verdict.get('reason')})")

    def _record_gated(self, cycle: int, model_hash: str) -> None:
        """Append the approved hash to the gated ledger, durably,
        BEFORE any publish byte moves: every hash that can ever appear
        at the publish path is in this file first (the chaos harness'
        zero-ungated-models contract reads it).  Append-only by design
        — a crash tears at most the final line."""
        with open(self.gated_log, "ab") as f:
            f.write(f"{cycle} {model_hash}\n".encode())
            f.flush()
            os.fsync(f.fileno())

    # ------------------------------------------------------------- publish
    def _refresh_backup(self) -> None:
        """Incumbent ring replica: the just-published candidate bytes,
        kept in the workdir so later publish-path bit rot is
        recoverable.  Best-effort — the publish itself already
        succeeded; a failed backup only costs future healing."""
        from xgboost_tpu_torch.reliability.integrity import (atomic_write,
                                                             read_file)
        try:
            atomic_write(self.backup_path,
                         read_file(self.candidate_path))
        except OSError as e:
            from xgboost_tpu_torch.obs.metrics import swallowed_error
            swallowed_error("pipeline.backup", e)

    def _publish(self, cycle: int, verdict: dict) -> dict:
        pm = self.metrics
        t0 = time.perf_counter()
        try:
            pub = self.publisher.publish(self.candidate_path)
        except PublishRejected:
            pm.publish_failures.inc()
            raise
        except (OSError, ValueError):
            # I/O failure (ENOSPC, fault injection) or bytes that no
            # longer verify: the publish path still holds the complete
            # incumbent (atomic_write); the phase stays "publish" and
            # the next attempt re-gates + retries
            pm.publish_failures.inc()
            raise
        pm.publishes.inc()
        pm.publish_seconds.inc(time.perf_counter() - t0)
        pm.trees_published.inc(max(0, int(verdict.get("new_trees", 0))))
        pm.note_publish()
        self._refresh_backup()
        return pub

    def _already_published(self) -> Optional[str]:
        """The candidate's verified bytes already sit at the publish
        path → its hash (the publish completed; only the epilogue was
        lost); else None.  Membership in the gated ledger is implied —
        publishing is unreachable before :meth:`_record_gated`."""
        from xgboost_tpu_torch.reliability.integrity import (
            ModelIntegrityError, verify_model_bytes)
        try:
            with open(self.candidate_path, "rb") as f:
                cand = f.read()
            with open(self.publish_path, "rb") as f:
                pub = f.read()
        except OSError:
            return None
        if cand != pub:
            return None
        try:
            verify_model_bytes(cand, name=self.candidate_path)
        except ModelIntegrityError:
            return None  # let the re-gate quarantine it
        return hashlib.sha256(cand).hexdigest()

    def _finalize_published(self, cycle: int, model_hash: str) -> None:
        """Lost epilogue of a completed publish: refresh the incumbent
        ring replica (the crash may also have landed between the
        publish and the backup write, which would leave a later
        bit-rot heal restoring a one-generation-stale model) and
        re-stamp the metrics the dead process took with it."""
        self._refresh_backup()
        self.metrics.note_publish()
        self._event("pipeline.publish", path=self.publish_path,
              model_hash=model_hash, resumed=True)

    # --------------------------------------------------------------- cycle
    def run_cycle(self) -> dict:
        """One full cycle from whatever phase the persisted state is in
        (a fresh train, or crash recovery: mid-train ring resume /
        re-gate of an already-trained candidate).  Returns an outcome
        dict with ``status`` in ``published | gate_failed |
        publish_rejected | idle``."""
        pm = self.metrics
        st = self._read_state()
        cycle = int(st.get("cycle", 0))
        phase = st.get("phase", "train")
        t0 = time.perf_counter()
        try:
            with span("pipeline.cycle", cycle=cycle, start_phase=phase):
                if phase == "train" or not os.path.exists(
                        self.candidate_path):
                    if self._train(cycle, st) is None:
                        return {"cycle": cycle, "status": "idle"}
                else:
                    # died past training: RE-GATE the candidate from its
                    # bytes — a pre-crash verdict is not trusted
                    pm.resumes.inc()
                    self._event("pipeline.resume", cycle=cycle, phase=phase)
                    done_hash = self._already_published()
                    if done_hash is not None:
                        # the crash landed BETWEEN a completed publish
                        # and the cursor advance: the candidate IS the
                        # incumbent now.  Finalize instead of re-gating
                        # it against itself — with min_delta > 0 the
                        # zero self-improvement would quarantine the
                        # live, already-serving model
                        self._finalize_published(cycle, done_hash)
                        self._advance(cycle)
                        self._say(f"cycle {cycle}: publish had already "
                                  "completed before the crash; finalized")
                        return {"cycle": cycle, "status": "published",
                                "resumed": True,
                                "publish": {"mode": "resumed",
                                            "path": self.publish_path,
                                            "model_hash": done_hash}}
                    self._say(f"cycle {cycle}: resumed at phase "
                              f"{phase!r}; re-gating candidate")
                verdict = self._judge(cycle)
                if not verdict["passed"]:
                    pm.gate_fail.inc()
                    self._quarantine(cycle, verdict)
                    self._advance(cycle)
                    return {"cycle": cycle, "status": "gate_failed",
                            "gate": verdict}
                pm.gate_pass.inc()
                self._record_gated(cycle, verdict["model_hash"])
                self._write_state({"cycle": cycle, "phase": "publish"})
                try:
                    pub = self._publish(cycle, verdict)
                except PublishRejected as e:
                    # a rollout vetoed it: quarantine like
                    # a local gate failure (the router already rolled
                    # the canaries back)
                    why = e.report.get("reason", e.report.get("error"))
                    self._quarantine(cycle, {
                        "reason": f"rollout rejected: {why}"})
                    self._advance(cycle)
                    return {"cycle": cycle, "status": "publish_rejected",
                            "gate": verdict, "report": e.report}
                self._advance(cycle)
                self._say(f"cycle {cycle}: published "
                          f"{verdict['new_trees']} new trees "
                          f"({verdict.get('metric')} "
                          f"{verdict.get('candidate')})")
                return {"cycle": cycle, "status": "published",
                        "gate": verdict, "publish": pub}
        finally:
            pm.cycles.inc()
            pm.cycle_seconds.observe(time.perf_counter() - t0)

    def _advance(self, cycle: int) -> None:
        """Cycle epilogue: drop the ring (its members belong to the
        finished cycle) and move the cursor."""
        self._clear_ring()
        try:
            if os.path.exists(self.candidate_path):
                os.remove(self.candidate_path)
        except OSError:
            pass  # best-effort cleanup
        self._write_state({"cycle": cycle + 1, "phase": "train"})

    # ----------------------------------------------------------------- run
    def run(self, cycles: int = 0, sleep_sec: float = 0.0) -> dict:
        """Drive ``cycles`` cycles (0 = forever).  Per-cycle exceptions
        are contained: the error is logged + counted and the loop
        continues — the persisted phase means the next attempt resumes
        (or re-gates) instead of redoing finished work."""
        summary = {"cycles": 0, "published": 0, "gate_failed": 0,
                   "publish_rejected": 0, "idle": 0, "errors": 0}
        while cycles <= 0 or summary["cycles"] < cycles:
            summary["cycles"] += 1
            try:
                out = self.run_cycle()
            except Exception as e:
                summary["errors"] += 1
                self._event("pipeline.cycle_error",
                      error=f"{type(e).__name__}: {e}")
                self._say(f"cycle error ({type(e).__name__}: {e}); "
                          "will retry from the persisted phase")
                out = {"status": "error"}
            else:
                summary[out["status"]] = summary.get(out["status"], 0) + 1
            if out.get("status") in ("idle", "error"):
                time.sleep(max(sleep_sec, 0.05))
            elif sleep_sec > 0:
                time.sleep(sleep_sec)
        return summary
