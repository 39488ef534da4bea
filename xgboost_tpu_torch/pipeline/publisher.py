"""Atomic model publication to the path the serving tier polls (port of
``xgboost_tpu/pipeline/publisher.py``, both lanes).

- **direct** (:class:`Publisher`): the gated candidate's bytes are
  re-verified and ``atomic_write``-n over the publish path: a poller
  sees the complete old file or the complete new one, never a prefix.
- **rollout** (:class:`RolloutPublisher`): the candidate is staged
  beside the publish path and handed to the fleet router's canary lane
  (``POST /fleet/rollout``): canary push, soak, gate on the canaries'
  own metrics, fleet push, or rollback, which surfaces as
  :class:`PublishRejected` so the trainer quarantines the candidate.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional
from urllib.parse import urlparse

from xgboost_tpu_torch.obs import event, span
from xgboost_tpu_torch.reliability.integrity import (atomic_write,
                                                     read_file,
                                                     verify_model_bytes)


class PublishRejected(RuntimeError):
    """A rollout rejected (rolled back) the candidate; carries the
    rollout report."""

    def __init__(self, report: dict):
        super().__init__(f"rollout {report.get('status')}: "
                         f"{report.get('reason', report.get('error'))}")
        self.report = report


class Publisher:
    """Direct atomic publish to ``publish_path``."""

    def __init__(self, publish_path: str):
        self.publish_path = publish_path

    def publish(self, candidate_path: str) -> dict:
        raw = read_file(candidate_path)
        # never publish bytes that do not verify: this is the exact
        # buffer written out
        verify_model_bytes(raw, name=candidate_path)
        digest = hashlib.sha256(raw).hexdigest()
        with span("pipeline.publish", path=self.publish_path,
                  model_hash=digest, bytes=len(raw)):
            atomic_write(self.publish_path, raw)
        event("pipeline.publish", path=self.publish_path,
              model_hash=digest)
        return {"mode": "direct", "path": self.publish_path,
                "model_hash": digest}


class RolloutPublisher(Publisher):
    """Publish through the fleet router's staged canary rollout.

    The candidate is staged to a SEPARATE ``<publish_path>.staging``
    file for the router's rollout controller to read and push from —
    never to ``publish_path`` itself, which replicas may be polling
    directly (a shared-model fleet): writing ungated bytes there would
    hot-reload the whole fleet BEFORE the canary soak/gate ran.  Then
    ``POST /fleet/rollout`` runs the canary → soak → gate →
    fleet-push protocol, and only a SUCCESSFUL rollout records the
    bytes at ``publish_path`` (the next cycle's warm-start incumbent).
    ``None`` rollout knobs defer to the router's configured
    defaults."""

    def __init__(self, publish_path: str, router_url: str,
                 canaries: Optional[int] = None,
                 soak_sec: Optional[float] = None,
                 timeout: float = 600.0, model: str = ""):
        # timeout must outlive the router's soak window (the POST
        # blocks through canary push + soak + gate + fleet push); a
        # timeout mid-soak would count a succeeding rollout as a
        # publish failure and re-POST into the router's rollout lock
        super().__init__(publish_path)
        self.router_url = router_url.rstrip("/")
        self.canaries = canaries
        self.soak_sec = soak_sec
        self.timeout = timeout
        # catalog tenant: the router scopes the rollout to replicas
        # hosting this model and pushes to THEIR per-model paths
        self.model = model

    def _rollout_call(self, payload: dict) -> dict:
        import http.client
        p = urlparse(self.router_url)
        conn = http.client.HTTPConnection(p.hostname, p.port,
                                          timeout=self.timeout)
        try:
            body = json.dumps(payload).encode()
            conn.request("POST", "/fleet/rollout", body=body,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            out = r.read()
        finally:
            conn.close()
        try:
            report = json.loads(out)
        except ValueError:
            report = {"status": "error",
                      "error": out[:200].decode("utf-8", "replace")}
        report.setdefault("status", "error")
        report["http_status"] = r.status
        return report

    def publish(self, candidate_path: str) -> dict:
        raw = read_file(candidate_path)
        verify_model_bytes(raw, name=candidate_path)
        digest = hashlib.sha256(raw).hexdigest()
        stage = self.publish_path + ".staging"
        with span("pipeline.publish", path=self.publish_path,
                  model_hash=digest, lane="rollout"):
            atomic_write(stage, raw)  # router-visible, poller-invisible
            payload: dict = {"model_path": stage}
            if self.model:
                payload["model"] = self.model
            if self.canaries is not None:
                payload["canaries"] = int(self.canaries)
            if self.soak_sec is not None:
                payload["soak_sec"] = float(self.soak_sec)
            try:
                report = self._rollout_call(payload)
            finally:
                try:
                    os.unlink(stage)
                except OSError:
                    pass  # xgtpu: disable=XGT004 — best-effort cleanup
            if report.get("status") != "ok":
                event("pipeline.publish_rejected", model_hash=digest,
                      status=report.get("status"),
                      reason=report.get("reason", report.get("error")))
                raise PublishRejected(report)
            # the fleet runs it: record the bytes as the warm-start
            # incumbent only AFTER the canary gate passed
            atomic_write(self.publish_path, raw)
        event("pipeline.publish", path=self.publish_path,
              model_hash=digest, lane="rollout")
        return {"mode": "rollout", "path": self.publish_path,
                "model_hash": digest, "report": report}
