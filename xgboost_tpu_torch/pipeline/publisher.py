"""Atomic model publication to the path the serving tier polls (port of
``xgboost_tpu/pipeline/publisher.py``, the direct lane).

The gated candidate's bytes are re-verified and ``atomic_write``-n over
the publish path: a poller sees the complete old file or the complete
new one, never a prefix.  The fleet's canary rollout lane
(``RolloutPublisher``) needs the router, which is not ported yet
(ROADMAP.md section 1 item 14).
"""

from __future__ import annotations

import hashlib

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
