"""The checkpoint ring of the command-line interface (port of
``xgboost_tpu/cli.py:890-960``), which the continuous trainer resumes
from.

The ring keeps the two newest ``ckpt-<version>.model`` files of a
directory; each is written atomically with its CRC footer, and a newest
member that fails verification is quarantined and the older one used.
The CLI tasks themselves (``train``, ``pred``, ``eval``, ``dump``, ...)
are not ported yet (ROADMAP.md section 1 item 7).
"""

from __future__ import annotations

import os
import re
import sys
import time

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
