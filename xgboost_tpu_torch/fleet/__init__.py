"""xgboost_tpu_torch.fleet — replica pool + routing front door for serving
(port of ``xgboost_tpu/fleet``, the same ``__all__``).

The distributed-serving tier (SERVING.md fleet section; ROADMAP
"millions-of-users" item): where ``xgboost_tpu_torch.serving`` is ONE
process, this package is the shared-nothing FLEET of them —

- :class:`Membership` / :class:`LeaseClient`
  (:mod:`~xgboost_tpu_torch.fleet.membership`): replica registration with
  heartbeat leases and health checking — the serving-side analog of
  the reference's tracker/rendezvous tier (``tracker/rabit_tracker.py``
  assigns ranks, brokers membership, accepts ``recover`` from
  restarted workers; SURVEY.md L0);
- :class:`FleetRouter` (:mod:`~xgboost_tpu_torch.fleet.router`): one HTTP
  front door speaking the replica API — least-loaded dispatch for
  ``/predict``, consistent-hash-on-entity-id dispatch for
  ``/predict_by_id`` (feature-store residency concentrates per
  replica), per-replica circuit breakers, retry-once on a different
  healthy replica, and a global in-flight budget with 503 load
  shedding;
- :class:`RolloutController` (:mod:`~xgboost_tpu_torch.fleet.rollout`):
  staged canary model rollout driven by ModelRegistry content hashes,
  gated on the canaries' own ``/metrics``, with one-command instant
  fleet rollback.

Quickstart::

    python xgboost_tpu_torch/tools/launch_fleet.py --model m.bin --replicas 3

or by hand: ``python -m xgboost_tpu_torch task=fleet_router fleet_port=8000``
plus N replicas started with ``task=serve
serve_router_url=http://127.0.0.1:8000``.
"""

from xgboost_tpu_torch.fleet.membership import (HashRing, LeaseClient,
                                          Membership, Replica)
from xgboost_tpu_torch.fleet.router import FleetRouter, run_router
from xgboost_tpu_torch.fleet.rollout import (RolloutController,
                                       scrape_labeled_samples,
                                       scrape_samples)

__all__ = [
    "Membership",
    "Replica",
    "HashRing",
    "LeaseClient",
    "FleetRouter",
    "run_router",
    "RolloutController",
    "scrape_samples",
    "scrape_labeled_samples",
]
