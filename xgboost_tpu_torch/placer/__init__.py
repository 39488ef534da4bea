"""xgboost_tpu_torch.placer — autonomous catalog placement + elastic fleet
(port of ``xgboost_tpu/placer``).

The serving-side control plane (SERVING.md "Autonomous placement";
ROADMAP "Autonomous placement + elastic fleet"): where the fleet
(xgboost_tpu_torch.fleet) serves whatever manifests operators hand-wrote,
this package DECIDES — two cooperating loops that close the gap
between "a catalog of N models" and hands-off operation:

- :class:`PlacementController` (:mod:`~xgboost_tpu_torch.placer.controller`):
  consumes the router's observed per-tenant load (``xgbtpu_tenant_*``
  counters), the per-replica device budgets advertised in heartbeats,
  and the membership table; computes a target assignment of
  models->replicas (greedy bin-pack, replication floor raised for hot
  tenants, :class:`~xgboost_tpu_torch.fleet.membership.HashRing` anchoring so
  a rebalance moves only the tenants that must move); converges the
  fleet by pushing manifest deltas (``POST /-/catalog`` +
  ``/-/reload``) to replica admin surfaces.  The target plan is
  CRC-snapshotted so a SIGKILL'd placer resumes its last plan, and a
  router-side single-holder lease keeps standby placers from fighting.
- :class:`ElasticSupervisor` (:mod:`~xgboost_tpu_torch.placer.elastic`):
  holds fleet utilization (in-flight / slots EWMA) inside a target
  band by spawning/draining replica processes through a launcher
  (``xgboost_tpu_torch/tools/launch_fleet.py --supervise``); drains
  deregister at drain start so no request is lost, and an in-flight rollout pins the
  fleet size so a resize mid-soak cannot invalidate the canary gate.

Quickstart::

    python -m xgboost_tpu_torch task=placer \
        placer_router_url=http://127.0.0.1:8000 \
        placer_catalog='a=ma.bin,b=mb.bin'

or, elastic fleet + placement in one command::

    python xgboost_tpu_torch/tools/launch_fleet.py --model m.bin \
        --replicas 2 --supervise
"""

from xgboost_tpu_torch.placer.controller import (PlacementController,
                                                run_placer)
from xgboost_tpu_torch.placer.elastic import ElasticSupervisor

__all__ = [
    "PlacementController",
    "ElasticSupervisor",
    "run_placer",
]
