"""Per-tenant admission control at the fleet router (port of
``xgboost_tpu/catalog/quota.py``).

Two independent guards per model, both O(1) per request:

- an **in-flight cap** (``tenant_inflight``): a tenant may hold at most
  N requests inside the router at once; past it, THAT tenant sheds 503
  (retryable — capacity returns when its own responses drain);
- a **token-bucket rate limit** (``tenant_rate`` req/s with
  ``tenant_burst`` depth): sustained overload sheds 429 (the client is
  asking faster than its contract; backing off is the fix).

The point is isolation: both guards are keyed by model name, so tenant
A's overload consumes A's tokens and A's in-flight slots and nothing
else — B's requests never queue behind A's storm (asserted for both
packages by tests/test_torch_fleet.py).  Clocks are monotonic (XGT006):
token refill measures durations, not wall time.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class _TenantState:
    __slots__ = ("tokens", "last", "inflight")

    def __init__(self, burst: float):
        self.tokens = burst
        self.last = time.monotonic()
        self.inflight = 0


class TenantQuotas:
    """Per-model in-flight + rate admission.  ``try_admit`` returns
    None (admitted; pair with ``release``) or the shed reason:
    ``"rate"`` (-> 429) / ``"inflight"`` (-> 503)."""

    def __init__(self, inflight_limit: int = 0, rate: float = 0.0,
                 burst: float = 8.0):
        self.inflight_limit = int(inflight_limit)
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._state: Dict[str, _TenantState] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.inflight_limit > 0 or self.rate > 0

    def try_admit(self, model: str) -> Optional[str]:
        with self._lock:
            st = self._state.get(model)
            if st is None:
                st = self._state[model] = _TenantState(self.burst)
            if self.rate > 0:
                now = time.monotonic()
                st.tokens = min(self.burst,
                                st.tokens + (now - st.last) * self.rate)
                st.last = now
                if st.tokens < 1.0:
                    return "rate"
            if (self.inflight_limit > 0
                    and st.inflight >= self.inflight_limit):
                # checked BEFORE spending a token: an inflight-shed
                # request must not also drain the tenant's rate budget
                return "inflight"
            if self.rate > 0:
                st.tokens -= 1.0
            st.inflight += 1
            return None

    def release(self, model: str) -> None:
        with self._lock:
            st = self._state.get(model)
            if st is not None and st.inflight > 0:
                st.inflight -= 1

    def inflight(self, model: str) -> int:
        with self._lock:
            st = self._state.get(model)
            return st.inflight if st is not None else 0
