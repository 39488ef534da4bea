"""Process exit-code registry (port of ``xgboost_tpu/reliability/rc.py``,
the same codes; RELIABILITY.md; lint rule XGT016).

Every deliberate non-zero exit code in the tree is defined HERE, once,
and referenced symbolically everywhere else.  The elastic-recovery
machinery (parallel/launch.py, parallel/gang.py) keys restart-vs-fence
decisions off worker return codes, and the chaos drivers grep logs for
them — a magic ``143`` living in three files is exactly the kind of
protocol constant that drifts silently.  xgtpu-lint XGT016 enforces the
discipline: ``*_RC`` constants defined outside this module, int
literals matching a registered code in exit/returncode contexts, and
``sys.exit``/``os._exit`` with bare literals are all findings, and the
registry is committed as the ``exit_codes`` section of
ANALYSIS_CONTRACTS.json so a new code lands as a reviewed diff.

The 142-145 band is chosen above the shell's 128+signal range for
common signals and below 255; 41/43 predate the band (chaos-kill
codes baked into CHAOS cell log scanners) and are kept stable.
"""

from __future__ import annotations

#: a chaos-dispatch worker died on an unexpected exception (cli.py
#: wraps the dispatch and converts any crash into this code so the
#: coordinator's restart accounting sees one value, not a traceback).
WORKER_CRASH_RC = 41

#: a serving replica was chaos-killed via the fleet ``replica_kill``
#: fault (fleet/membership.py ``on_kill``; reliability/faults.py).
REPLICA_KILL_RC = 43

#: the coordinator declared a heartbeat stall and tore the gang down
#: (parallel/launch.py watchdog).
STALL_RC = 142

#: a worker fenced itself: it saw a coordinator generation newer than
#: its own and died before touching shared state (parallel/gang.py).
FENCE_RC = 143

#: a worker's host (or its heartbeat lease) was declared lost —
#: permanent, not restartable in place (parallel/gang.py).
HOST_LOSS_RC = 144

#: a standby coordinator fenced the incumbent: the incumbent exits
#: with this code without touching the workers (parallel/launch.py).
COORD_FENCED_RC = 145


def registry() -> dict:
    """``{name: value}`` for every registered code, sorted by value —
    the committed ``exit_codes`` inventory section is exactly this."""
    out = {name: value for name, value in globals().items()
           if name.endswith("_RC") and isinstance(value, int)}
    return dict(sorted(out.items(), key=lambda kv: kv[1]))
