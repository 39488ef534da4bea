"""The cost of distributed training's collectives (port of
``xgboost_tpu/parallel/commcost.py``).

Row-split tree growth reduces one level histogram a level, the role of
the reference's ``histred.Allreduce`` (``updater_histmaker-inl.hpp:
343-346``): ``n_node x F x B`` (G, H) pairs.  This module puts numbers
on it:

- :func:`hist_psum_bytes`: the analytic payload a level;
- :func:`hlo_collectives`: the collectives of an XLA HLO text with their
  payload bytes (the JAX package's compiled programs; kept so that the
  two packages read the same dumps the same way);
- :func:`project_round_time`: a compute plus communication model of a
  round on k devices, from the fit in ``ROUND_MODEL.json`` when that fit
  was made at the asked configuration.

One deliberate difference: the JAX :func:`project_round_time` takes the
file's fit for any configuration.  Here the fit is used only when its
``config`` holds the call's ``(max_depth, n_feat, n_bin)``; otherwise
``fitted`` is False and the anchor-derived defaults apply.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
                "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "f32": 4,
                "s64": 8, "u64": 8, "f64": 8}

# one collective op; shapes like f32[32,28,64,2].  The result type is
# everything between '=' and the opcode token, which '(' follows: the
# paren keeps operand names such as '%all-reduce.3' from matching as the
# opcode, and the strict result-type group keeps operand shapes out of
# the payload
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COLL_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.-]+\s*=\s*"
    r"((?:\([^)]*\))|(?:[a-z0-9]+\[[0-9,]*\](?:\{[0-9,]*\})?))\s+"
    r"(all-reduce|all-gather|reduce-scatter|collective-permute)"
    r"(-start)?\(")


def _one_shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 0)


def hlo_collectives(hlo_text: str) -> List[Tuple[str, str, int]]:
    """``[(op, shape, payload_bytes)]`` for every collective of an HLO
    text.  An async ``-start`` tuple holds (operand alias, produced
    buffer[, u32[] context scalars]): the scalars are dropped and the
    payload is the largest element left, the smallest for
    reduce-scatter (its result is 1/n of the operand); ``-done`` ops
    carry none."""
    out = []
    for line in hlo_text.splitlines():
        m = _COLL_RE.match(line)
        if not m:
            continue
        shapes, op, start = m.group(1), m.group(2), m.group(3)
        parsed = _SHAPE_RE.findall(shapes)
        if not parsed:
            continue
        sizes = [_one_shape_bytes(t, d) for t, d in parsed]
        if start and shapes.startswith("("):
            real = [s for s in sizes if s > 8] or sizes
            payload = min(real) if op == "reduce-scatter" else max(real)
        else:
            payload = sum(sizes)
        out.append((op, shapes.strip(), payload))
    return out


def hist_psum_bytes(max_depth: int, n_feat: int, n_bin: int,
                    stat_bytes: int = 8) -> Dict[int, int]:
    """The analytic payload of each non-terminal level d =
    0..max_depth-1: ``2**d * F * B * stat_bytes`` (the (G, H) f32 pair
    is 8 bytes)."""
    return {d: (1 << d) * n_feat * n_bin * stat_bytes
            for d in range(max_depth)}


_ROUND_MODEL_CACHE: Optional[tuple] = None  # (mtime_ns or None, model)


def _round_model_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "ROUND_MODEL.json")


def fitted_round_model(max_depth: Optional[int] = None,
                       n_feat: Optional[int] = None,
                       n_bin: Optional[int] = None) -> Optional[dict]:
    """The fit of ``ROUND_MODEL.json`` (``fixed_round_s``, the
    per-round intercept, and ``per_row_s``, the slope), or None when
    there is none or it cannot be read.  Given ``max_depth``,
    ``n_feat`` and ``n_bin``, None also when the fit's ``config`` was
    made at another configuration.  Cached by the file's mtime."""
    global _ROUND_MODEL_CACHE
    path = _round_model_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    if _ROUND_MODEL_CACHE is None or _ROUND_MODEL_CACHE[0] != mtime:
        model = None
        if mtime is not None:
            try:
                with open(path) as f:
                    m = json.load(f)
                float(m["fixed_round_s"]), float(m["per_row_s"])
                model = m
            except (OSError, ValueError, KeyError, TypeError) as e:
                # a torn or hand-edited fit falls back to the anchor
                from xgboost_tpu_torch.obs.metrics import swallowed_error
                swallowed_error("parallel.commcost.round_model", e)
        _ROUND_MODEL_CACHE = (mtime, model)
    model = _ROUND_MODEL_CACHE[1]
    if model is None:
        return None
    want = {"max_depth": max_depth, "n_feat": n_feat, "n_bin": n_bin}
    config = model.get("config") or {}
    if any(v is not None and config.get(k) != v for k, v in want.items()):
        return None
    return model


def project_round_time(rows: int, max_depth: int, n_feat: int,
                       n_bin: int, n_chips: int,
                       single_chip_round_s: float,
                       single_chip_rows: int,
                       ici_allreduce_bw: float = 1e11,
                       fixed_round_s: Optional[float] = None,
                       per_row_s: Optional[float] = None
                       ) -> Dict[str, float]:
    """A round's projected time on ``n_chips`` devices: compute =
    ``fixed + per_row * rows / n_chips``, plus a ring allreduce of each
    level's histogram, ``2 * bytes * (k - 1) / k / bw``, not overlapped
    with compute.  ``fixed_round_s`` / ``per_row_s`` default to the fit
    of ``ROUND_MODEL.json`` made at this ``(max_depth, n_feat, n_bin)``;
    without one, the intercept is 4 ms and the slope comes from the
    caller's single-device anchor ``(single_chip_round_s,
    single_chip_rows)``."""
    model = fitted_round_model(max_depth, n_feat, n_bin)
    if fixed_round_s is None:
        fixed_round_s = model["fixed_round_s"] if model else 0.004
    if per_row_s is None:
        per_row_s = (model["per_row_s"] if model
                     else max(single_chip_round_s - fixed_round_s, 0.0)
                     / single_chip_rows)
    compute = fixed_round_s + per_row_s * (rows / n_chips)
    total_bytes = sum(hist_psum_bytes(max_depth, n_feat, n_bin).values())
    comm = (2.0 * total_bytes * (n_chips - 1) / n_chips
            / ici_allreduce_bw) if n_chips > 1 else 0.0
    return {"compute_s": compute, "psum_s": comm,
            "round_s": compute + comm,
            "rounds_per_sec": 1.0 / (compute + comm),
            "psum_bytes_per_round": float(total_bytes),
            "fixed_round_s": float(fixed_round_s),
            "per_row_s": float(per_row_s),
            "fitted": bool(model)}
