"""Model text dump and feature importance (port of
``xgboost_tpu/dump.py``).

The reference format (``src/tree/model.h:403-458``):
``nid:[fX<cond] yes=L,no=R,missing=M`` with one tab of indent a depth,
``,gain=..,cover=..`` with stats, and feature-map names and types
(``i`` indicator, ``q`` quantitative, ``int`` integer).  Node ids are
heap order (the children of g are 2g+1 and 2g+2).  Values are the model
file's float32 arrays formatted as the JAX package formats them, so one
model file dumps to the same bytes in both packages.  A multi-root tree
dumps each root slot's subtree in turn.  A gblinear model dumps its
bias and weights (``GBLinear.dump_text``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from xgboost_tpu_torch.models.tree import root_level


def load_fmap(path: str) -> Dict[int, tuple]:
    """A featmap.txt: ``<fid>\\t<name>\\t<type>`` a line."""
    out: Dict[int, tuple] = {}
    if not path:
        return out
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                out[int(parts[0])] = (parts[1], parts[2])
    return out


def _trees(booster):
    """Per tree: (feature, threshold, default_left, is_leaf, leaf_value,
    gain, cover) numpy rows of the model file's arrays."""
    st = booster.gbtree.get_state()
    cols = [st["tree_" + f] for f in ("feature", "threshold",
                                      "default_left", "is_leaf",
                                      "leaf_value", "gain", "sum_hess")]
    return [tuple(c[t] for c in cols) for t in range(len(cols[0]))]


def dump_trees(booster, fmap: str = "", with_stats: bool = False) -> List[str]:
    """One text block a tree (``xgboost_tpu/dump.py:31``); a gblinear
    model dumps one block of its bias and weights."""
    if booster.param.booster == "gblinear":
        return [booster.gbtree.dump_text()]
    fmap_d = load_fmap(fmap)
    n_roots = max(1, booster.param.num_roots)
    out = []
    for feature, thr, default_left, is_leaf, leaf_value, gain, cover \
            in _trees(booster):
        lines: List[str] = []

        def rec(nid: int, depth: int):
            indent = "\t" * depth
            f = feature[nid]
            if is_leaf[nid] or f < 0:
                s = f"{indent}{nid}:leaf={leaf_value[nid]:g}"
                if with_stats:
                    s += f",cover={cover[nid]:g}"
                lines.append(s)
                return
            left, right = 2 * nid + 1, 2 * nid + 2
            miss = left if default_left[nid] else right
            if f in fmap_d:
                name, ftype = fmap_d[f]
                if ftype == "i":
                    # indicator: presence / absence; missing goes 'no'
                    yes, no = ((right, left) if default_left[nid]
                               else (left, right))
                    s = (f"{indent}{nid}:[{name}] yes={yes},no={no},"
                         f"missing={miss}")
                elif ftype == "int":
                    s = (f"{indent}{nid}:[{name}<{int(np.ceil(thr[nid]))}] "
                         f"yes={left},no={right},missing={miss}")
                else:
                    s = (f"{indent}{nid}:[{name}<{thr[nid]:g}] "
                         f"yes={left},no={right},missing={miss}")
            else:
                s = (f"{indent}{nid}:[f{f}<{thr[nid]:g}] "
                     f"yes={left},no={right},missing={miss}")
            if with_stats:
                s += f",gain={gain[nid]:g},cover={cover[nid]:g}"
            lines.append(s)
            rec(left, depth + 1)
            rec(right, depth + 1)

        # a multi-root tree dumps each root's subtree (the reference
        # dumps every root, model.h:403-458 over param.num_roots)
        first = (1 << root_level(n_roots)) - 1
        for r in range(n_roots):
            rec(first + r, 0)
        out.append("\n".join(lines) + "\n")
    return out


def feature_importance(booster, fmap: str = "") -> Dict[str, int]:
    """Split counts by feature name (reference get_fscore,
    ``wrapper/xgboost.py:512-530``): reachable split nodes only."""
    if booster.param.booster == "gblinear":
        # as the JAX package's, which reads the trees a linear model lacks
        raise AttributeError("a gblinear model has no trees to count "
                             "splits in")
    fmap_d = load_fmap(fmap)
    counts: Dict[str, int] = {}
    for feature, _, _, is_leaf, _, _, cover in _trees(booster):
        for nid in range(len(feature)):
            f = feature[nid]
            if f >= 0 and not is_leaf[nid] and cover[nid] > 0:
                name = fmap_d.get(f, (f"f{f}", "q"))[0]
                counts[name] = counts.get(name, 0) + 1
    return counts
