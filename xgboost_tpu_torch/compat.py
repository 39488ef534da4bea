"""The reference's binary model format, read and written (port of
``xgboost_tpu/compat.py``).

Parses the C-struct model files written by the reference learner
(``src/learner/learner-inl.hpp:229-234`` SaveModel: LearnerModelParam +
objective/gbm names, then the booster blob) so models trained by the
reference CLI can be loaded, cross-checked and served by this framework
(SURVEY.md §M2).  Both on-disk encodings are handled: raw ``binf`` and
the base64 text-safe ``bs64`` mode (``learner-inl.hpp:209-252``,
``src/utils/base64-inl.h``).

Binary layout (all little-endian, struct-aligned as written by the
reference's ``fo.Write(&param, sizeof(param))``):

- learner ``ModelParam``: float base_score (already margin-transformed,
  ``learner-inl.hpp:151``), uint num_feature, int num_class, int[31]
  reserved  (``learner-inl.hpp:427-454``).
- two length-prefixed strings (uint64 len + bytes): objective name, gbm
  name.
- gbtree ``ModelParam`` (``gbtree-inl.hpp:430-484``): int num_trees,
  num_roots, num_feature, [4B pad], int64 num_pbuffer, int
  num_output_group, size_leaf_vector, int[31] reserved, [4B pad] — 160
  bytes total (verified against reference-written files).
- per tree (``model.h:26-330``): ``Param`` (6 ints + 31 reserved =
  148B), then num_nodes × ``Node`` {int parent, cleft, cright; uint
  sindex; float info} (20B), then num_nodes × ``RTreeNodeStat``
  {float loss_chg, sum_hess, base_weight; int leaf_child_cnt} (16B).
- int32 tree_info[num_trees] (per-tree class group).
- optional prediction buffer (ignored).

The converted ensemble is exact: per-feature cut sets are the model's
own distinct thresholds, so the binned traversal ``bin(v) <= j+1``
reproduces the reference's ``fvalue < split_cond`` routing bit-for-bit
(``model.h:534-566``), including the missing-value default direction
carried in sindex's top bit.

Host code: the parse, the loaded model's arrays and the written bytes are
those of the JAX package.  :func:`load_reference_model` puts the model on
``device`` (cuda by default).
"""

from __future__ import annotations

import base64
import struct
from typing import List, Optional

import numpy as np
import torch

from xgboost_tpu_torch.models.tree import TreeArrays

_LEARNER_PARAM = struct.Struct("<fIi124x")
_GBTREE_PARAM = struct.Struct("<iii4xqii128x")
_TREE_PARAM = struct.Struct("<6i124x")
_GBLINEAR_PARAM = struct.Struct("<Ii128x")
_NODE_DT = np.dtype([("parent", "<i4"), ("cleft", "<i4"), ("cright", "<i4"),
                     ("sindex", "<u4"), ("info", "<f4")])
_STAT_DT = np.dtype([("loss_chg", "<f4"), ("sum_hess", "<f4"),
                     ("base_weight", "<f4"), ("leaf_child_cnt", "<i4")])


def _read_str(data: bytes, off: int):
    (ln,) = struct.unpack_from("<Q", data, off)
    off += 8
    if ln >= (1 << 32):  # old-format compat gap (learner-inl.hpp:171-175)
        off += 4
        ln >>= 32
    s = data[off:off + ln].decode()
    return s, off + ln


def parse_reference_model(data: bytes) -> dict:
    """Parse reference model bytes into a plain dict (format-level only)."""
    if data[:4] == b"bs64":
        data = base64.b64decode(b"".join(data[5:].split()))
    elif data[:4] == b"binf":
        data = data[4:]
    # else: headerless pre-magic stream, parse from byte 0
    base_margin, num_feature, num_class = _LEARNER_PARAM.unpack_from(data, 0)
    off = _LEARNER_PARAM.size
    name_obj, off = _read_str(data, off)
    name_gbm, off = _read_str(data, off)
    out = {"base_margin": base_margin, "num_feature": num_feature,
           "num_class": num_class, "objective": name_obj, "gbm": name_gbm}
    if name_gbm == "gblinear":
        nf, nog = _GBLINEAR_PARAM.unpack_from(data, off)
        off += _GBLINEAR_PARAM.size
        (wlen,) = struct.unpack_from("<Q", data, off)
        off += 8
        w = np.frombuffer(data, "<f4", count=wlen, offset=off)
        out["num_output_group"] = nog
        out["weights"] = w.reshape(nf + 1, nog).astype(np.float32)
        return out
    if name_gbm != "gbtree":
        raise ValueError(f"unknown booster in reference model: {name_gbm!r}")
    num_trees, _roots, gb_nf, _npb, nog, slv = _GBTREE_PARAM.unpack_from(
        data, off)
    off += _GBTREE_PARAM.size
    if slv != 0:
        raise ValueError("size_leaf_vector != 0 models are not supported")
    trees = []
    for _ in range(num_trees):
        _, n_nodes, _, _, _, t_slv = _TREE_PARAM.unpack_from(data, off)
        off += _TREE_PARAM.size
        nodes = np.frombuffer(data, _NODE_DT, count=n_nodes, offset=off)
        off += _NODE_DT.itemsize * n_nodes
        stats = np.frombuffer(data, _STAT_DT, count=n_nodes, offset=off)
        off += _STAT_DT.itemsize * n_nodes
        if t_slv:
            (lv_len,) = struct.unpack_from("<Q", data, off)
            off += 8 + 4 * lv_len
        trees.append((nodes, stats))
    tree_info = np.frombuffer(data, "<i4", count=num_trees, offset=off)
    out["num_output_group"] = max(1, nog)
    out["trees"] = trees
    out["tree_info"] = tree_info.astype(np.int32)
    return out


def _tree_depth(nodes: np.ndarray) -> int:
    depth, frontier = 0, [(0, 0)]
    best = 0
    while frontier:
        nid, d = frontier.pop()
        best = max(best, d)
        if nodes["cleft"][nid] != -1:
            frontier.append((int(nodes["cleft"][nid]), d + 1))
            frontier.append((int(nodes["cright"][nid]), d + 1))
    return best


def load_reference_model(src, device=None):
    """Load a reference-format model (file path or raw ``bytes``) into a
    served-ready Booster on ``device``."""
    from xgboost_tpu_torch.binning import pack_cuts
    from xgboost_tpu_torch.learner import Booster
    from xgboost_tpu_torch.models.tree import TreeArrays, tree_capacity

    if isinstance(src, bytes):
        parsed = parse_reference_model(src)
    else:
        with open(src, "rb") as f:
            parsed = parse_reference_model(f.read())

    params = {"objective": parsed["objective"],
              "num_class": parsed["num_class"]}
    if parsed["gbm"] == "gblinear":
        params["booster"] = "gblinear"
        bst = Booster(params, device=device)  # K derives from num_class
        bst._init_obj()
        bst.num_feature = parsed["num_feature"]
        from xgboost_tpu_torch.models.gblinear import GBLinear
        gbl = GBLinear(bst.param, parsed["num_feature"], bst.device)
        # reference layout: weight[(num_feature+1) * K], bias LAST
        # (gblinear-inl.hpp:252-259)
        w = np.ascontiguousarray(parsed["weights"])
        gbl.weight = torch.from_numpy(w[:-1].copy()).to(bst.device)
        gbl.bias = torch.from_numpy(w[-1].copy()).to(bst.device)
        bst.gbtree = gbl
        bst.param.base_score = _margin_to_base_score(
            bst.obj, parsed["base_margin"])
        return bst

    trees, tree_info = parsed["trees"], parsed["tree_info"]
    nf = parsed["num_feature"]
    # cuts = the model's own thresholds per feature -> exact traversal
    thresholds: List[List[float]] = [[] for _ in range(nf)]
    for nodes, _ in trees:
        split = nodes["cleft"] != -1
        for f, thr in zip(nodes["sindex"][split] & 0x7FFFFFFF,
                          nodes["info"][split]):
            thresholds[int(f)].append(np.float32(thr))
    per_feature = [np.unique(np.asarray(t, np.float32)) if t
                   else np.asarray([np.float32("inf")])
                   for t in thresholds]
    cuts = pack_cuts(per_feature)

    max_depth = max((_tree_depth(n) for n, _ in trees), default=1)
    max_depth = max(max_depth, 1)
    params["max_depth"] = max_depth
    bst = Booster(params, device=device)  # K derives from num_class
    bst._init_obj()
    bst.num_feature = nf
    from xgboost_tpu_torch.models.gbtree import GBTree
    gbt = GBTree(bst.param, cuts, bst.device)
    cap = tree_capacity(max_depth)
    fields = {"feature": (-1, np.int32), "cut_index": (0, np.int32),
              "threshold": (0, np.float32), "default_left": (0, bool),
              "is_leaf": (0, bool), "leaf_value": (0, np.float32),
              "gain": (0, np.float32), "sum_hess": (0, np.float32)}
    arr = {k: np.full((len(trees), cap), fill, dt)
           for k, (fill, dt) in fields.items()}
    for t, (nodes, stats) in enumerate(trees):
        frontier = [(0, 0)]  # (reference nid, perfect-layout slot)
        while frontier:
            nid, slot = frontier.pop()
            arr["sum_hess"][t, slot] = stats["sum_hess"][nid]
            arr["leaf_value"][t, slot] = stats["base_weight"][nid]
            if nodes["cleft"][nid] == -1:
                arr["is_leaf"][t, slot] = True
                arr["leaf_value"][t, slot] = nodes["info"][nid]
                continue
            f = int(nodes["sindex"][nid] & 0x7FFFFFFF)
            thr = np.float32(nodes["info"][nid])
            arr["feature"][t, slot] = f
            arr["threshold"][t, slot] = thr
            arr["cut_index"][t, slot] = int(np.searchsorted(
                cuts.cut_values[f, :cuts.n_cuts[f]], thr))
            arr["default_left"][t, slot] = bool(nodes["sindex"][nid] >> 31)
            arr["gain"][t, slot] = stats["loss_chg"][nid]
            frontier.append((int(nodes["cleft"][nid]), 2 * slot + 1))
            frontier.append((int(nodes["cright"][nid]), 2 * slot + 2))
    if trees:
        gbt._parts = [TreeArrays(**{k: torch.from_numpy(v).to(bst.device)
                                    for k, v in arr.items()})]
    gbt.tree_group = [int(g) for g in tree_info]
    bst.gbtree = gbt
    bst.param.base_score = _margin_to_base_score(
        bst.obj, parsed["base_margin"])
    return bst


# ------------------------------------------------------------------ writer

def _write_str(out: list, s: str) -> None:
    out.append(struct.pack("<Q", len(s)))
    out.append(s.encode())


def _tree_to_reference(tree, n_roots: int = 1):
    """Convert one perfect-layout tree to reference (nodes, stats) arrays.

    Allocation order: roots first (ids 0..R-1, TreeModel::InitModel),
    then children in BFS order (AddChilds appends pairs) — any
    parent/cleft/cright topology parses, but BFS keeps ids compact.
    """
    feature = tree.feature.cpu().numpy()
    threshold = tree.threshold.cpu().numpy()
    default_left = tree.default_left.cpu().numpy()
    is_leaf = tree.is_leaf.cpu().numpy()
    leaf_value = tree.leaf_value.cpu().numpy()
    gain = tree.gain.cpu().numpy()
    sum_hess = tree.sum_hess.cpu().numpy()

    from xgboost_tpu_torch.models.tree import root_level
    first = (1 << root_level(n_roots)) - 1
    roots = list(range(first, first + n_roots))

    def is_split(slot: int) -> bool:
        return (not is_leaf[slot]) and feature[slot] >= 0

    # breadth-first id assignment over REACHABLE slots
    ids = {}
    order = []
    queue = list(roots)
    while queue:
        slot = queue.pop(0)
        ids[slot] = len(order)
        order.append(slot)
        if is_split(slot):
            queue.append(2 * slot + 1)
            queue.append(2 * slot + 2)

    n = len(order)
    nodes = np.zeros(n, _NODE_DT)
    stats = np.zeros(n, _STAT_DT)
    for slot in order:
        nid = ids[slot]
        stats["sum_hess"][nid] = sum_hess[slot]
        stats["base_weight"][nid] = leaf_value[slot]
        if is_split(slot):
            left, right = ids[2 * slot + 1], ids[2 * slot + 2]
            nodes["cleft"][nid] = left
            nodes["cright"][nid] = right
            # parent packs the is-left-child bit in the sign bit
            # (model.h set_parent)
            nodes["parent"][left] = np.uint32(nid | (1 << 31)).view(np.int32)
            nodes["parent"][right] = nid
            nodes["sindex"][nid] = (np.uint32(feature[slot])
                                    | (np.uint32(1) << 31
                                       if default_left[slot]
                                       else np.uint32(0)))
            nodes["info"][nid] = threshold[slot]
            stats["loss_chg"][nid] = gain[slot]
        else:
            nodes["cleft"][nid] = -1
            nodes["cright"][nid] = -1
            nodes["info"][nid] = leaf_value[slot]
    for r in roots:
        nodes["parent"][ids[r]] = -1
    return nodes, stats


def save_reference_model(booster, path: Optional[str] = None,
                         base64_mode: bool = False,
                         num_pbuffer: Optional[int] = None) -> bytes:
    """Serialize a Booster into the reference's binary model format, so
    reference tooling (CLI ``task=pred``/``train``/``eval``, the C API,
    the R package) can consume models trained here — the write half of
    this module (reference SaveModel: ``learner-inl.hpp:209-252``,
    ``gbtree-inl.hpp:42-78``, ``model.h:320-330``).

    ``num_pbuffer``: prediction-buffer row capacity baked into the model
    (reference semantics: the row count of the matrices cached at train
    time; consumers that cache matrices — continued training, eval —
    abort on a smaller value, gbtree-inl.hpp BufferOffset check).
    Default: the total rows of this Booster's cached matrices, matching
    what the reference itself would have written.  A ZEROED buffer is
    emitted (pred_counter 0 = "no trees applied" — consumers recompute).

    Returns the bytes; also writes them to ``path`` when given.
    ``base64_mode`` emits the text-safe ``bs64`` encoding.
    """
    assert booster.gbtree is not None, "nothing to save"
    if num_pbuffer is None:
        num_pbuffer = sum(e.dmat.num_row for e in booster._cache.values())
    obj = booster.obj
    if obj is None:
        booster._init_obj()
        obj = booster.obj
    out: list = []
    base_margin = float(obj.prob_to_margin(booster.param.base_score))
    num_class = int(booster.param.num_class)
    nf = int(booster.num_feature)
    out.append(_LEARNER_PARAM.pack(base_margin, nf, num_class))
    _write_str(out, booster.param.objective)
    gbm = "gblinear" if booster.param.booster == "gblinear" else "gbtree"
    _write_str(out, gbm)

    if gbm == "gblinear":
        w = booster.gbtree.weight.cpu().numpy().astype(np.float32)
        b = booster.gbtree.bias.cpu().numpy().astype(np.float32)[None, :]
        K = w.shape[1]
        out.append(_GBLINEAR_PARAM.pack(nf, K))
        flat = np.concatenate([w, b]).astype("<f4")  # bias LAST
        out.append(struct.pack("<Q", flat.size))
        out.append(flat.tobytes())
    else:
        gbt = booster.gbtree
        n_roots = max(1, booster.param.num_roots)
        if gbt.num_trees:
            stack, _ = gbt._stack(0)
            trees = [TreeArrays(*(x[t] for x in stack))
                     for t in range(gbt.num_trees)]
        else:
            trees = []
        K = max(1, booster.param.num_output_group)
        out.append(_GBTREE_PARAM.pack(len(trees), n_roots, nf,
                                      int(num_pbuffer),
                                      K if K > 1 else 1, 0))
        for t in trees:
            nodes, stats = _tree_to_reference(t, n_roots)
            out.append(_TREE_PARAM.pack(n_roots, len(nodes), 0,
                                        int(booster.param.max_depth), nf, 0))
            out.append(nodes.tobytes())
            out.append(stats.tobytes())
        out.append(np.asarray(gbt.tree_group, "<i4").tobytes())
        if num_pbuffer:
            # zeroed pred_buffer AND pred_counter, each PredBufferSize =
            # num_pbuffer * num_output_group entries (gbtree-inl.hpp:58-61
            # resizes BOTH by PredBufferSize); counter 0 means "no trees
            # applied", so consumers recompute from scratch
            n_ent = int(num_pbuffer) * (K if K > 1 else 1)
            out.append(b"\x00" * (4 * n_ent))
            out.append(b"\x00" * (4 * n_ent))

    payload = b"".join(out)
    if base64_mode:
        data = b"bs64\t" + base64.b64encode(payload) + b"\n"
    else:
        data = b"binf" + payload
    if path is not None:
        # reference-format exports are durable model files: same
        # tmp+rename discipline as the native save path (XGT003)
        from xgboost_tpu_torch.reliability.integrity import atomic_write
        atomic_write(path, data)
    return data


def _margin_to_base_score(obj, margin: float) -> float:
    """Invert prob_to_margin: the reference stores base_score already
    margin-transformed (learner-inl.hpp:151)."""
    if obj.prob_to_margin(0.3) == 0.3:  # identity transform family
        return float(margin)
    return float(1.0 / (1.0 + np.exp(-margin)))  # logistic family
