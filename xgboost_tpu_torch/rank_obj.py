"""LambdaRank objectives ``rank:pairwise``, ``rank:ndcg`` and ``rank:map``
(port of ``xgboost_tpu/rank_obj.py``; reference objective-inl.hpp:274-570).

Two implementations, picked by ``rank_impl``:

- ``device`` (the default): pair sampling and the NDCG / MAP swap
  weights on the margin's device (:mod:`xgboost_tpu_torch.rank_device`),
  on the group-padded layout when the learner laid the entry out so
  (``pad_prep``), else on the sort path.  The round's key is
  ``fold_in(PRNGKey(4177 + seed), iteration)``;
- ``host``: the reference's per-group numpy loop on the host, drawing
  from ``RandomState(iteration * 1111 + 17 + seed * 7919)``, the same
  code as the JAX package, so its gradients are equal to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from xgboost_tpu_torch import random as prng

_EPS = 1e-16


class LambdaRankObj:
    """rank:pairwise | rank:ndcg | rank:map (reference LambdaRankObj)."""

    def __init__(self, name: str):
        self.name = name
        self.kind = name.split(":")[1]
        self.num_pairsample = 1
        self.fix_list_weight = 0.0
        self.rank_impl = "device"
        self.seed = 0
        self.default_metric = "ndcg" if self.kind == "ndcg" else "map"

    @property
    def needs_host_margin(self) -> bool:
        """The host path reads the whole margin each round, so no round
        segment of the JAX package's scan takes it (``no_fused_grad``)."""
        return self.rank_impl == "host"

    def set_param(self, name, value):
        if name == "num_pairsample":
            self.num_pairsample = int(value)
        elif name == "fix_list_weight":
            self.fix_list_weight = float(value)
        elif name == "rank_impl":
            if value not in ("device", "host"):
                raise ValueError("rank_impl must be 'device' or 'host'")
            self.rank_impl = value
        elif name == "seed":
            self.seed = int(value)

    def validate_labels(self, info) -> None:
        pass

    def fused_grad(self):
        """No lane may stack a rank objective in the port: the gradient
        needs the matrix's groups and the round (see
        ``Booster.fused_lane_spec``)."""
        return None

    def pred_transform(self, margin, output_margin=False):
        return margin

    def eval_transform(self, margin):
        return margin

    def prob_to_margin(self, base_score: float) -> float:
        return base_score

    # ------------------------------------------------------------ gradient
    def round_key(self, iteration: int) -> np.ndarray:
        return prng.fold_in(prng.PRNGKey(4177 + self.seed), iteration)

    def _prep(self, info, n_rows: int, device):
        """The sort path's tables, kept on the info until a field changes."""
        from xgboost_tpu_torch.rank_device import build_prep
        key = ("rank_prep", n_rows, str(device))
        if key not in info._dev:
            labels = np.asarray(info.label)
            gptr = (np.asarray(info.group_ptr) if info.group_ptr is not None
                    else np.array([0, len(labels)], np.int64))
            info._dev[key] = build_prep(labels, gptr, n_rows, device)
        return info._dev[key]

    def get_gradient(self, margin: torch.Tensor, info, iteration: int,
                     pad_prep=None) -> torch.Tensor:
        """(N, 1, 2) gradient pairs of round ``iteration`` on the entry's
        rows: the padded layout's with ``pad_prep``, else the rows in the
        user's order (rows past the last group get zeros)."""
        if self.rank_impl == "host":
            return self._host_gradient(margin, info, iteration)
        from xgboost_tpu_torch.rank_device import (rank_gradient,
                                                   rank_gradient_padded)
        key = self.round_key(iteration)
        flw = float(self.fix_list_weight)
        if pad_prep is not None:
            gh = rank_gradient_padded(margin[:, 0], key, pad_prep, self.kind,
                                      self.num_pairsample, flw)
        else:
            prep = self._prep(info, margin.shape[0], margin.device)
            gh = rank_gradient(margin[:, 0], key, prep, self.kind,
                               self.num_pairsample, flw)
        return gh[:, None, :]

    def _host_gradient(self, margin, info, iteration):
        """``rank_obj.py:222-243``: the margin on the host, groups in
        turn, one RandomState a round."""
        preds = margin[:, 0].cpu().numpy()
        labels = np.asarray(info.label)
        gptr = (np.array([0, len(labels)], dtype=np.int64)
                if info.group_ptr is None
                else np.asarray(info.group_ptr, dtype=np.int64))
        if gptr[-1] > len(labels):
            raise ValueError("group structure not consistent with #rows")
        rng = np.random.RandomState(iteration * 1111 + 17 + self.seed * 7919)
        grad = np.zeros(len(labels), dtype=np.float64)
        hess = np.zeros(len(labels), dtype=np.float64)
        for k in range(len(gptr) - 1):
            s, e = int(gptr[k]), int(gptr[k + 1])
            self._group_gradient(preds[s:e], labels[s:e], rng, grad[s:e],
                                 hess[s:e])
        gh = np.stack([grad, hess], axis=-1).astype(np.float32)[:, None, :]
        return torch.from_numpy(gh).to(margin.device)

    def _group_gradient(self, preds, labels, rng, out_g, out_h):
        """One group's sampled pairs (``rank_obj.py:246-290``): for each
        label bucket, each row draws ``num_pairsample`` partners among
        the rows of other labels."""
        n = len(preds)
        if n < 2:
            return
        order = np.argsort(-preds, kind="stable")
        slab = labels[order]
        lorder = np.argsort(-slab, kind="stable")
        lsorted = slab[lorder]
        starts = np.concatenate(
            [[0], np.nonzero(lsorted[1:] != lsorted[:-1])[0] + 1, [n]])
        pos_list, neg_list = [], []
        for bi in range(len(starts) - 1):
            i, j = starts[bi], starts[bi + 1]
            nleft, nright = i, n - j
            if nleft + nright == 0:
                continue
            size = (j - i) * self.num_pairsample
            pid = np.tile(np.arange(i, j), self.num_pairsample)
            ridx = (rng.random_sample(size) * (nleft + nright)).astype(
                np.int64)
            hi = ridx < nleft
            pos_list.append(np.where(hi, ridx, pid))
            neg_list.append(np.where(hi, pid, ridx + (j - i)))
        if not pos_list:
            return
        p_pos = lorder[np.concatenate(pos_list)]
        p_neg = lorder[np.concatenate(neg_list)]
        w = self._lambda_weight(slab, p_pos, p_neg)
        scale = 1.0 / self.num_pairsample
        if self.fix_list_weight != 0.0:
            scale *= self.fix_list_weight / n
        w = w * scale
        spreds = preds[order]
        p = 1.0 / (1.0 + np.exp(-(spreds[p_pos] - spreds[p_neg])))
        g = (p - 1.0) * w
        h = np.maximum(p * (1.0 - p), _EPS) * 2.0 * w
        np.add.at(out_g, order[p_pos], g)
        np.add.at(out_g, order[p_neg], -g)
        np.add.at(out_h, order[p_pos], h)
        np.add.at(out_h, order[p_neg], h)

    def _lambda_weight(self, slab, p_pos, p_neg):
        """Pair weights from places in the prediction-sorted list
        (``rank_obj.py:292-330``)."""
        if self.kind == "pairwise":
            return np.ones(len(p_pos))
        if self.kind == "ndcg":
            rel = slab.astype(np.int64)
            idcg_rel = np.sort(rel)[::-1]
            disc = 1.0 / np.log(np.arange(len(slab)) + 2.0)
            idcg = np.sum((2.0 ** idcg_rel - 1.0) * disc)
            if idcg == 0.0:
                return np.zeros(len(p_pos))
            pos_loginv = 1.0 / np.log(p_pos + 2.0)
            neg_loginv = 1.0 / np.log(p_neg + 2.0)
            pg = 2.0 ** rel[p_pos] - 1.0
            ng = 2.0 ** rel[p_neg] - 1.0
            original = pg * pos_loginv + ng * neg_loginv
            changed = ng * pos_loginv + pg * neg_loginv
            return np.abs((original - changed) / idcg)
        hit = (slab > 0).astype(np.float64)
        hits = np.cumsum(hit)
        inv_i = 1.0 / np.arange(1, len(slab) + 1)
        acc1 = np.cumsum(hit * hits * inv_i)
        acc2 = np.cumsum(hit * (hits - 1.0) * inv_i)
        acc3 = np.cumsum(hit * (hits + 1.0) * inv_i)
        total_hits = hits[-1]
        if total_hits == 0:
            return np.zeros(len(p_pos))
        i1 = np.minimum(p_pos, p_neg)
        i2 = np.maximum(p_pos, p_neg)
        lab1 = (slab[i1] > 0).astype(np.float64)
        lab2 = (slab[i2] > 0).astype(np.float64)
        original = acc1[i2] - np.where(i1 > 0, acc1[np.maximum(i1 - 1, 0)],
                                       0.0)
        ch_insert = (acc3[np.maximum(i2 - 1, 0)] - acc3[i1]
                     + (hits[i1] + 1.0) / (i1 + 1))
        ch_remove = (acc2[np.maximum(i2 - 1, 0)] - acc2[i1]
                     + hits[i2] / (i2 + 1))
        changed = np.where(lab1 < lab2, ch_insert, ch_remove)
        delta = np.abs((changed - original) / total_hits)
        delta[lab1 == lab2] = 0.0
        delta[i1 == i2] = 0.0
        return delta
