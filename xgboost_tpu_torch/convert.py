"""Carry a JAX-trained ensemble into the port.

``xgboost_tpu``'s ``GBTree.get_state()`` returns numpy arrays: the tree
stack (``tree_<field>``), ``tree_group_arr`` (each tree's output group,
multiclass included), ``cut_values`` and ``cut_n``.
:func:`gbtree_from_jax_state` builds the port's
:class:`~xgboost_tpu_torch.models.gbtree.GBTree` from them, which then
predicts what the JAX ensemble predicts.  Model files are the other
route across (``Booster.load_model`` reads the JAX package's files).
"""

from __future__ import annotations

import numpy as np

from xgboost_tpu_torch.config import TrainParam
from xgboost_tpu_torch.learner import resolve_device
from xgboost_tpu_torch.models.gbtree import GBTree


def gbtree_from_jax_state(state: dict, param, device=None) -> GBTree:
    """``state``: the numpy dict of the JAX package's ``get_state()``;
    ``param``: a ``TrainParam`` of either package or a params dict."""
    if not isinstance(param, TrainParam):
        param = TrainParam.from_dict(
            param.to_dict() if hasattr(param, "to_dict") else param)
    return GBTree.from_state(param, {k: np.asarray(v)
                                     for k, v in state.items()},
                             resolve_device(device))
