"""xgboost_tpu_torch: the PyTorch/CUDA port of xgboost_tpu.

The histogram booster's main path: ``DMatrix`` -> ``train`` / ``Booster``
-> ``predict`` / ``eval_set`` -> ``save_model`` / ``load_model``, one-group,
multiclass (``num_class``, ``num_parallel_tree``) and LambdaRank
(``rank:pairwise|ndcg|map``), custom objectives (``train(obj=)``,
``Booster.boost``) and ``cv``, with the level
histograms and node statistics as hand-written CUDA kernels
(``csrc/*.cu``, built by ``nvcc`` at first use).  The continuous-
training pipeline and gang-batched tenant lanes live in
:mod:`xgboost_tpu_torch.pipeline`.  Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.
The front ends: ``python -m xgboost_tpu_torch <config> [name=value ...]``
(:mod:`xgboost_tpu_torch.cli`) and the scikit-learn estimators
(:mod:`xgboost_tpu_torch.sklearn`).  Model files and DMatrix buffers
load in both packages.  ``booster=gblinear``, the reference's model
files and external memory (:class:`ExtMemDMatrix`, rows paged on disk
and streamed to the card) are ported too.  Imports torch, never jax.
"""

from xgboost_tpu_torch.config import TrainParam
from xgboost_tpu_torch.convert import gbtree_from_jax_state
from xgboost_tpu_torch.data import DMatrix
from xgboost_tpu_torch.external import ExtMemDMatrix
from xgboost_tpu_torch.learner import (Booster, CVPack, aggcv, cv, mknfold,
                                       train)

_SKLEARN = ("XGBClassifier", "XGBModel", "XGBRegressor")


def __getattr__(name):
    # the estimators import scikit-learn (seconds), which a rank process
    # of the launcher never needs: loaded at first use
    if name in _SKLEARN:
        from xgboost_tpu_torch import sklearn
        return getattr(sklearn, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Booster", "CVPack", "DMatrix", "ExtMemDMatrix", "TrainParam",
           "XGBClassifier", "XGBModel", "XGBRegressor", "aggcv", "cv",
           "gbtree_from_jax_state", "mknfold", "train"]
