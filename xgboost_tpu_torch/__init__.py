"""xgboost_tpu_torch: the PyTorch/CUDA port of xgboost_tpu.

The histogram booster's main path: ``DMatrix`` -> ``train`` / ``Booster``
-> ``predict`` / ``eval_set`` -> ``save_model`` / ``load_model``, one-group
and multiclass (``num_class``, ``num_parallel_tree``), with the level
histograms and node statistics as hand-written CUDA kernels
(``csrc/*.cu``, built by ``nvcc`` at first use).  The continuous-
training pipeline and gang-batched tenant lanes live in
:mod:`xgboost_tpu_torch.pipeline`.  Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.
Model files load in both packages.  Imports torch, never jax.
"""

from xgboost_tpu_torch.config import TrainParam
from xgboost_tpu_torch.convert import gbtree_from_jax_state
from xgboost_tpu_torch.data import DMatrix
from xgboost_tpu_torch.learner import Booster, train

__all__ = ["Booster", "DMatrix", "TrainParam", "gbtree_from_jax_state",
           "train"]
