"""Scikit-learn estimators (port of ``xgboost_tpu/sklearn.py``).

``XGBModel`` / ``XGBRegressor`` / ``XGBClassifier`` as in the reference
(``wrapper/xgboost.py:748-846``), with ``device`` (``"cuda"`` by default,
or ``"cpu"``) as one more constructor argument, so ``get_params`` and
``clone`` carry it.  scikit-learn is optional: without it the estimators
are plain objects with their own label encoder (the reference's
``SKLEARN_INSTALLED`` guard).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    from sklearn.preprocessing import LabelEncoder
    SKLEARN_INSTALLED = True
except ImportError:  # the reference's XGBModelBase = object
    SKLEARN_INSTALLED = False
    BaseEstimator = object

    class ClassifierMixin:  # type: ignore[no-redef]
        pass

    class RegressorMixin:  # type: ignore[no-redef]
        pass

    class LabelEncoder:  # type: ignore[no-redef]
        def fit(self, y):
            self.classes_ = np.unique(y)
            return self

        def transform(self, y):
            idx = np.searchsorted(self.classes_, y)
            idx_clip = np.clip(idx, 0, len(self.classes_) - 1)
            if np.any(self.classes_[idx_clip] != np.asarray(y)):
                raise ValueError("y contains previously unseen labels")
            return idx

        def inverse_transform(self, idx):
            return self.classes_[np.asarray(idx, dtype=np.int64)]

from xgboost_tpu_torch.data import DMatrix  # noqa: E402
from xgboost_tpu_torch.learner import Booster, train  # noqa: E402


class XGBModel(BaseEstimator):
    """Base estimator (reference XGBModel, wrapper/xgboost.py:748-795)."""

    def __init__(self, max_depth=3, learning_rate=0.1, n_estimators=100,
                 silent=True, objective="reg:linear", booster="gbtree",
                 gamma=0.0, min_child_weight=1.0, max_delta_step=0.0,
                 subsample=1.0, colsample_bytree=1.0, colsample_bylevel=1.0,
                 reg_alpha=0.0, reg_lambda=1.0, scale_pos_weight=1.0,
                 base_score=0.5, seed=0, max_bin=256, missing=np.nan,
                 device="cuda"):
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.silent = silent
        self.objective = objective
        self.booster = booster
        self.gamma = gamma
        self.min_child_weight = min_child_weight
        self.max_delta_step = max_delta_step
        self.subsample = subsample
        self.colsample_bytree = colsample_bytree
        self.colsample_bylevel = colsample_bylevel
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.scale_pos_weight = scale_pos_weight
        self.base_score = base_score
        self.seed = seed
        self.max_bin = max_bin
        self.missing = missing
        self.device = device
        self._Booster: Optional[Booster] = None

    # -- sklearn protocol ------------------------------------------------
    _PARAM_NAMES = ("max_depth", "learning_rate", "n_estimators", "silent",
                    "objective", "booster", "gamma", "min_child_weight",
                    "max_delta_step", "subsample", "colsample_bytree",
                    "colsample_bylevel", "reg_alpha", "reg_lambda",
                    "scale_pos_weight", "base_score", "seed", "max_bin",
                    "missing", "device")

    def get_params(self, deep=True):
        return {k: getattr(self, k) for k in self._PARAM_NAMES}

    def set_params(self, **params):
        for k, v in params.items():
            if k not in self._PARAM_NAMES:
                raise ValueError(f"invalid parameter {k!r}")
            setattr(self, k, v)
        return self

    def get_xgb_params(self) -> dict:
        """Estimator params -> booster params (reference get_xgb_params,
        wrapper/xgboost.py:780-785); ``device`` goes to ``train``."""
        p = {k: getattr(self, k) for k in self._PARAM_NAMES
             if k not in ("learning_rate", "n_estimators", "silent",
                          "missing", "device")}
        p["eta"] = self.learning_rate
        p["silent"] = 1 if self.silent else 0
        return p

    def get_booster(self) -> Booster:
        if self._Booster is None:
            raise ValueError("need to call fit beforehand")
        return self._Booster

    # -- fit/predict -----------------------------------------------------
    def _dmatrix(self, X, y=None, sample_weight=None) -> DMatrix:
        return DMatrix(X, label=y, weight=sample_weight,
                       missing=self.missing)

    def _predict_data(self, X):
        """A plain NaN-missing array goes to ``Booster.predict`` as it
        is; a non-NaN missing marker or sparse input is wrapped."""
        if hasattr(X, "num_row"):
            return X
        if isinstance(X, np.ndarray) and (
                self.missing is None or np.isnan(self.missing)):
            return X
        return self._dmatrix(X)

    def _encode_labels(self, y):
        """Hook: (train labels, extra params, eval-label transform)."""
        return y, {}, lambda ey: ey

    def fit(self, X, y, sample_weight=None, eval_set=None,
            early_stopping_rounds=None, verbose=False):
        if early_stopping_rounds is not None and not eval_set:
            raise ValueError(
                "For early stopping you need at least one set in eval_set")
        # drop a previous fit's early-stopping state
        for attr in ("best_score_", "best_iteration_"):
            if hasattr(self, attr):
                delattr(self, attr)
        labels, extra_params, trans = self._encode_labels(y)
        params = {**self.get_xgb_params(), **extra_params}
        dtrain = self._dmatrix(X, labels, sample_weight)
        evals = [(self._dmatrix(ex, trans(ey)), f"validation_{i}")
                 for i, (ex, ey) in enumerate(eval_set or [])]
        self.evals_result_ = {}
        self._Booster = train(
            params, dtrain, self.n_estimators, evals=evals,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self.evals_result_, verbose_eval=verbose,
            device=self.device)
        if early_stopping_rounds is not None:
            self.best_score_ = self._Booster.best_score
            self.best_iteration_ = self._Booster.best_iteration
        return self

    def predict(self, X):
        return self.get_booster().predict(self._predict_data(X))

    def apply(self, X):
        """Leaf index per (row, tree) (``Booster.predict`` pred_leaf)."""
        return self.get_booster().predict(self._predict_data(X),
                                          pred_leaf=True)

    @property
    def feature_importances_(self) -> np.ndarray:
        if self.booster == "gblinear":
            raise AttributeError(
                "feature_importances_ is not supported for booster=gblinear")
        booster = self.get_booster()
        out = np.zeros(booster.num_feature, dtype=np.float32)
        for name, count in booster.get_fscore().items():
            out[int(name[1:])] = count
        total = out.sum()
        return out / total if total > 0 else out


class XGBRegressor(XGBModel, RegressorMixin):
    """(reference XGBRegressor, wrapper/xgboost.py:846)"""


class XGBClassifier(XGBModel, ClassifierMixin):
    """(reference XGBClassifier, wrapper/xgboost.py:798-843)"""

    def __init__(self, max_depth=3, learning_rate=0.1, n_estimators=100,
                 silent=True, objective="binary:logistic", **kwargs):
        super().__init__(max_depth=max_depth, learning_rate=learning_rate,
                         n_estimators=n_estimators, silent=silent,
                         objective=objective, **kwargs)

    def _encode_labels(self, y):
        self._le = LabelEncoder().fit(y)
        self.classes_ = self._le.classes_
        self.n_classes_ = len(self.classes_)
        extra = {}
        if self.n_classes_ > 2:
            # per fit, never changing self.objective, so a later binary
            # fit or a clone() is unaffected (wrapper/xgboost.py:803-808)
            extra = {"objective": "multi:softprob",
                     "num_class": self.n_classes_}
        return self._le.transform(y), extra, self._le.transform

    def predict(self, X):
        probs = self.predict_proba(X)
        return self._le.inverse_transform(np.argmax(probs, axis=1))

    def predict_proba(self, X):
        raw = self.get_booster().predict(self._predict_data(X))
        if raw.ndim > 1:  # multi:softprob
            return raw
        return np.vstack([1.0 - raw, raw]).T
