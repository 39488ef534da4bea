"""DMatrix: the host-side data container (port of ``xgboost_tpu/data.py``).

Accepts a dense numpy array (``missing`` marks absent values, NaN by
default), a scipy sparse matrix, an ``(indptr, indices, values,
num_col)`` CSR tuple, or a path, routed by
:mod:`xgboost_tpu_torch.io.dispatch`: libsvm text (the native parser of
:mod:`xgboost_tpu_torch.native` where it builds, else the pure-Python
one, plus the ``.group`` / ``.weight`` / ``.base_margin`` sidecars), a
binary buffer (:meth:`DMatrix.save_binary`, the JAX package's npz
layout, so a buffer written by either package loads in the other),
``path#cache``, ``file://``, a remote ``scheme://`` URI or ``stdin``.
``DMatrix("ext:path#cache")`` and ``DMatrix("!path#cache")`` construct
the paged :class:`~xgboost_tpu_torch.external.ExtMemDMatrix` instead
(the second its HalfRAM variant).  A dense array is kept as it is and
CSR is built only when something iterates CSR; the sketch and the
binning read dense columns directly.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, Optional, Sequence

import numpy as np

# meta fields of a binary buffer, in the JAX package's order
_BUFFER_META = ("label", "weight", "base_margin", "root_index",
                "fold_index")
_UINT_FIELDS = ("root_index", "fold_index")
_FLOAT_FIELDS = ("label", "weight", "base_margin")


class MetaInfo:
    """Per-row metadata: label, weight, group pointer, base margin, and
    the uint32 root slot (multi-root trees) and fold of each row."""

    __slots__ = ("label", "weight", "group_ptr", "base_margin",
                 "root_index", "fold_index", "version", "_dev")

    def __init__(self):
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.group_ptr: Optional[np.ndarray] = None
        self.base_margin: Optional[np.ndarray] = None
        self.root_index: Optional[np.ndarray] = None
        self.fold_index: Optional[np.ndarray] = None
        self.version = 0  # bumped by set_field
        # device copies of label / weight, per device, until a field changes
        self._dev: Dict[Any, Any] = {}

    def get_weight(self, n_rows: int) -> np.ndarray:
        if self.weight is None:
            return np.ones(n_rows, dtype=np.float32)
        return self.weight

    def on_device(self, name: str, n_rows: int, device):
        """``label`` or ``weight`` as a float32 tensor on ``device``."""
        import torch
        key = (name, n_rows, str(device))
        if key not in self._dev:
            host = self.label if name == "label" else self.get_weight(n_rows)
            self._dev[key] = torch.as_tensor(
                np.asarray(host, np.float32)).to(device)
        return self._dev[key]

    def set_field(self, name: str, value) -> None:
        self._dev.clear()
        self.version += 1
        if value is None:
            setattr(self, name if name != "group" else "group_ptr", None)
            return
        arr = np.asarray(value)
        if name == "group":
            self.group_ptr = np.concatenate(
                [[0], np.cumsum(arr.astype(np.int64))])
        elif name in ("label", "weight", "base_margin"):
            setattr(self, name, arr.astype(np.float32).ravel())
        elif name in _UINT_FIELDS:
            # uint32: the reference XGDMatrixSetUIntInfo range
            setattr(self, name, arr.astype(np.uint32).ravel())
        else:
            raise ValueError(f"unknown meta field {name!r}")

    def slice(self, rindex: np.ndarray) -> "MetaInfo":
        """The rows ``rindex`` of every per-row field
        (``xgboost_tpu/data.py:102-110``).  The group pointer is dropped,
        as the reference's XGDMatrixSliceDMatrix drops it: groups do not
        survive an arbitrary row selection."""
        out = MetaInfo()
        for f in _BUFFER_META:
            v = getattr(self, f)
            if v is not None:
                setattr(out, f, v[rindex])
        return out


class DMatrix:
    """Sparse (CSR) or dense data matrix with metadata.  The cut matrices
    that boosters sketch from it stay on it, one per set of sketch
    parameters, so boosters on one matrix sketch it once."""

    def __new__(cls, data: Any = None, *args, **kwargs):
        # "ext:path" / "!path#cache" construct the paged matrix, which is
        # no subclass, so __init__ below is skipped for it
        # (``data.py:129-156``); "!" counts only with a "#cache" suffix,
        # as in the reference's routing
        if cls is DMatrix and isinstance(data, str) and (
                data.startswith("ext:")
                or (data.startswith("!") and "#" in data)):
            from xgboost_tpu_torch.external import ExtMemDMatrix
            path = data[4:] if data.startswith("ext:") else data
            names = ("label", "weight", "missing", "base_margin", "group",
                     "num_col", "feature_names", "silent")
            for name, val in zip(names, args):
                kwargs.setdefault(name, val)
            unsupported = [k for k in ("base_margin", "group", "num_col",
                                       "feature_names")
                           if kwargs.get(k) is not None]
            if unsupported:
                raise ValueError(
                    f"DMatrix({data!r}): {unsupported} not supported on "
                    "external-memory matrices; construct ExtMemDMatrix and "
                    "use set_base_margin/set_group instead")
            return ExtMemDMatrix(
                path, label=kwargs.get("label"),
                weight=kwargs.get("weight"),
                missing=kwargs.get("missing", np.nan),
                silent=kwargs.get("silent", True))
        return super().__new__(cls)

    def __init__(self, data: Any, label=None, weight=None,
                 missing: float = np.nan, base_margin=None, group=None,
                 num_col: Optional[int] = None,
                 feature_names: Optional[Sequence[str]] = None,
                 silent: bool = True):
        self.info = MetaInfo()
        self.feature_names = list(feature_names) if feature_names else None
        self._indptr = self._indices = self._values = None
        self._dense: Optional[tuple] = None   # (arr, missing) until CSR
        self._col_cache = None
        self._cuts: Dict[tuple, Any] = {}   # the boosters' cut matrices
        self._num_col = 0
        if isinstance(data, (str, os.PathLike)):
            from xgboost_tpu_torch.io.dispatch import load_dmatrix_into
            load_dmatrix_into(self, os.fspath(data), silent=silent)
        elif isinstance(data, tuple) and len(data) == 4:
            indptr, indices, values, self._num_col = data
            self._indptr = np.asarray(indptr, dtype=np.int64)
            self._indices = np.asarray(indices, dtype=np.int32)
            self._values = np.asarray(values, dtype=np.float32)
        elif _is_scipy_sparse(data):
            csr = data.tocsr()
            self._indptr = csr.indptr.astype(np.int64)
            self._indices = csr.indices.astype(np.int32)
            self._values = csr.data.astype(np.float32)
            self._num_col = csr.shape[1]
        else:
            arr = np.asarray(data, dtype=np.float32)
            if arr.ndim != 2:
                raise ValueError("expected 2D array")
            self._dense = (arr, missing)
            self._num_col = arr.shape[1]
        if num_col is not None:
            self._num_col = max(num_col, self._num_col)
        if label is not None:
            self.info.set_field("label", label)
        if weight is not None:
            self.info.set_field("weight", weight)
        if base_margin is not None:
            self.info.set_field("base_margin", base_margin)
        if group is not None:
            self.info.set_field("group", group)

    # ------------------------------------------------------------ storage
    def dense_source(self):
        """``(arr, missing)`` of a dense source whose CSR is not built
        yet, else None."""
        if self._dense is None or self._indptr is not None:
            return None
        return self._dense

    def _csr(self) -> None:
        if self._indptr is not None:
            return
        arr, missing = self._dense
        present = stored_mask(arr, missing)
        self._indptr = np.concatenate(
            [[0], np.cumsum(present.sum(axis=1))]).astype(np.int64)
        rows, cols = np.nonzero(present)
        self._indices = cols.astype(np.int32)
        self._values = arr[rows, cols].astype(np.float32)

    @property
    def indptr(self) -> np.ndarray:
        self._csr()
        return self._indptr

    @property
    def indices(self) -> np.ndarray:
        self._csr()
        return self._indices

    @property
    def values(self) -> np.ndarray:
        self._csr()
        return self._values

    @property
    def num_row(self) -> int:
        if self._dense is not None:
            return int(self._dense[0].shape[0])
        return len(self._indptr) - 1

    @property
    def num_col(self) -> int:
        return self._num_col

    def column_values(self, col: int):
        """(row_ids, values) of the stored entries of one column, rows
        ascending — the order of the JAX package's CSR column scan."""
        if self._dense is not None and self._indptr is None:
            arr, missing = self._dense
            if col >= arr.shape[1]:
                return np.zeros(0, np.int64), np.zeros(0, np.float32)
            c = arr[:, col]
            rows = np.flatnonzero(stored_mask(c, missing))
            return rows, c[rows]
        if self._col_cache is None:
            order = np.argsort(self.indices, kind="stable")
            starts = np.searchsorted(self.indices[order],
                                     np.arange(self._num_col + 1))
            row_of = np.repeat(np.arange(self.num_row, dtype=np.int64),
                               np.diff(self.indptr))
            self._col_cache = (order, starts, row_of)
        order, starts, row_of = self._col_cache
        sel = order[starts[col]:starts[col + 1]]
        return row_of[sel], self.values[sel]

    # ------------------------------------------------------------- meta
    def set_label(self, label):
        self.info.set_field("label", label)

    def set_weight(self, weight):
        self.info.set_field("weight", weight)

    def set_group(self, group):
        self.info.set_field("group", group)

    def set_base_margin(self, margin):
        self.info.set_field("base_margin", margin)

    def set_uint_info(self, field: str, data) -> None:
        """``root_index`` or ``fold_index``, uint32 values
        (``xgboost_tpu/data.py:360``)."""
        if field not in _UINT_FIELDS:
            raise ValueError(f"unknown uint field {field!r}")
        arr = np.asarray(data)
        if arr.size and (not np.issubdtype(arr.dtype, np.integer)
                         or int(arr.min()) < 0
                         or int(arr.max()) > np.iinfo(np.uint32).max):
            raise ValueError(
                f"set_uint_info({field!r}): values must fit uint32 "
                "(reference XGDMatrixSetUIntInfo range)")
        self.info.set_field(field, arr)

    def get_uint_info(self, field: str) -> np.ndarray:
        """A uint field, or the read-only ``group_ptr``; unset fields
        come back empty."""
        if field == "group_ptr":
            v = self.info.group_ptr
        elif field in _UINT_FIELDS:
            v = getattr(self.info, field)
        else:
            raise ValueError(f"unknown uint field {field!r}")
        return (np.zeros(0, np.uint32) if v is None
                else np.asarray(v, np.uint32).copy())

    def set_float_info(self, field: str, data) -> None:
        """``label``, ``weight`` or ``base_margin`` as float32
        (``xgboost_tpu/data.py:345``)."""
        if field not in _FLOAT_FIELDS:
            raise ValueError(f"unknown float field {field!r}")
        self.info.set_field(field, np.asarray(data, dtype=np.float32))

    def get_float_info(self, field: str) -> np.ndarray:
        """A float field as a copy; an unset one comes back empty, as in
        the reference (``get_weight`` gives the implicit ones instead)."""
        if field not in _FLOAT_FIELDS:
            raise ValueError(f"unknown float field {field!r}")
        v = getattr(self.info, field)
        return (np.zeros(0, np.float32) if v is None
                else np.asarray(v, np.float32).copy())

    def get_label(self):
        return None if self.info.label is None else self.info.label.copy()

    def get_weight(self):
        w = self.info.get_weight(self.num_row)
        return w.copy() if self.info.weight is not None else w

    def get_base_margin(self):
        return (None if self.info.base_margin is None
                else self.info.base_margin.copy())

    # ------------------------------------------------------------ slices
    def to_dense(self, missing: float = np.nan) -> np.ndarray:
        """(num_row, num_col) float32, absent entries ``missing``
        (``xgboost_tpu/data.py:411``)."""
        src = self.dense_source()
        if src is not None:
            arr, marker = src
            out = np.full((arr.shape[0], self._num_col), missing, np.float32)
            out[:, :arr.shape[1]] = np.where(stored_mask(arr, marker), arr,
                                             np.float32(missing))
            return out
        out = np.full((self.num_row, self._num_col), missing,
                      dtype=np.float32)
        rows = np.repeat(np.arange(self.num_row), np.diff(self.indptr))
        out[rows, self.indices] = self.values
        return out

    def slice(self, rindex) -> "DMatrix":
        """The rows ``rindex`` in their given order, with their meta
        fields and without the group pointer (``xgboost_tpu/data.py:417``;
        reference XGDMatrixSliceDMatrix).  A dense source slices to a
        dense matrix with the same ``missing``, which stores the same
        entries as the JAX package's CSR slice; CSR slices to CSR."""
        rindex = np.asarray(rindex, dtype=np.int64)
        src = self.dense_source()
        if src is not None:
            out = DMatrix(src[0][rindex], missing=src[1],
                          num_col=self._num_col)
        else:
            counts = np.diff(self.indptr)[rindex]
            indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            sel = np.concatenate(
                [np.arange(self.indptr[r], self.indptr[r + 1])
                 for r in rindex]) if len(rindex) else np.zeros(0, np.int64)
            out = DMatrix((indptr, self.indices[sel], self.values[sel],
                           self._num_col))
        out.info = self.info.slice(rindex)
        out.feature_names = self.feature_names
        return out

    # ----------------------------------------------------------- buffers
    def save_binary(self, path: str, silent: bool = True) -> None:
        """Write the binary buffer (``xgboost_tpu/data.py:432``): an npz
        of ``indptr``, ``indices``, ``values``, ``num_col`` and the
        ``meta_*`` fields, streamed through :func:`atomic_writer` with
        fixed member times (equal matrices give equal bytes).  Written
        through a file object, so ``path`` keeps its name (the
        reference's ``.buffer``)."""
        from xgboost_tpu_torch.reliability.integrity import atomic_writer
        fields = [("indptr", self.indptr), ("indices", self.indices),
                  ("values", self.values),
                  ("num_col", np.int64(self._num_col))]
        fields += [("meta_" + f, getattr(self.info, f))
                   for f in _BUFFER_META if getattr(self.info, f) is not None]
        if self.info.group_ptr is not None:
            fields.append(("meta_group_ptr", self.info.group_ptr))
        with atomic_writer(path) as f:
            write_npz(f, fields)
        if not silent:
            print(f"{self.num_row}x{self.num_col} matrix with "
                  f"{len(self.values)} entries saved to {path}")

    @classmethod
    def load_binary(cls, path: str) -> "DMatrix":
        """Read a buffer written by :meth:`save_binary` of either
        package (``xgboost_tpu/data.py:455``)."""
        with np.load(path, allow_pickle=False) as z:
            dm = cls((z["indptr"], z["indices"], z["values"],
                      int(z["num_col"])))
            for f in _BUFFER_META:
                if "meta_" + f in z.files:
                    dm.info.set_field(f, z["meta_" + f])
            if "meta_group_ptr" in z.files:
                dm.info.group_ptr = np.asarray(z["meta_group_ptr"])
        return dm


def write_npz(f, members) -> None:
    """``(name, array)`` pairs as an npz archive on the file object
    ``f`` (``np.load`` reads it), every member stamped 1980-01-01 where
    ``np.savez`` stamps the clock."""
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as zf:
        for key, val in members:
            info = zipfile.ZipInfo(key + ".npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as m:
                np.lib.format.write_array(m, np.asanyarray(val),
                                          allow_pickle=False)


def stored_mask(arr: np.ndarray, missing: float) -> np.ndarray:
    """The entries of a dense array that CSR stores (not the marker)."""
    return ~np.isnan(arr) if np.isnan(missing) else arr != missing


def _is_scipy_sparse(data) -> bool:
    try:
        import scipy.sparse as sp
        return sp.issparse(data)
    except ImportError:
        return False


def iter_libsvm_chunks(path: str, chunk_rows: int):
    """Stream a libsvm text file as CSR chunks of ``chunk_rows`` rows:
    (indptr, indices, values, labels)."""
    labels: list = []
    indptr: list = [0]
    indices: list = []
    values: list = []

    def emit():
        out = (np.asarray(indptr, dtype=np.int64),
               np.asarray(indices, dtype=np.int32),
               np.asarray(values, dtype=np.float32),
               np.asarray(labels, dtype=np.float32))
        labels.clear(), indices.clear(), values.clear()
        indptr.clear(), indptr.append(0)
        return out

    with open(path, "rb") as f:
        for raw in f:
            parts = raw.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                k, _, v = tok.partition(b":")
                indices.append(int(k))
                values.append(float(v))
            indptr.append(len(indices))
            if len(labels) >= chunk_rows:
                yield emit()
    if labels:
        yield emit()


def parse_libsvm(path: str):
    """The whole libsvm file as (indptr, indices, values, labels): the
    native parser where it builds (``data.py:477-493``), else
    :func:`parse_libsvm_python`."""
    from xgboost_tpu_torch.native import parse_libsvm_native
    out = parse_libsvm_native(path)
    if out is not None:
        return out
    return parse_libsvm_python(path)


def parse_libsvm_python(path: str):
    """The whole libsvm file as (indptr, indices, values, labels)."""
    chunks = list(iter_libsvm_chunks(path, 1 << 62))
    if not chunks:
        return (np.zeros(1, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.float32), np.zeros(0, np.float32))
    return chunks[0]


def load_meta_sidecars(dmat: DMatrix, path: str) -> None:
    """``path.group`` / ``path.weight`` / ``path.base_margin`` if present."""
    if os.path.exists(path + ".group"):
        dmat.info.set_field(
            "group", np.loadtxt(path + ".group", dtype=np.int64, ndmin=1))
    for name in ("weight", "base_margin"):
        if os.path.exists(path + "." + name):
            dmat.info.set_field(
                name, np.loadtxt(path + "." + name, dtype=np.float32,
                                 ndmin=1))
