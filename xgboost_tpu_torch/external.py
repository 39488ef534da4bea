"""External-memory training: data larger than the card's memory (port of
``xgboost_tpu/external.py``).

The reference streams CSR pages from disk with a prefetch thread and
trains paged matrices through the histogram updater
(``src/io/page_dmatrix-inl.hpp``).  Here, as in the JAX package:

  1. ingest once into raw CSR pages on disk (the native page store of
     :mod:`xgboost_tpu_torch.native`; a list in RAM without it);
  2. one streaming pass sketches every feature (the per-page summaries
     merged and pruned in page order) into cuts;
  3. one streaming pass bins the pages into an ``(N, F)`` u8 (or u16)
     **memmap**, the only O(N F) artifact, on disk or in the page cache
     (in RAM for the HalfRAM variant);
  4. every tree level streams the binned rows to the card in batches of
     ``page_rows`` and sums the batches' partial histograms (kernel K1)
     and node sums (kernel K2).

Pages, cuts and the binned bytes equal the JAX package's.  Margins,
gradients and row positions are O(N) and stay on the device.  When the
whole binned matrix fits the device budget (:meth:`ExtMemDMatrix.
fits_device_budget`), the learner trains it through the in-memory path
instead.

On the card each batch is uploaded synchronously in the consumer's
thread (:func:`_staged_sync`): a ring of pinned buffers uploaded on a
copy stream ahead of the kernels was slower on every warm-read run
measured, because a streamed round is bound by the host's issue of each
batch's kernels, not by the upload.  On the CPU a worker thread reads
the batches ahead (:func:`_prefetch_to_device`, the JAX package's
prefetcher) unless ``XGBTPU_EXT_PREFETCH=0``.

Paged growth (:func:`grow_tree_paged`) carries each row's level-local
node as an (N,) int32 device vector, advanced one level per batch pass,
instead of re-traversing the partial tree per batch; the terminal
level's histogram is never read, so K1 runs at levels 0 to D-1 and K2 at
0 to D.  In int8 mode the tree's gradients are quantized once with one
scale for the tree, each batch's int32 partial sums are added, and the
level is dequantized once: a paged level's histogram is bitwise the
in-memory K1 histogram of the same rows.  The JAX package's TPU path
quantizes each batch on its own.
"""

from __future__ import annotations

import os
import queue
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from xgboost_tpu_torch.binning import CutMatrix, pack_cuts
from xgboost_tpu_torch.data import (MetaInfo, iter_libsvm_chunks,
                                    load_meta_sidecars)
from xgboost_tpu_torch.models.tree import (GrowConfig, TreeArrays,
                                           apply_level, bin_of_feature,
                                           draw_masks, empty_tree,
                                           table_lookup, _cut_col)
from xgboost_tpu_torch.ops import cuda_hist, cuda_node_stats
from xgboost_tpu_torch.ops.histogram import (_int8_step, _KMODE,
                                             dequantize_hist, prepare_hist)
from xgboost_tpu_torch.ops.split import find_best_splits_native
from xgboost_tpu_torch.sketch import (QuantileSummary, empty_summary,
                                      make_summary, merge_summaries,
                                      prune_summary, propose_cuts)

DEFAULT_PAGE_ROWS = 1 << 16

# the uploads of streamed batches to a GPU, summed over every call:
# batches, bytes, and host seconds of each synchronous upload
UPLOAD_STATS = {"batches": 0, "bytes": 0, "seconds": 0.0}
_STATS_LOCK = threading.Lock()


def reset_upload_stats() -> None:
    with _STATS_LOCK:
        UPLOAD_STATS.update(batches=0, bytes=0, seconds=0.0)


class ExtMemDMatrix:
    """Paged data matrix (reference DMatrixPage).

    Built from a libsvm path (``ExtMemDMatrix("big.svm#cache")`` or
    ``DMatrix("ext:big.svm#cache")``) or from an iterator of
    ``(X_dense, y)`` chunks.  Raw CSR pages are spilled to
    ``<cache>.pages``; binning writes the ``<cache>.binned`` memmap.

    A ``!`` path prefix (or ``half_ram=True``) selects the HalfRAM
    variant (reference ``DMatrixHalfRAM``): the raw rows stay paged on
    disk, the binned matrix is held in host RAM instead of a memmap.
    """

    is_external = True

    def __init__(self, data, label=None, weight=None,
                 cache: Optional[str] = None,
                 page_rows: int = DEFAULT_PAGE_ROWS, missing: float = np.nan,
                 silent: bool = True, half_ram: bool = False):
        self.info = MetaInfo()
        self.page_rows = page_rows
        self._binned_path: Optional[str] = None
        self._binned_mm: Optional[np.ndarray] = None
        self._binned_cuts: Optional[CutMatrix] = None
        self._binned_dtype = np.uint8
        self._ram_pages: List[tuple] = []
        self._cuts: Dict[tuple, CutMatrix] = {}   # the boosters' cuts
        self.feature_names = None

        self.half_ram = half_ram
        if isinstance(data, str):
            if data.startswith("!"):
                self.half_ram = True
                data = data[1:]
            path, _, cachesuffix = data.partition("#")
            if cache is None:
                cache = cachesuffix or path + ".extcache"
            self.cache_prefix = cache
            self._ingest_libsvm(path)
            load_meta_sidecars(self, path)
        else:
            if cache is None:
                cache = os.path.join(
                    tempfile.mkdtemp(prefix="xgbtpu_ext_"), "m")
            self.cache_prefix = cache
            self._ingest_chunks(iter(data), missing)
        if label is not None:
            self.info.set_field("label", label)
        if weight is not None:
            self.info.set_field("weight", weight)

    # ------------------------------------------------------------- ingest
    def _pages_path(self) -> str:
        return self.cache_prefix + ".pages"

    def _ingest_libsvm(self, path: str, chunk_lines: int = 0) -> None:
        """Text into the page store (``external.py:112-160``): the native
        parser for files up to ``XGTPU_NATIVE_INGEST_LIMIT`` bytes (512
        MB), else bounded Python chunks, so host RAM holds one chunk and
        one page."""
        from xgboost_tpu_torch import native
        chunk_lines = chunk_lines or self.page_rows
        fast_limit = int(os.environ.get("XGTPU_NATIVE_INGEST_LIMIT",
                                        str(1 << 29)))
        if native.available() and os.path.getsize(path) <= fast_limit:
            indptr, indices, values, labels = native.parse_libsvm_native(
                path)
            self._write_pages_from_csr(indptr, indices, values)
            self._num_col = int(indices.max()) + 1 if len(indices) else 0
            self.info.set_field("label", labels)
            self._num_row = len(indptr) - 1
            return
        writer = self._page_writer()
        all_labels: List[np.ndarray] = []
        num_col = 0
        n_rows = 0
        for indptr, indices, values, labels in iter_libsvm_chunks(
                path, chunk_lines):
            self._push_page(writer, indptr, indices, values)
            all_labels.append(labels)
            if len(indices):
                num_col = max(num_col, int(indices.max()) + 1)
            n_rows += len(labels)
        self._close_writer(writer)
        self._num_col = num_col
        self.info.set_field(
            "label", np.concatenate(all_labels) if all_labels
            else np.zeros(0, np.float32))
        self._num_row = n_rows

    def _ingest_chunks(self, chunks: Iterator[Tuple[np.ndarray, np.ndarray]],
                       missing: float) -> None:
        """Dense ``(X, y)`` chunks into pages, one page a chunk."""
        labels: List[np.ndarray] = []
        writer = self._page_writer()
        n_rows = 0
        num_col = 0
        for X, y in chunks:
            X = np.asarray(X, np.float32)
            num_col = max(num_col, X.shape[1])
            present = ~np.isnan(X) if np.isnan(missing) else X != missing
            counts = present.sum(axis=1)
            indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            rows, cols = np.nonzero(present)
            self._push_page(writer, indptr, cols.astype(np.int32),
                            X[rows, cols].astype(np.float32))
            labels.append(np.asarray(y, np.float32))
            n_rows += X.shape[0]
        self._close_writer(writer)
        self._num_row = n_rows
        self._num_col = num_col
        if labels:
            self.info.set_field("label", np.concatenate(labels))

    def _write_pages_from_csr(self, indptr, indices, values) -> None:
        writer = self._page_writer()
        n = len(indptr) - 1
        for start in range(0, n, self.page_rows):
            stop = min(start + self.page_rows, n)
            self._push_page(writer, indptr[start:stop + 1], indices, values)
        self._close_writer(writer)

    # page-store backends: the native library, or a list in RAM
    def _page_writer(self):
        from xgboost_tpu_torch import native
        if native.available():
            return native.PageWriter(self._pages_path())
        self._ram_pages = []
        return None

    def _push_page(self, writer, indptr, indices, values) -> None:
        if writer is not None:
            writer.push(indptr, indices, values)
        else:
            base = indptr[0]
            self._ram_pages.append(
                (np.asarray(indptr) - base,
                 np.asarray(indices[base:indptr[-1]], np.int32),
                 np.asarray(values[base:indptr[-1]], np.float32)))

    @staticmethod
    def _close_writer(writer) -> None:
        if writer is not None:
            writer.close()

    def iter_raw_pages(self):
        """Yield the (indptr, indices, values) CSR pages."""
        from xgboost_tpu_torch import native
        if native.available() and os.path.exists(self._pages_path()):
            with native.PageReader(self._pages_path()) as r:
                yield from r
        else:
            yield from self._ram_pages

    # ---------------------------------------------------- DMatrix protocol
    @property
    def num_row(self) -> int:
        return self._num_row

    @property
    def num_col(self) -> int:
        return self._num_col

    def get_label(self):
        return self.info.label

    def get_weight(self):
        return self.info.get_weight(self.num_row)

    def get_base_margin(self):
        return self.info.base_margin

    def set_label(self, label):
        self.info.set_field("label", label)

    def set_weight(self, weight):
        self.info.set_field("weight", weight)

    def set_group(self, group):
        self.info.set_field("group", group)

    def set_base_margin(self, margin):
        self.info.set_field("base_margin", margin)

    def slice(self, rindex):
        raise NotImplementedError(
            "slice() is not supported on external-memory matrices")

    # ------------------------------------------------------------- sketch
    def sketch_cuts(self, max_bin: int = 256, sketch_eps: float = 0.03,
                    sketch_ratio: float = 2.0) -> CutMatrix:
        """The streaming per-feature quantile sketch over the raw pages
        (``external.py:261-281``): each page's summary merged into the
        feature's and pruned after every merge, in page order."""
        F = self.num_col
        maxsize = max(2, int(sketch_ratio / max(sketch_eps, 1.0 / max_bin)))
        summaries: List[QuantileSummary] = [empty_summary() for _ in range(F)]
        for indptr, indices, values in self.iter_raw_pages():
            order = np.argsort(indices, kind="stable")
            starts = np.searchsorted(indices[order], np.arange(F + 1))
            for f in range(F):
                sel = order[starts[f]:starts[f + 1]]
                if len(sel) == 0:
                    continue
                s = prune_summary(make_summary(values[sel]), maxsize)
                summaries[f] = prune_summary(
                    merge_summaries(summaries[f], s), maxsize)
        return pack_cuts([propose_cuts(s, max_bin - 1) for s in summaries])

    # ------------------------------------------------------------ binning
    def build_binned(self, cuts: CutMatrix) -> None:
        """Bin the raw pages into the binned memmap (``external.py:
        283-330``), of the model's width: a feature the pages lack gets
        a column of missing bins."""
        width = max(self.num_col, cuts.num_feature)
        self._binned_dtype = np.uint8 if cuts.max_bin <= 256 else np.uint16
        if self.half_ram:
            mm = np.zeros((self.num_row, width), dtype=self._binned_dtype)
        else:
            self._binned_path = self.cache_prefix + ".binned"
            mm = np.memmap(self._binned_path, dtype=self._binned_dtype,
                           mode="w+", shape=(self.num_row, width))
        f_lim = min(self.num_col, cuts.num_feature)
        row0 = 0
        for indptr, indices, values in self.iter_raw_pages():
            n = len(indptr) - 1
            page = np.zeros((n, width), dtype=self._binned_dtype)
            rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
            # one argsort groups the entries by feature
            order = np.argsort(indices, kind="stable")
            starts = np.searchsorted(indices[order], np.arange(f_lim + 1))
            bins = np.zeros(len(indices), dtype=np.int64)
            for f in range(f_lim):
                sel = order[starts[f]:starts[f + 1]]
                if len(sel) == 0:
                    continue
                bins[sel] = 1 + np.searchsorted(
                    cuts.cut_values[f, :cuts.n_cuts[f]], values[sel],
                    side="right")
            in_lim = indices < f_lim
            page[rows[in_lim], indices[in_lim]] = \
                bins[in_lim].astype(self._binned_dtype)
            mm[row0:row0 + n] = page
            row0 += n
        if self.half_ram:
            self._binned_mm = mm
        else:
            mm.flush()
            self._binned_mm = np.memmap(self._binned_path,
                                        dtype=self._binned_dtype, mode="r",
                                        shape=(self.num_row, width))
        self._binned_cuts = cuts  # identity-tracked by the learner's entry

    def binned_batches(self, batch_rows: Optional[int] = None):
        """Yield (row_start, binned numpy view) batches."""
        assert self._binned_mm is not None, "call build_binned first"
        step = batch_rows or self.page_rows
        for start in range(0, self.num_row, step):
            yield start, self._binned_mm[start:start + step]

    def binned_nbytes(self) -> int:
        assert self._binned_mm is not None, "call build_binned first"
        return (self.num_row * self._binned_mm.shape[1]
                * self._binned_mm.dtype.itemsize)

    def fits_device_budget(self, device=None) -> bool:
        """Whether the whole binned matrix fits the device budget
        (:func:`device_budget`); the learner then trains it through the
        in-memory path and streams nothing."""
        return self.binned_nbytes() <= device_budget(device)

    def device_batches(self, device=None):
        """Yield (row_start, binned batch on ``device``): staged
        synchronously on the card; on the CPU through the worker of
        :func:`_prefetch_to_device` unless ``XGBTPU_EXT_PREFETCH=0``
        (or the legacy ``XGTPU_EXT_PREFETCH``), as in the JAX package."""
        device = torch.device("cuda" if device is None else device)
        switch = os.environ.get("XGBTPU_EXT_PREFETCH",
                                os.environ.get("XGTPU_EXT_PREFETCH", "1"))
        depth = 0 if device.type == "cuda" or switch == "0" else 2
        return _prefetch_to_device(self.binned_batches(), device, depth)


# ----------------------------------------------------------------- budget
_budget_cache: Dict[str, int] = {}


def device_budget(device=None) -> int:
    """Device bytes a streamed or collapsed binned matrix may take:
    ``XGBTPU_EXT_DEVICE_CACHE_MB`` (or ``XGTPU_EXT_DEVICE_CACHE_MB``) MiB
    when set, else :func:`_default_device_budget`."""
    env = os.environ.get("XGBTPU_EXT_DEVICE_CACHE_MB",
                         os.environ.get("XGTPU_EXT_DEVICE_CACHE_MB"))
    if env not in (None, ""):
        return int(env) << 20
    return _default_device_budget(device)


def _default_device_budget(device=None) -> int:
    """Half of the card's free memory (``torch.cuda.mem_get_info``),
    sampled once per device, so that later allocations do not flip a
    matrix between the streamed and in-memory paths; 2,048 MiB on the
    CPU (``external.py:468-493``)."""
    device = torch.device("cuda" if device is None else device)
    key = str(device)
    if key not in _budget_cache:
        budget = 2048 << 20
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            budget = max(free // 2, 0)
        _budget_cache[key] = budget
    return _budget_cache[key]


# ----------------------------------------------------------------- upload
def _host_rows(b) -> np.ndarray:
    """A batch as a numpy array torch can take (u16 bins become int32)."""
    b = np.asarray(b)
    return b.astype(np.int32) if b.dtype == np.uint16 else b


def _prefetch_to_device(batches, device, depth: int = 2):
    """Stage ``(start, numpy batch)`` pairs to ``device`` as ``(start,
    tensor)``: a worker thread reads ``depth`` batches ahead (the memmap
    reads) and the consumer moves each to the device; ``depth <= 0``
    stages each batch synchronously in the caller's thread.  The
    worker's exceptions surface at the consumer, after the batches read
    before them; closing the generator early stops and joins the
    worker."""
    device = torch.device(device)
    if depth <= 0:
        return _staged_sync(batches, device)
    return _staged_host(batches, device, depth)


def _count_upload(nbytes: int, seconds: float = 0.0) -> None:
    with _STATS_LOCK:
        UPLOAD_STATS["batches"] += 1
        UPLOAD_STATS["bytes"] += int(nbytes)
        UPLOAD_STATS["seconds"] += seconds


def _staged_sync(batches, device):
    for start, b in batches:
        h = _host_rows(b)
        t0 = time.perf_counter()
        t = torch.from_numpy(np.array(h)).to(device)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
            _count_upload(h.nbytes, time.perf_counter() - t0)
        yield start, t


_END = object()


def _run_worker(q, stop, produce):
    """The worker's loop: ``produce()`` yields the items to queue; an
    exception is queued for the consumer."""
    try:
        for item in produce():
            if stop.is_set():
                return
            q.put(item)
        q.put(_END)
    except BaseException as e:  # noqa: BLE001 -- relayed to the consumer
        q.put(e)


def _retire(t, q, stop):
    """Stop the worker and join it: set the flag, then drain the queue so
    a blocked put returns and the worker sees the flag."""
    stop.set()
    while t.is_alive():
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=0.05)


def _staged_host(batches, device, depth):
    """The worker form: the worker reads each batch into host memory."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def produce():
        for start, b in batches:
            yield start, np.array(_host_rows(b))
    t = threading.Thread(target=_run_worker, args=(q, stop, produce),
                         daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            start, h = item
            yield start, torch.from_numpy(h).to(device)
    finally:
        _retire(t, q, stop)


# ------------------------------------------------------------- paged grow
def _fixed_node_sums(gh_q: torch.Tensor, pos: torch.Tensor,
                     n_node: int) -> torch.Tensor:
    """The int32 node sums of "fixed"-quantized gradients (the JAX
    package's int32 scatter, ``ops/histogram.py:304-308``)."""
    slot = torch.where(pos < 0, n_node, pos).to(torch.int64)
    out = torch.zeros((n_node + 1, 2), dtype=torch.int32, device=gh_q.device)
    out.index_add_(0, slot, gh_q)
    return out[:n_node]


def _paged_level_hist(batch: torch.Tensor, gh_in: torch.Tensor,
                      gh: torch.Tensor, pos: torch.Tensor, n_node: int,
                      n_bin: int, mode: str, with_hist: bool):
    """One batch's partial sums at one level (``external.py:494-514``):
    the histogram (K1; None when ``with_hist`` is False) in the kernel's
    raw form (int32 for int8 and fixed), and the node sums (K2; int32
    for fixed)."""
    hist = None
    if with_hist:
        hist = cuda_hist.level_histogram(batch, gh_in, pos, n_node, n_bin,
                                         _KMODE[mode])
    if mode == "fixed":
        nst = _fixed_node_sums(gh_in, pos, n_node)
    else:
        nst = cuda_node_stats.node_stats(gh[None], pos[None], n_node)[0]
    return hist, nst


def grow_tree_paged(dmat: ExtMemDMatrix, gh: torch.Tensor,
                    cut_values: torch.Tensor, n_cuts: torch.Tensor,
                    cfg: GrowConfig, key=None, split_finder=None
                    ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree level by level over the streamed batches of
    ``dmat`` (``external.py:549-621``).

    gh (N, 2) f32 on the device; ``key`` the tree's host key (2,)
    uint32, needed when the config samples (the draws of the in-memory
    grower: rows kept where ``uniform(key_rows) < subsample``, feature
    masks per tree and per level).  Each level makes one pass over the
    batches: a batch's rows first move one level down by the previous
    level's splits, then the batch adds its partial histogram (K1, not
    at the terminal level) and node sums (K2) to the level's, in batch
    order.  The level's node sums drive the split search, as in the JAX
    package.  Returns (the tree as a (1, n_nodes) stack, the (N,) int32
    leaf node of each row)."""
    if split_finder is None:
        split_finder = find_best_splits_native
    dev = gh.device
    N = dmat.num_row
    F = int(n_cuts.shape[0])
    D = cfg.max_depth
    draws = draw_masks(None if key is None
                       else np.asarray(key, np.uint32)[None],
                       N, F, cfg, dev)
    gh = gh.to(torch.float32).contiguous()
    if draws.keep is not None:
        gh = (gh * draws.keep[0][:, None].to(gh.dtype)).contiguous()
    prep = prepare_hist(gh, cfg.hist_precision)   # one int8 scale a tree
    mode = prep.mode
    pos = torch.zeros(N, dtype=torch.int32, device=dev)
    row_leaf = torch.zeros(N, dtype=torch.int32, device=dev)
    tree = empty_tree(D, 1, dev)

    for depth in range(D + 1):
        n_node = 1 << depth
        terminal = depth == D
        hist = nst = None
        for start, batch in dmat.device_batches(dev):
            n = batch.shape[0]
            rows = slice(start, start + n)
            bpos = pos[rows]
            if depth > 0:
                # one level down by the previous level's splits, parking
                # the rows whose node became a leaf
                bpos = _advance(tree, depth - 1, batch, bpos,
                                row_leaf[rows])
                pos[rows] = bpos
            h, s = _paged_level_hist(batch, prep.gh_in[rows], gh[rows],
                                     bpos, n_node, cfg.n_bin, mode,
                                     not terminal)
            if h is not None:
                hist = h if hist is None else hist + h
            nst = s if nst is None else nst + s
        # int32 partials (int8, fixed) decode once a level
        nst = dequantize_hist(nst)
        if terminal:
            make_leaf = torch.ones(n_node, dtype=torch.bool, device=dev)
            best = thr = None
        else:
            if mode == "int8":
                hist = hist.to(torch.float32) * _int8_step(prep.scale)[
                    None, None, :, None]
            else:
                hist = dequantize_hist(hist)
            fmask = None
            if draws.fmask is not None:
                fmask = draws.fmask[depth, 0][:, None].expand(
                    F, n_node).reshape(F, n_node)
            best = split_finder(hist, nst, n_cuts, cfg.split, fmask)
            thr = cut_values[best.feature.to(torch.int64),
                             _cut_col(best, cut_values.shape[1])]
            can_try = nst[:, 1] >= 2.0 * cfg.split.min_child_weight
            make_leaf = ~(best.valid & can_try)
        tree = apply_level(tree, depth, nst, best, thr, make_leaf, cfg.split)
    # the terminal level parks every row still active
    row_leaf = torch.where(pos >= 0, pos + ((1 << D) - 1), row_leaf)
    return tree, row_leaf


def _advance(tree: TreeArrays, depth: int, batch: torch.Tensor,
             bpos: torch.Tensor, leaf_out: torch.Tensor) -> torch.Tensor:
    """Route a batch's rows from their node at ``depth`` to the next
    level (the in-memory grower's routing, ``tree.py`` ``grow_trees``):
    a row whose node is a leaf is parked (its leaf node written into
    ``leaf_out``, a view of the tree's row-leaf vector) and leaves the
    level (-1); the others go left or right by the node's split, missing
    values the default way."""
    n_node = 1 << depth
    base = n_node - 1
    sl = slice(base, base + n_node)
    active = bpos >= 0
    node = torch.clamp(bpos, 0, n_node - 1).to(torch.int64)
    f_row = tree.feature[0, sl][node]
    at_leaf = tree.is_leaf[0, sl][node] | (f_row < 0)
    leaf_out.copy_(torch.where(active & at_leaf, base + bpos, leaf_out))
    b = bin_of_feature(batch, torch.clamp_min(f_row, 0))
    go_left = torch.where(b == 0, tree.default_left[0, sl][node],
                          b <= tree.cut_index[0, sl][node] + 1)
    new_pos = 2 * bpos + (~go_left).to(torch.int32)
    return torch.where(active & ~at_leaf, new_pos, -1).to(torch.int32)


__all__ = ["ExtMemDMatrix", "DEFAULT_PAGE_ROWS", "device_budget",
           "grow_tree_paged", "UPLOAD_STATS", "reset_upload_stats"]
