"""Where a ``DMatrix(path)`` comes from (port of the local part of
``xgboost_tpu/io/dispatch.py``).

- ``file.txt``: libsvm text, with its ``.group`` / ``.weight`` /
  ``.base_margin`` sidecars;
- ``file.txt#cache``: parse once and write ``cache.npz``; later loads
  read the cache;
- ``file.npz``, or any file whose first four bytes are the zip magic
  ``PK\\x03\\x04`` (the reference's ``.buffer`` name): a binary buffer
  written by :meth:`DMatrix.save_binary` of either package;
- ``file:///path``: a local path in URI form;
- ``stdin``: libsvm text on standard input.

Remote schemes (``s3://``, ``gs://``, ...) and the paged ``ext:path`` /
``!path#cache`` forms raise ``NotImplementedError``: external memory and
remote IO are ROADMAP.md section 1 item 12.
"""

from __future__ import annotations

import os
import sys

ZIP_MAGIC = b"PK\x03\x04"


def load_dmatrix_into(dmat, uri: str, silent: bool = True) -> None:
    """Fill ``dmat`` (a fresh DMatrix) from ``uri``."""
    if uri.startswith("ext:") or (uri.startswith("!") and "#" in uri):
        raise NotImplementedError(
            f"{uri}: external-memory matrices are ROADMAP.md section 1 "
            "item 12")
    path, _, cache = uri.partition("#")
    if "://" in path and not path.startswith("file://"):
        raise NotImplementedError(
            f"{uri}: remote data is ROADMAP.md section 1 item 12 (only "
            "local paths and file:// are ported)")
    if path.startswith("file://"):
        from urllib.parse import unquote, urlparse
        u = urlparse(path)
        if u.netloc not in ("", "localhost"):
            raise ValueError(f"{uri}: file:// URIs must be local "
                             f"(host {u.netloc!r} is not)")
        path = unquote(u.path)
    if path == "stdin":
        import tempfile

        from xgboost_tpu_torch.data import parse_libsvm_python
        # a scratch spool for the parser, removed below
        with tempfile.NamedTemporaryFile("wb", suffix=".libsvm",
                                         delete=False) as tf:
            tf.write(sys.stdin.buffer.read())
            spooled = tf.name
        try:
            _set_csr(dmat, *parse_libsvm_python(spooled))
        finally:
            os.unlink(spooled)
        return
    _load_local(dmat, path, cache, uri, silent)


def _load_local(dmat, path: str, cache: str, uri: str,
                silent: bool) -> None:
    """A local file: the cache if it exists, a buffer by suffix or
    magic, else libsvm text (then its sidecars, then the cache)."""
    from xgboost_tpu_torch.data import (load_meta_sidecars,
                                        parse_libsvm_python)
    cache_file = cache + ".npz" if cache else None
    if cache_file and os.path.exists(cache_file):
        _copy_from(dmat, cache_file)
        return
    if path.endswith(".npz") and os.path.exists(path):
        _copy_from(dmat, path)
        return
    if os.path.exists(path):
        with open(path, "rb") as f:
            if f.read(4) == ZIP_MAGIC:
                _copy_from(dmat, path)
                return
    _set_csr(dmat, *parse_libsvm_python(path))
    load_meta_sidecars(dmat, path)
    if cache_file:
        dmat.save_binary(cache_file)
    if not silent:
        print(f"{dmat.num_row}x{dmat.num_col} matrix with "
              f"{len(dmat.values)} entries loaded from {uri}")


def _set_csr(dmat, indptr, indices, values, labels) -> None:
    dmat._indptr, dmat._indices, dmat._values = indptr, indices, values
    dmat._num_col = int(indices.max()) + 1 if len(indices) else 0
    dmat.info.set_field("label", labels)


def _copy_from(dst, path: str) -> None:
    src = type(dst).load_binary(path)
    dst._indptr, dst._indices, dst._values = (src._indptr, src._indices,
                                              src._values)
    dst._num_col = src._num_col
    dst.info = src.info
