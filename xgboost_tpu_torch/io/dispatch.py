"""Where a ``DMatrix(path)`` comes from (port of
``xgboost_tpu/io/dispatch.py``).

- ``file.txt``: libsvm text, with its ``.group`` / ``.weight`` /
  ``.base_margin`` sidecars;
- ``file.txt#cache``: parse once and write ``cache.npz``; later loads
  read the cache;
- ``file.npz``, or any file whose first four bytes are the zip magic
  ``PK\\x03\\x04`` (the reference's ``.buffer`` name): a binary buffer
  written by :meth:`DMatrix.save_binary` of either package;
- ``file:///path``: a local path in URI form;
- ``scheme://...`` (s3, gs, hdfs, http, ...): remote libsvm text, fetched
  to a local spool by the first opener that applies (the
  ``XGBTPU_REMOTE_CAT`` command, a scheme client on PATH, or
  ``fsspec``; an error names all three), then loaded as a local file
  without sidecars; a populated ``#cache`` skips the fetch;
- ``stdin``: libsvm text on standard input.

Text is parsed by the native parser where it builds, else in Python
(:func:`xgboost_tpu_torch.data.parse_libsvm`).  The paged ``ext:path``
and ``!path#cache`` forms never reach here: ``DMatrix.__new__`` makes
them an :class:`~xgboost_tpu_torch.external.ExtMemDMatrix`.
"""

from __future__ import annotations

import os
import sys

ZIP_MAGIC = b"PK\x03\x04"


def load_dmatrix_into(dmat, uri: str, silent: bool = True) -> None:
    """Fill ``dmat`` (a fresh DMatrix) from ``uri``."""
    path, _, cache = uri.partition("#")
    remote = "://" in path and not path.startswith("file://")
    if remote:
        cache_file = cache + ".npz" if cache else None
        if cache_file and os.path.exists(cache_file):
            # a populated '#cache' skips the download
            _copy_from(dmat, cache_file)
            return
        spooled = _fetch_remote(path)
        try:
            _load_local(dmat, spooled, cache, uri, silent, sidecars=False)
        finally:
            os.unlink(spooled)
        return
    if path.startswith("file://"):
        from urllib.parse import unquote, urlparse
        u = urlparse(path)
        if u.netloc not in ("", "localhost"):
            raise ValueError(f"{uri}: file:// URIs must be local "
                             f"(host {u.netloc!r} is not)")
        path = unquote(u.path)
    if path == "stdin":
        import tempfile

        from xgboost_tpu_torch.data import parse_libsvm
        # a scratch spool for the parser, removed below
        with tempfile.NamedTemporaryFile("wb", suffix=".libsvm",
                                         delete=False) as tf:
            tf.write(sys.stdin.buffer.read())
            spooled = tf.name
        try:
            _set_csr(dmat, *parse_libsvm(spooled))
        finally:
            os.unlink(spooled)
        return
    _load_local(dmat, path, cache, uri, silent)


def _load_local(dmat, path: str, cache: str, uri: str,
                silent: bool, sidecars: bool = True) -> None:
    """A local file: the cache if it exists, a buffer by suffix or
    magic, else libsvm text (then its sidecars, then the cache)."""
    from xgboost_tpu_torch.data import load_meta_sidecars, parse_libsvm
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
    _set_csr(dmat, *parse_libsvm(path))
    if sidecars:
        load_meta_sidecars(dmat, path)
    if cache_file:
        dmat.save_binary(cache_file)
    if not silent:
        print(f"{dmat.num_row}x{dmat.num_col} matrix with "
              f"{len(dmat.values)} entries loaded from {uri}")


def _fetch_remote(uri: str) -> str:
    """Stream a remote text object to a local temporary file and return
    its path (``dispatch.py:128-196``).  Openers, in order:

      1. ``XGBTPU_REMOTE_CAT``: a ``<cmd> <uri>`` command that writes the
         object to stdout (also the test seam);
      2. a scheme client on PATH (``aws`` / ``gsutil`` / ``hdfs``);
      3. ``fsspec``, for every protocol it has a driver for.

    Without one, a ``ValueError`` names all three; any other failure is a
    ``ValueError`` too, and the temporary file is removed."""
    import shutil
    import subprocess
    import tempfile

    custom = os.environ.get("XGBTPU_REMOTE_CAT")
    cmd = None
    if custom:
        cmd = custom.split() + [uri]
    elif uri.startswith("s3://") and shutil.which("aws"):
        cmd = ["aws", "s3", "cp", uri, "-"]
    elif uri.startswith("gs://") and shutil.which("gsutil"):
        cmd = ["gsutil", "cat", uri]
    elif uri.startswith("hdfs://") and shutil.which("hdfs"):
        cmd = ["hdfs", "dfs", "-cat", uri]

    # a scratch spool, removed by the caller after loading (or below)
    with tempfile.NamedTemporaryFile("wb", suffix=".libsvm",
                                     delete=False) as tf:
        try:
            if cmd is not None:
                subprocess.run(cmd, stdout=tf, check=True)
                return tf.name
            try:
                import fsspec
            except ImportError:
                fsspec = None
            if fsspec is not None:
                try:
                    with fsspec.open(uri, "rb") as src:
                        shutil.copyfileobj(src, tf)
                    return tf.name
                except (ImportError, ValueError) as e:
                    # no driver for the scheme
                    fs_err = f" (fsspec: {e})"
            else:
                fs_err = " (fsspec not installed)"
            scheme = uri.split("://", 1)[0]
            client = {"s3": "aws", "gs": "gsutil", "hdfs": "hdfs"}.get(
                scheme)
            hint = f"`{client}` on PATH, " if client else ""
            raise ValueError(
                f"{uri}: no opener for {scheme}:// — need {hint}an "
                f"fsspec driver for {scheme}, or XGBTPU_REMOTE_CAT set "
                f"to a command that streams the object to stdout"
                f"{fs_err}")
        except BaseException as e:
            os.unlink(tf.name)
            if isinstance(e, ValueError) or not isinstance(e, Exception):
                raise
            raise ValueError(f"fetching {uri} failed: {e}")


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
