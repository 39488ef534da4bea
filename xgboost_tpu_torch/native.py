"""ctypes binding of the native IO library (port of
``xgboost_tpu/native.py``).

The library's source is the repository's ``native/xgtpu_io.cpp``, shared
with the JAX package and never edited or built in place: at first use
``g++`` compiles it into ``xgboost_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source and the
flags, so an edited source rebuilds.  It exposes:

  - :func:`parse_libsvm_native`: multithreaded libsvm parsing (the
    reference's ``src/io/libsvm_parser.h`` chunk parser);
  - :class:`PageWriter` / :class:`PageReader`: external-memory sparse
    page files with a background prefetch thread (reference
    ``src/io/sparse_batch_page.h`` and ``utils/thread_buffer.h``); the
    page file format is the JAX package's, so either package reads the
    other's pages.

Where no toolchain builds it (or ``XGTPU_NO_NATIVE_BUILD`` is set),
:func:`available` is False and the callers take their pure-Python paths,
as in the JAX package.  This is host parsing, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from xgboost_tpu_torch.obs.metrics import swallowed_error

SOURCE = Path(__file__).resolve().parent.parent / "native" / "xgtpu_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_load_failed = False

i64p = ctypes.POINTER(ctypes.c_int64)
i32p = ctypes.POINTER(ctypes.c_int32)
f32p = ctypes.POINTER(ctypes.c_float)


def _target() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libxgtpu_io-{digest[:12]}.so"


def _build(so: Path) -> bool:
    """Compile the source into ``so`` (through a temporary name, so a
    concurrent loader never sees a half-written library)."""
    if os.environ.get("XGTPU_NO_NATIVE_BUILD"):
        return False
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx or not SOURCE.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return True
    except Exception as e:
        # no toolchain: the pure-Python paths run; the degradation is
        # counted so a fleet parsing at a fraction of the speed shows up
        swallowed_error("native.build", e)
        if tmp.exists():
            tmp.unlink()
        return False


def _declare(lib) -> None:
    lib.XGTParseLibSVM.restype = ctypes.c_void_p
    lib.XGTParseLibSVM.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int)]
    lib.XGTCSRSizes.argtypes = [ctypes.c_void_p, i64p, i64p]
    lib.XGTCSRCopy.argtypes = [ctypes.c_void_p, i64p, i32p, f32p, f32p]
    lib.XGTCSRFree.argtypes = [ctypes.c_void_p]
    lib.XGTPageWriterCreate.restype = ctypes.c_void_p
    lib.XGTPageWriterCreate.argtypes = [ctypes.c_char_p]
    lib.XGTPageWriterPush.restype = ctypes.c_int
    lib.XGTPageWriterPush.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      i64p, i32p, f32p]
    lib.XGTPageWriterClose.argtypes = [ctypes.c_void_p]
    lib.XGTPageReaderCreate.restype = ctypes.c_void_p
    lib.XGTPageReaderCreate.argtypes = [ctypes.c_char_p]
    lib.XGTPageReaderNext.restype = ctypes.c_int
    lib.XGTPageReaderNext.argtypes = [ctypes.c_void_p, i64p, i64p]
    lib.XGTPageReaderCopy.argtypes = [ctypes.c_void_p, i64p, i32p, f32p]
    lib.XGTPageReaderReset.argtypes = [ctypes.c_void_p]
    lib.XGTPageReaderFree.argtypes = [ctypes.c_void_p]


def get_lib():
    """The loaded native library, built at first use, or None."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        so = _target() if SOURCE.exists() else None
        if so is None or (not so.exists() and not _build(so)):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            _lib = lib
        except OSError as e:
            swallowed_error("native.load", e)
            _load_failed = True
    return _lib


def available() -> bool:
    return get_lib() is not None


def _as_i64p(a): return a.ctypes.data_as(i64p)
def _as_i32p(a): return a.ctypes.data_as(i32p)
def _as_f32p(a): return a.ctypes.data_as(f32p)


def parse_libsvm_native(path: str, rank: int = 0, nparts: int = 1,
                        nthread: int = 0
                        ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray, np.ndarray]]:
    """(indptr, indices, values, labels), or None without the library.
    A malformed file raises ``ValueError`` (as the Python parser's
    ``int()`` / ``float()`` do), a missing one ``FileNotFoundError``."""
    lib = get_lib()
    if lib is None:
        return None
    status = ctypes.c_int(0)
    h = lib.XGTParseLibSVM(os.fsencode(path), nthread, rank, nparts,
                           ctypes.byref(status))
    if not h:
        if status.value == 2:
            raise ValueError(f"malformed libsvm input in {path!r}")
        import errno
        raise FileNotFoundError(errno.ENOENT, "cannot open libsvm file",
                                path)
    try:
        n_rows = ctypes.c_int64()
        nnz = ctypes.c_int64()
        lib.XGTCSRSizes(h, ctypes.byref(n_rows), ctypes.byref(nnz))
        indptr = np.empty(n_rows.value + 1, np.int64)
        indices = np.empty(nnz.value, np.int32)
        values = np.empty(nnz.value, np.float32)
        labels = np.empty(n_rows.value, np.float32)
        lib.XGTCSRCopy(h, _as_i64p(indptr), _as_i32p(indices),
                       _as_f32p(values), _as_f32p(labels))
    finally:
        lib.XGTCSRFree(h)
    return indptr, indices, values, labels


class PageWriter:
    """Spill CSR row pages to a binary page file."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._h = lib.XGTPageWriterCreate(os.fsencode(path))
        if not self._h:
            raise IOError(f"cannot create {path!r}")

    def push(self, indptr: np.ndarray, indices: np.ndarray,
             values: np.ndarray) -> None:
        indptr = np.ascontiguousarray(indptr, np.int64)
        indices = np.ascontiguousarray(indices, np.int32)
        values = np.ascontiguousarray(values, np.float32)
        if len(indptr) < 1:
            raise ValueError("indptr must have at least one element")
        rc = self._lib.XGTPageWriterPush(
            self._h, len(indptr) - 1, _as_i64p(indptr), _as_i32p(indices),
            _as_f32p(values))
        if rc != 0:
            raise IOError("page write failed")

    def close(self) -> None:
        if self._h:
            self._lib.XGTPageWriterClose(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()  # flush the C++ stream even without close()
        except Exception as e:
            swallowed_error("native.page_writer_del", e)


class PageReader:
    """Iterate (indptr, indices, values) pages with background prefetch."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._h = lib.XGTPageReaderCreate(os.fsencode(path))
        if not self._h:
            raise IOError(f"cannot open {path!r} (bad magic?)")

    def __iter__(self):
        return self

    def __next__(self):
        n_rows = ctypes.c_int64()
        nnz = ctypes.c_int64()
        if not self._lib.XGTPageReaderNext(self._h, ctypes.byref(n_rows),
                                           ctypes.byref(nnz)):
            raise StopIteration
        indptr = np.empty(n_rows.value + 1, np.int64)
        indices = np.empty(nnz.value, np.int32)
        values = np.empty(nnz.value, np.float32)
        self._lib.XGTPageReaderCopy(self._h, _as_i64p(indptr),
                                    _as_i32p(indices), _as_f32p(values))
        return indptr, indices, values

    def reset(self) -> None:
        self._lib.XGTPageReaderReset(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.XGTPageReaderFree(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception as e:
            swallowed_error("native.page_reader_del", e)
