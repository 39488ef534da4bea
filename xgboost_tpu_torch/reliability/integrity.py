"""Crash-safe, integrity-checked model files (port of
``xgboost_tpu/reliability/integrity.py``).

1. :func:`atomic_write` (and :func:`atomic_writer`, its streaming
   form) stages into a same-directory temp file, fsyncs it,
   ``os.replace``-s it over the destination and fsyncs the directory:
   a crash leaves the old file or the new one, never a prefix.
2. Every model file carries a fixed-length ASCII CRC32 footer::

       \\nXGTPUCRC1 <crc32:08x> <payload_len:016d>\\n

   :func:`verify_model_bytes` strips and checks it.  The format is the
   JAX package's, so files cross between the two packages both ways.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import tempfile
import zlib
from typing import Union

from xgboost_tpu_torch.reliability import faults

FOOTER_MAGIC = b"XGTPUCRC1"
# \n + magic(9) + sp + crc(8 hex) + sp + len(16 dec) + \n
FOOTER_LEN = 1 + 9 + 1 + 8 + 1 + 16 + 1
_FOOTER_RE = re.compile(rb"\nXGTPUCRC1 ([0-9a-f]{8}) (\d{16})\n\Z")


class ModelIntegrityError(ValueError):
    """A persisted model failed verification (torn, truncated or
    bit-flipped)."""


def make_footer(payload: bytes) -> bytes:
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return b"\n%s %08x %016d\n" % (FOOTER_MAGIC, crc, len(payload))


def add_footer(payload: bytes) -> bytes:
    """Payload + CRC32 footer (what every model writer persists)."""
    return payload + make_footer(payload)


_warned_unverified = set()


def verify_model_bytes(raw: bytes, name: str = "<buffer>",
                       warn: bool = True) -> bytes:
    """Verify and strip the CRC footer, returning the payload.  A footer
    that is wrong, cut mid-way or disagrees on the length raises
    :class:`ModelIntegrityError`; a file without a footer loads
    unverified, with a warning once per name."""
    m = _FOOTER_RE.search(raw)
    if m is None:
        head = b"\n" + FOOTER_MAGIC + b" "
        torn_prefix = any(raw.endswith(head[:k])
                          for k in range(2, len(head)))
        if torn_prefix or FOOTER_MAGIC in raw[-(FOOTER_LEN + 8):]:
            _count_integrity_failure(name, "truncated footer (torn write)")
            raise ModelIntegrityError(
                f"{name}: truncated integrity footer (torn write)")
        if warn and name not in _warned_unverified:
            _warned_unverified.add(name)
            print(f"[integrity] {name}: no integrity footer; loading "
                  "unverified", file=sys.stderr)
        return raw
    payload = raw[:-FOOTER_LEN]
    want_crc, want_len = int(m.group(1), 16), int(m.group(2))
    if len(payload) != want_len:
        _count_integrity_failure(name, "length mismatch (torn write)")
        raise ModelIntegrityError(
            f"{name}: payload is {len(payload)} bytes, footer says "
            f"{want_len} (torn write)")
    got_crc = zlib.crc32(payload) & 0xFFFFFFFF
    if got_crc != want_crc:
        _count_integrity_failure(name, "CRC32 mismatch")
        raise ModelIntegrityError(
            f"{name}: CRC32 mismatch (footer {want_crc:08x}, content "
            f"{got_crc:08x})")
    return payload


def _count_integrity_failure(name: str, reason: str) -> None:
    """``xgbtpu_reliability_integrity_failures_total`` and an
    ``integrity.failure`` event (``integrity.py:113``)."""
    from xgboost_tpu_torch.obs import event, reliability_metrics
    reliability_metrics().integrity_failures.inc()
    event("integrity.failure", file=name, reason=reason)


@contextlib.contextmanager
def atomic_writer(path: Union[str, os.PathLike], durable: bool = True):
    """A binary file object staged in the destination directory
    (``xgboost_tpu/reliability/integrity.py:122``): a clean exit
    flushes, fsyncs, ``os.replace``-s it over ``path`` and fsyncs the
    directory; an exception unlinks the temp file and leaves ``path``
    as it was.  For writers that stream (prediction text, DMatrix
    buffers) and must not stage the whole file in memory."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    try:
        mode = os.stat(path).st_mode & 0o777
    except OSError:
        mask = os.umask(0)
        os.umask(mask)
        mode = 0o666 & ~mask
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            yield f
            f.flush()
            os.fchmod(f.fileno(), mode)
            if durable:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if durable:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


def atomic_write(path: Union[str, os.PathLike], data: bytes,
                 durable: bool = True) -> None:
    """Whole-file write: temp file in the destination directory ->
    flush -> fsync -> ``os.replace`` -> directory fsync.  The bytes pass
    the ``faults.mutate_write`` seam first (torn writes, bit flips,
    ENOSPC under chaos, ``integrity.py:174``)."""
    data = faults.mutate_write(os.fspath(path), data)
    with atomic_writer(path, durable=durable) as f:
        f.write(data)


def read_file(path: Union[str, os.PathLike]) -> bytes:
    """Whole-file read through the ``faults.mutate_read`` seam
    (slow reads, read bit flips, ``integrity.py:184``)."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        raw = f.read()
    return faults.mutate_read(path, raw)


def quarantine(path: Union[str, os.PathLike]) -> str:
    """Move a corrupt file aside as ``<path>.corrupt`` (numbered when
    that exists) and fsync the directory, so retry loops stop re-reading
    it and a post-mortem can inspect the bytes.  Returns the new path."""
    path = os.fspath(path)
    dest = path + ".corrupt"
    i = 1
    while os.path.exists(dest):
        dest = f"{path}.corrupt{i}"
        i += 1
    os.replace(path, dest)
    dfd = os.open(os.path.dirname(os.path.abspath(dest)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    from xgboost_tpu_torch.obs import event, reliability_metrics
    reliability_metrics().quarantines.inc()
    event("integrity.quarantine", file=path, quarantined_as=dest)
    return dest
