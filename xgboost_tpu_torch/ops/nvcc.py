"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled by
``nvcc`` for ``sm_90a`` into ``xgboost_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads the
library already built.  Several sources build in parallel, one ``nvcc``
each.  Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    name: str
    path: Path
    seconds: float     # 0.0 when the library was already built
    log: str           # nvcc / ptxas output (registers, shared memory)


_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILT: Dict[str, Built] = {}
# threads that launch kernels at once (tenant lanes) build each source once
_LOCK = threading.RLock()


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of xgboost_tpu_torch "
                       "build from source on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, every header
    of ``csrc/`` it may include, and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: List[str]) -> List[Built]:
    """Compile every source of ``names`` not built yet, all at once."""
    with _LOCK:
        return _build(names)


def _build(names: List[str]) -> List[Built]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, out = [], {}
    for name in names:
        if name in _BUILT:
            out[name] = _BUILT[name]
            continue
        so = _target(name)
        if so.exists():
            out[name] = _BUILT[name] = Built(name, so, 0.0, "")
        else:
            todo.append((name, so))
    procs = []
    nvcc = find_nvcc() if todo else ""
    for name, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, so)
        out[name] = _BUILT[name] = Built(name, so, seconds, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [out[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                built, = build([name])
                lib = _LIBS[name] = ctypes.CDLL(str(built.path))
    return lib
