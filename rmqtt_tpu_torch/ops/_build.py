"""Build and load the hand-written CUDA kernels.

One ``nvcc`` a source compiles every source of ``rmqtt_tpu_torch/csrc/``
(``match_words.cu``, ``retained_scan.cu``, ``dense_match.cu``,
``compact_tail.cu``), all started together, and one more links them into
one shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The library lands in
``rmqtt_tpu_torch/_build/`` under a name keyed on a hash of the sources
and the flags, so an edited source rebuilds and an unchanged one loads the
library already built. Nothing here runs at import time: the first kernel
launch calls :func:`kernel_library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "match_words.cu", _PKG / "csrc" / "retained_scan.cu",
           _PKG / "csrc" / "dense_match.cu", _PKG / "csrc" / "compact_tail.cu")
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # tiles, nchunks, groups, ttok, nlvl, wide_mask, meta_plane, tlen,
    # tdollar, chunk_ids, b, nc, out, stream
    "launch_match_words_packed": (_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _I,
                                  _I, _P, _P),
    # tiles, tile_bytes, nchunks, lvl, ttok, tlen, tdollar, chunk_ids, b,
    # nc, out, stream
    "launch_match_words_legacy": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P,
                                  _P),
    # tiles, tile_bytes, nchunks, lvl, ftok, flen, fprefix, fhash, fwild,
    # chunk_ids, b, nc, out, stream
    "launch_retained_scan_gather": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _P, _P),
    # tiles, tile_bytes, nchunks, lvl, ftok, flen, fprefix, fhash, fwild, b,
    # out, stream
    "launch_retained_scan_full": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                                  _P),
    # ftok, flen, fprefix, fhash, fwild, nrows, lvl, ttok, tlen, tdollar, b,
    # out, stream
    "launch_dense_match_packed": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                                  _P, _P),
    # rtok, rlen, rdollar, nrows, lvl, ftok, flen, fprefix, fhash, fwild, b,
    # out, stream
    "launch_dense_match_retained": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I,
                                    _P, _P),
    # packed, w, b, k, word_idx, word_bits, counts, stream
    "launch_dense_match_words": (_P, _I, _I, _I, _P, _P, _P, _P),
    # b, budget → bytes the tails need past their wire (0: one launch)
    "compact_tail_scratch_bytes": (_I, _I),
    # words, w, fid_rows, fid_chunks, chunk_ids, nc, b, budget, out (the wire,
    # then the scratch), stream
    "launch_fused_compact_decode": (_P, _I, _P, _I, _P, _I, _I, _I, _P, _P),
    # words, w, b, budget, out (the wire, then the scratch), wide, stream
    "launch_compact_global": (_P, _I, _I, _I, _P, _I, _P),
}


@dataclass
class KernelLibrary:
    """The loaded library plus what its build reported."""

    lib: ctypes.CDLL
    path: Path
    log: str  # nvcc's output, including the -Xptxas -v resource lines
    build_s: float  # 0.0 when an existing build was loaded


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch on the card. The broker
    rejects the batch it was routing rather than serving it off the card
    (``kernel_fault``); a retained scan raises it to its caller."""


def kernel_fault(exc: BaseException) -> bool:
    """Is ``exc`` a fault of the card's kernels: a build, load or launch
    error of the kernels, or a CUDA error that torch raised (an
    asynchronous kernel fault surfaces at the next synchronisation)?"""
    return isinstance(exc, KernelError) or "CUDA error" in str(exc)


_LOCK = threading.Lock()
_LOADED: Optional[KernelLibrary] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of rmqtt_tpu_torch are built from source at first use")


def _build(sources, so: Path, log_path: Path) -> tuple:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    objs = [so.with_suffix(f".{os.getpid()}.{i}.o") for i in range(len(sources))]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for o, src in zip(objs, sources)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    try:
        for cmd, proc, out in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise KernelError(
                    f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    except KernelError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return log, secs


def load_library(sources) -> KernelLibrary:
    """Build (once per hash of ``sources``) and load a library of the
    kernels' C interface from ``sources`` (paths; the launchers of
    ``_SIGNATURES`` that they define are bound). :func:`kernel_library` loads
    :data:`SOURCES`; a benchmark may load another version of a source
    beside it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    so = BUILD_DIR / f"kernels_{h.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        secs = 0.0
    else:
        log, secs = _build(sources, so, log_path)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise KernelError(f"cannot load {so}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None:  # a library of a subset of the sources
            continue
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=so, log=log, build_s=secs)


def kernel_library() -> KernelLibrary:
    """Build (once per hash of the sources) and load the kernel library."""
    global _LOADED
    with _LOCK:
        if _LOADED is None:
            _LOADED = load_library(SOURCES)
        return _LOADED
