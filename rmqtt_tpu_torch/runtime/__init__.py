"""The repo's C++ host runtime (``runtime/*.cc`` at the repo root), bound
with ctypes.

It provides the native topic trie (``NativeTrie``: the host mirror behind
``TorchRouter``'s small-batch hybrid and device failover, and the
``native`` router), the batched topic encoder (``NativeEncoder``: the
default encode of ``ops/partitioned.py``'s ``PartitionedTable``), the MQTT
frame scanner and PUBLISH encoder the codec uses (``codec_scan``,
``codec_encode_publish``), topic validation (``topic_validate``) and the
host match decoders of the matcher's unfused and topk modes
(``match_decode_routes``, ``match_decode``).

The shared library is built at first use with ``g++`` into
``rmqtt_tpu_torch/_build/``, under a name keyed on a hash of the sources
and flags (the library in ``runtime/`` belongs to the JAX package). Where
no C++ toolchain is present ``available()`` is False and the callers use
their Python paths (the Python trie, the Python codec), as the JAX
package does. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

log = logging.getLogger("rmqtt_tpu_torch.runtime")

_PKG = Path(__file__).resolve().parent.parent
RUNTIME_DIR = _PKG.parent / "runtime"
SOURCES = ("topics.cc", "encode.cc", "codec.cc")
HEADER = "rmqtt_runtime.h"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++20", "-fPIC", "-Wall", "-Wextra", "-shared")

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in (*SOURCES, HEADER):
        h.update((RUNTIME_DIR / name).read_bytes())
    return BUILD_DIR / f"runtime_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        log.warning("native runtime unavailable: no C++ compiler (g++)")
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *(str(RUNTIME_DIR / s) for s in SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
        tmp.unlink(missing_ok=True)
        log.warning("native runtime build failed: %s", e)
        return False
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return True


def load() -> Optional[ctypes.CDLL]:
    """Load (building once per source hash) the native library; None if it
    cannot be built here."""
    global _lib, _build_failed
    with _LOCK:
        if _lib is not None or _build_failed:
            return _lib
        so = _library_path()
        if not so.exists() and not _build(so):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(so))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.rt_trie_new.restype = ctypes.c_void_p
        lib.rt_trie_free.argtypes = [ctypes.c_void_p]
        lib.rt_trie_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.rt_trie_add.restype = ctypes.c_int
        lib.rt_trie_remove.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.rt_trie_remove.restype = ctypes.c_int
        lib.rt_trie_size.argtypes = [ctypes.c_void_p]
        lib.rt_trie_size.restype = ctypes.c_int64
        lib.rt_trie_match.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i64p,
                                      ctypes.c_int64]
        lib.rt_trie_match.restype = ctypes.c_int64
        lib.rt_trie_match_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, i64p, i64p,
            ctypes.c_int64,
        ]
        lib.rt_trie_match_batch.restype = ctypes.c_int64
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rt_enc_new.restype = ctypes.c_void_p
        lib.rt_enc_free.argtypes = [ctypes.c_void_p]
        lib.rt_enc_add_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int32, ctypes.c_int32]
        lib.rt_enc_cache_clear.argtypes = [ctypes.c_void_p]
        lib.rt_enc_cache_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int32]
        lib.rt_enc_cache_del.restype = ctypes.c_int32
        lib.rt_enc_cache_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int32, i32p, ctypes.c_int32]
        lib.rt_enc_cache_put.restype = ctypes.c_int32
        lib.rt_enc_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            i32p, i32p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            i32p, i32p, i32p, i32p,
        ]
        lib.rt_enc_encode.restype = ctypes.c_int64
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.rt_match_decode.argtypes = [
            i32p, u32p, ctypes.c_int64, ctypes.c_int64, i32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, i64p, i64p, ctypes.c_int64, i64p,
        ]
        lib.rt_match_decode.restype = ctypes.c_int64
        lib.rt_match_decode_routes.argtypes = [
            u32p, ctypes.c_int64, i64p, i32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i64p, i64p,
        ]
        lib.rt_match_decode_routes.restype = ctypes.c_int64
        lib.rt_codec_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            i64p, ctypes.c_int64, i64p, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.rt_codec_scan.restype = ctypes.c_int64
        lib.rt_codec_encode_publish.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.rt_codec_encode_publish.restype = ctypes.c_int64
        lib.rt_topic_validate.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                          ctypes.c_int32]
        lib.rt_topic_validate.restype = ctypes.c_int
        _lib = lib
        return lib


CODEC_STRIDE = 10  # int64 slots per frame record (runtime/codec.cc)
_SCAN_CAP = 8192  # frames per scan call; feed loops on over-full buffers


def codec_scan(lib, buf: bytes, is_v5: bool, max_size: int):
    """→ (rows list [n][stride], consumed, err, hit_cap)."""
    cap = min(len(buf) // 2 + 1, _SCAN_CAP)
    meta = np.empty((cap, CODEC_STRIDE), dtype=np.int64)
    consumed = ctypes.c_int64(0)
    err = ctypes.c_int32(0)
    n = lib.rt_codec_scan(
        buf, len(buf), 1 if is_v5 else 0, max_size,
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
        ctypes.byref(consumed), ctypes.byref(err),
    )
    return meta[:n].tolist(), consumed.value, err.value, n == cap


def codec_encode_publish(lib, topic: bytes, payload: bytes, props: bytes,
                         qos: int, retain: bool, dup: bool,
                         packet_id: Optional[int]) -> Optional[bytes]:
    """Assemble one complete PUBLISH wire frame in C++ (codec.cc). `props`
    is the pre-encoded v5 properties blob (varint prefix + content; empty
    for v3). None when the frame outgrows the computed capacity — the
    caller then uses the Python encoder."""
    cap = 7 + len(topic) + len(props) + len(payload) + (2 if qos else 0)
    out = (ctypes.c_uint8 * cap)()
    n = lib.rt_codec_encode_publish(
        topic, len(topic), payload, len(payload), props, len(props),
        qos, 1 if retain else 0, 1 if dup else 0,
        -1 if packet_id is None else packet_id, out, cap,
    )
    if n < 0:
        return None
    return bytes(out[:n])


def topic_validate(topic: str, is_filter: bool) -> Optional[bool]:
    """Native topic/filter validation; None if the runtime is unavailable."""
    lib = load()
    if lib is None:
        return None
    raw = topic.encode()
    return bool(lib.rt_topic_validate(raw, len(raw), 1 if is_filter else 0))


def available() -> bool:
    return load() is not None


def match_decode_routes(routes: np.ndarray, counts: np.ndarray,
                        chunk_ids: np.ndarray, b: int, wpc: int, chunk: int,
                        fid_map: np.ndarray):
    """Native route-level global compaction → flat per-topic-sorted fids;
    None if the runtime is unavailable. routes uint32, counts int64 (per
    PADDED topic), chunk_ids int32, fid_map int64, all C-contiguous. The
    route total is known up front (= counts.sum() = len(routes)), so
    unlike the word decoders there is no two-pass cap dance."""
    lib = load()
    if lib is None:
        return None
    bp, nc = chunk_ids.shape
    fid_map = np.ascontiguousarray(fid_map, dtype=np.int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    n = int(routes.shape[0])
    out = np.empty(n, dtype=np.int64)
    total = lib.rt_match_decode_routes(
        routes.ctypes.data_as(u32), n, counts.ctypes.data_as(i64),
        chunk_ids.ctypes.data_as(i32), b, bp, nc, wpc, chunk,
        fid_map.ctypes.data_as(i64), out.ctypes.data_as(i64),
    )
    if total < 0:
        raise AssertionError(
            "rt_match_decode_routes hit an out-of-range route/fid/count — "
            "kernel/compaction bug"
        )
    return out


def match_decode(wi: np.ndarray, wb: np.ndarray, chunk_ids: np.ndarray,
                 wpc: int, chunk: int, fid_map: np.ndarray):
    """Native compact-words → (flat sorted fids, per-topic counts); None if
    the runtime is unavailable. Arrays must be C-contiguous int32/uint32
    except fid_map (int64)."""
    lib = load()
    if lib is None:
        return None
    b, k = wi.shape
    nc = chunk_ids.shape[1]
    fid_map = np.ascontiguousarray(fid_map, dtype=np.int64)
    counts = np.empty(b, dtype=np.int64)
    cap = max(64, int(b) * 16)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    while True:
        out = np.empty(cap, dtype=np.int64)
        total = lib.rt_match_decode(
            wi.ctypes.data_as(i32), wb.ctypes.data_as(u32), b, k,
            chunk_ids.ctypes.data_as(i32), nc, wpc, chunk,
            fid_map.ctypes.data_as(i64),
            out.ctypes.data_as(i64), cap, counts.ctypes.data_as(i64),
        )
        if total < 0:
            raise AssertionError(
                "rt_match_decode hit an out-of-range fid (cleared-row "
                "sentinel or overflow) — kernel/compaction bug"
            )
        if total <= cap:
            return out[:total], counts
        cap = int(total)


class NativeTrie:
    """ctypes wrapper over the C++ trie (same semantics as core.trie.TopicTree)."""

    def __init__(self) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable (no C++ toolchain?)")
        self._lib = lib
        self._ptr = ctypes.c_void_p(lib.rt_trie_new())

    def __del__(self) -> None:
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.rt_trie_free(ptr)
            self._ptr = None

    def add(self, topic_filter: str, value: int) -> bool:
        return bool(self._lib.rt_trie_add(self._ptr, topic_filter.encode(), value))

    def remove(self, topic_filter: str, value: int) -> bool:
        return bool(self._lib.rt_trie_remove(self._ptr, topic_filter.encode(), value))

    def __len__(self) -> int:
        return int(self._lib.rt_trie_size(self._ptr))

    def match(self, topic: str, cap: int = 4096) -> np.ndarray:
        buf = np.empty(cap, dtype=np.int64)
        n = self._lib.rt_trie_match(
            self._ptr, topic.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap
        )
        if n > cap:  # rare: grow and retry
            return self.match(topic, cap=int(n))
        return buf[:n].copy()

    def match_batch(self, topics: Sequence[str], cap_per_topic: int = 64) -> List[np.ndarray]:
        blob = b"\x00".join(t.encode() for t in topics) + b"\x00"
        n = len(topics)
        counts = np.empty(n, dtype=np.int64)
        cap = max(1, cap_per_topic * n)
        while True:
            out = np.empty(cap, dtype=np.int64)
            total = self._lib.rt_trie_match_batch(
                self._ptr, blob, n,
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
            )
            if total <= cap:
                break
            cap = int(total)
        rows: List[np.ndarray] = []
        off = 0
        for j in range(n):
            c = int(counts[j])
            rows.append(out[off : off + c].copy())
            off += c
        return rows


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeEncoder:
    """ctypes wrapper over the C++ batched topic encoder (runtime/encode.cc).

    Owns the native token-dict mirror and candidate-chunk cache for one
    ``PartitionedTable``; the table syncs tokens incrementally and drops
    cache entries on mutation (see partitioned.py ``_encode_native``).

    The library is built here from the sources in ``runtime/``, so
    ``rt_enc_cache_del`` is always present: the JAX package's branches
    for a stale prebuilt library without it (``has_cache_del``) have no
    case to serve and are left out.
    """

    def __init__(self) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable (no C++ toolchain?)")
        self._lib = lib
        self._ptr = ctypes.c_void_p(lib.rt_enc_new())
        self.tokens_synced = 0  # count of TokenDict entries pushed so far
        self.cache_epoch = -1  # table.layout_epoch the cache was built under

    def __del__(self) -> None:
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.rt_enc_free(ptr)
            self._ptr = None

    def add_token(self, s: str, tid: int) -> None:
        b = s.encode()
        self._lib.rt_enc_add_token(self._ptr, b, len(b), tid)

    def cache_clear(self) -> None:
        """Drop every cached prefix entry and restart the gid counter."""
        self._lib.rt_enc_cache_clear(self._ptr)

    def cache_del(self, key: bytes) -> int:
        """Erase one prefix entry (selective invalidation); returns the
        number of entries dropped."""
        return self._lib.rt_enc_cache_del(self._ptr, key, len(key))

    def cache_put(self, key: bytes, chunks: np.ndarray) -> int:
        """→ the gid the native side assigned to this entry (authoritative —
        no Python-side mirror counter to drift out of sync)."""
        chunks = np.ascontiguousarray(chunks, dtype=np.int32)
        return self._lib.rt_enc_cache_put(
            self._ptr, key, len(key), _i32p(chunks), len(chunks))

    def encode(self, blob: bytes, n: int, max_levels: int, ttok: np.ndarray,
               tlen: np.ndarray, tdollar: np.ndarray, nc_cap: int,
               cand: np.ndarray, cand_counts: np.ndarray,
               group: np.ndarray) -> np.ndarray:
        """Returns the indices of topics whose prefix key missed the cache;
        ``group`` receives each topic's candidate-row gid (-1 on miss)."""
        miss = np.empty(n, dtype=np.int32)
        nmiss = self._lib.rt_enc_encode(
            self._ptr, blob, n, max_levels, _i32p(ttok), _i32p(tlen),
            tdollar.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            nc_cap, _i32p(cand), _i32p(cand_counts), _i32p(group), _i32p(miss),
        )
        return miss[:nmiss]
