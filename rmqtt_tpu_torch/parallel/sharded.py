"""Sharded batched matching over a list of devices.

The port of the JAX package's ``parallel/sharded.py``: the device-side
equivalents of the reference's two cluster routing strategies inside one
process:

- topics sharded over the ``dp`` axis (the replicated-table / raft
  analogue, `rmqtt-cluster-raft/src/router.rs:199-201`: the match is local,
  no collective);
- the filter table sharded over the ``fp`` axis (the scatter-gather /
  broadcast analogue, `rmqtt-cluster-broadcast/src/shared.rs:412-520`):
  every device matches its topic slice against its filter-row slice and
  per-topic counts are summed over the ``fp`` shards.

The mesh is a :class:`Mesh`: a list of torch devices of this process,
reshaped ``(dp, fp)``. It is not ``torch.distributed``: the JAX package's
``shard_map`` runs inside the one process that owns the router, which is
where the broker builds it, and one process a card would need a router
copy each and a rendezvous the broker does not have. A device may appear
more than once (one card standing in for two shows the code path, not
multi-card scaling). The steps run in turn on each device's current
stream, all launched before any result is read, so distinct devices run
at once; ``lax.psum(counts, "fp")`` becomes a sum of the fp shards' count
vectors on the dp row's first device.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rmqtt_tpu_torch.broker.devprof import DEVPROF as _DEVPROF
from rmqtt_tpu_torch.ops.encode import FilterTable
from rmqtt_tpu_torch.ops.match import match_packed
from rmqtt_tpu_torch.ops.match_words import words_any
from rmqtt_tpu_torch.ops.partitioned import (_FP_UPLOAD, _pj, _popcount32, _topk_wire,
                                             _unsigned, compact_global,
                                             fused_compact_decode, resolve_device,
                                             to_device)
from rmqtt_tpu_torch.utils.devfetch import fetch


class Mesh:
    """Devices of this process on a ``(dp, fp)`` grid, row-major:
    ``grid[i][j]`` is dp row i, fp column j; ``flat`` lists them in that
    order (the JAX mesh's order over the flattened ``("dp", "fp")`` axes)."""

    def __init__(self, devices: Sequence, dp: int, fp: int) -> None:
        devs = [resolve_device(d) for d in devices]
        if dp < 1 or fp < 1 or dp * fp != len(devs):
            raise ValueError(f"dp({dp}) * fp({fp}) != ndevices({len(devs)})")
        self.flat: List[torch.device] = devs
        self.grid: List[List[torch.device]] = [devs[i * fp:(i + 1) * fp]
                                               for i in range(dp)]
        self.shape = {"dp": dp, "fp": fp}

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, fp={self.shape['fp']}, {self.flat})"


def make_mesh(devices=None, dp: int = 1, fp: Optional[int] = None) -> Mesh:
    """Build a ``(dp, fp)`` mesh over the given devices, or over every CUDA
    device (raises when there is none: the mesh never falls back to the
    CPU on its own)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device available; pass devices to make_mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    n = len(devices)
    if fp is None:
        fp = n // dp
    return Mesh(devices, dp, fp)


class ShardedResult(NamedTuple):
    """One sharded match: the ``(dp, fp)`` grid of packed bitmap shards, each
    ``[B/dp, cap/fp/32]`` on its device, and each dp row's per-topic counts
    summed over its fp shards, on the row's first device."""

    packed: List[List[torch.Tensor]]
    counts: List[torch.Tensor]


class ShardedMatcher:
    """The dense table sharded over ``fp``, the topic batch over ``dp``.

    ``match_encoded`` launches, device by device, the dense kernel on the
    device's topic slice and filter-row slice and the popcount of its
    shard, then sums each dp row's counts over its fp shards. The bitmap
    stays on the devices (``ShardedResult``); :meth:`assemble` brings the
    whole ``[B, cap/32]`` and the counts to the host."""

    def __init__(self, table: FilterTable, mesh: Mesh) -> None:
        self.table = table
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        self.fp = mesh.shape["fp"]
        self._dev_version = -1
        self._dev_arrays: Optional[List[List[Tuple[torch.Tensor, ...]]]] = None
        if table.capacity % (self.fp * 32) != 0:
            raise ValueError("table capacity must divide fp*32")

    def _refresh(self):
        t = self.table
        if self._dev_version != t.version or self._dev_arrays is None:
            if _FP_UPLOAD.action is not None:  # chaos seam (failpoints)
                _FP_UPLOAD.fire_sync()
            version = t.version
            host = (t.tok, t.flen, t.prefix_len, t.has_hash, t.first_wild)
            cap = host[0].shape[0]
            if cap % (self.fp * 32) != 0:
                raise ValueError("table capacity must divide fp*32")
            s = cap // self.fp
            self._dev_arrays = [
                [tuple(to_device(a[j * s:(j + 1) * s], dev) for a in host)
                 for j, dev in enumerate(row)]
                for row in self.mesh.grid]
            self._dev_version = version
        return self._dev_arrays

    def match_encoded(self, ttok: np.ndarray, tlen: np.ndarray,
                      tdollar: np.ndarray) -> ShardedResult:
        """→ the packed bitmap shards and the per-topic counts."""
        arrays = self._refresh()
        b = ttok.shape[0]
        if b % self.dp:
            raise ValueError(f"batch {b} does not divide over dp={self.dp}")
        bl = b // self.dp
        packed, parts = [], []
        for i, row in enumerate(self.mesh.grid):
            sl = slice(i * bl, (i + 1) * bl)
            host = (np.ascontiguousarray(ttok[sl], dtype=np.int32),
                    np.ascontiguousarray(tlen[sl], dtype=np.int32),
                    np.ascontiguousarray(tdollar[sl], dtype=bool))
            shards, cnts = [], []
            for dev, dev_arrays in zip(row, arrays[i]):
                p = match_packed(*dev_arrays, *(to_device(a, dev) for a in host))
                shards.append(p)
                cnts.append(_popcount32(p).sum(dim=1))
            packed.append(shards)
            parts.append(cnts)
        counts = []
        for row, cnts in zip(self.mesh.grid, parts):
            total = cnts[0]
            for c in cnts[1:]:
                total = total + c.to(row[0])
            counts.append(total.to(torch.int32))
        return ShardedResult(packed, counts)

    @staticmethod
    def assemble(res: ShardedResult) -> Tuple[np.ndarray, np.ndarray]:
        """The whole bitmap ``[B, cap/32]`` int32 and the counts ``[B]`` on
        the host (the shards fetched one by one)."""
        rows = [np.concatenate([fetch(p, "sharded bitmap fetch") for p in shards], axis=1)
                for shards in res.packed]
        counts = [fetch(c, "sharded counts fetch") for c in res.counts]
        return np.concatenate(rows, axis=0), np.concatenate(counts)


class ShardedPartitionedMatcher:
    """The partitioned-automaton matcher over a device mesh: the table
    replicated, the publish batch sharded across every mesh device
    (raft-analogue data parallelism, router.rs:199-201 — the match is local
    to each device's topic slice, no per-publish collective).

    Each device holds a copy of the LEGACY ``[up_chunks, L+3, CHUNK]``
    int16/int32 tiles (``pack_device_rows``) and, for the fused pipeline,
    of the row→fid map; the delta refresh scatters the dirty chunks into
    every copy. A batch is padded to a multiple of the device count; each
    device launches the legacy words kernel on its topic slice, then its
    compaction: ``fused_compact_decode`` (``_fused`` None or True, the
    default), ``compact_global`` (``RMQTT_FUSED=0``) or ``compact_words``
    (``RMQTT_COMPACT=topk``). Shard-major order is topic-major order, so the
    host reattributes slots from the concatenated per-device counts. The
    JAX matcher's first-use verify race of the fused path (which falls back
    on an exception or a disagreement) is not ported: as in the port's
    ``PartitionedMatcher`` the fused path runs and its AssertionErrors
    propagate."""

    def __init__(self, table, mesh: Mesh, max_words: int = 32,
                 compact: Optional[str] = None) -> None:
        self.table = table
        self.mesh = mesh
        self.devices: List[torch.device] = list(mesh.flat)
        self.ndev = len(self.devices)
        self.max_words = max_words
        self.compact_mode = compact or os.environ.get("RMQTT_COMPACT", "global")
        self._budgets: Dict[int, int] = {}  # padded batch -> sticky per-device slots
        env_fused = os.environ.get("RMQTT_FUSED", "")
        self._fused: Optional[bool] = (
            False if env_fused == "0" or self.compact_mode != "global"
            else (True if env_fused == "1" else None))
        self.fused_batches = 0
        self._dev_version = -1
        self._dev_rows: Optional[List[torch.Tensor]] = None
        self._dev_fids: Optional[List[torch.Tensor]] = None
        self.delta_enabled = os.environ.get("RMQTT_DELTA_UPLOADS", "1") != "0"
        self._dev_epoch = -1
        self._dev_lvl = -1
        self._dev_dtype = None
        self._dev_up_chunks = 0
        self._dev_fid_map = None
        self.uploads = 0
        self.full_uploads = 0
        self.delta_uploads = 0
        self.upload_bytes = 0

    # ------------------------------------------------------ device mirror
    def _scatter_all(self, dst: List[torch.Tensor], cids, vals: np.ndarray) -> None:
        """``vals`` into the chunks ``cids`` of every device's copy, in place
        (a match is synchronous here, so no batch in flight reads them)."""
        for a in dst:
            a.index_copy_(0, to_device(np.asarray(cids, dtype=np.int64), a.device),
                          to_device(vals, a.device))

    def _refresh(self) -> List[torch.Tensor]:
        from rmqtt_tpu_torch.ops.partitioned import (delta_chunk_plan, pack_chunk_tiles,
                                                     pack_device_rows,
                                                     pack_fid_chunk_tiles, pack_fid_rows)

        t = self.table
        if self._dev_version == t.version and self._dev_rows is not None:
            return self._dev_rows
        if _FP_UPLOAD.action is not None:  # chaos seam (utils/failpoints.py)
            _FP_UPLOAD.fire_sync()
        want_fids = self._fused is not False and self.compact_mode == "global"
        with t._mu:
            if self._dev_version == t.version and self._dev_rows is not None:
                return self._dev_rows
            dt = np.int16 if not t._tok_wide else np.int32
            cids = delta_chunk_plan(
                t, enabled=self.delta_enabled, dev_version=self._dev_version,
                has_resident=self._dev_rows is not None, dev_epoch=self._dev_epoch,
                dev_lvl=self._dev_lvl, dev_dtype=self._dev_dtype, dt=dt,
                dev_up_chunks=self._dev_up_chunks)
            if cids is not None and not (want_fids and self._dev_fids is None):
                if not want_fids and self._dev_fids is not None:
                    # fused ruled out after the fid map went resident: drop
                    # it so delta refreshes stop shipping rows nothing reads
                    self._dev_fids = None
                if cids:
                    tiles = pack_chunk_tiles(t, cids, dt)
                    ftiles = (pack_fid_chunk_tiles(t, cids)
                              if want_fids and self._dev_fids is not None else None)
                    bucket = 1 << (len(cids) - 1).bit_length()
                    for name, dst, vals in (("sharded_delta_scatter", self._dev_rows, tiles),
                                            ("sharded_delta_scatter_fids", self._dev_fids,
                                             ftiles)):
                        if vals is None:
                            continue
                        if _DEVPROF.enabled:
                            _pj(name, self._scatter_all, dst, cids, vals,
                                _key=_DEVPROF.key_of((dst[0],), {}) + (bucket,))
                        else:
                            self._scatter_all(dst, cids, vals)
                    self.uploads += 1
                    self.delta_uploads += 1
                    nb = tiles.nbytes + (ftiles.nbytes if ftiles is not None else 0)
                    self.upload_bytes += nb
                    if _DEVPROF.enabled:
                        _DEVPROF.note_upload("delta", nb)
                self._dev_version = t.version
                self._dev_fid_map = t._fid_of_row
                return self._dev_rows
            # full path: pack + capture under the lock, transfer outside it
            # (the replicated put must not stall subscribes); mutations
            # landing during the transfer stay pending via the version
            packed = pack_device_rows(t)
            fids2d = pack_fid_rows(t) if want_fids else None
            version, epoch, lvl = t.version, t.layout_epoch, t.max_levels
            fid_map = t._fid_of_row
        self._dev_rows = [to_device(packed, d) for d in self.devices]
        self._dev_fids = ([to_device(fids2d, d) for d in self.devices]
                          if fids2d is not None else None)
        self._dev_version = version
        self._dev_epoch = epoch
        self._dev_lvl = lvl
        self._dev_dtype = dt
        self._dev_up_chunks = packed.shape[0]
        self._dev_fid_map = fid_map
        self.uploads += 1
        self.full_uploads += 1
        nb = packed.nbytes + (fids2d.nbytes if fids2d is not None else 0)
        self.upload_bytes += nb
        if _DEVPROF.enabled:
            _DEVPROF.note_upload("full", nb)
        return self._dev_rows

    def hbm_breakdown(self) -> dict:
        """Device-memory model of the replicated table: logical bytes ×
        replica count (the table is replicated on every mesh device)."""

        def nb(a) -> int:
            return a[0].numel() * a[0].element_size() if a else 0

        tiles, fid = nb(self._dev_rows), nb(self._dev_fids)
        return {
            "layout": "legacy",
            "tiles_bytes": tiles,
            "fid_map_bytes": fid,
            "segments": 0,
            "replicas": self.ndev,
            "overlay_journal_entries": len(getattr(self.table, "_fid_undo_v", ())),
            "total_bytes": (tiles + fid) * self.ndev,
        }

    # ------------------------------------------------------------ match
    def match(self, topics) -> list:
        from rmqtt_tpu_torch.ops.partitioned import _decode_batch

        t = self.table
        if getattr(t, "compact_async", False):
            t.maybe_compact_async()
        elif hasattr(t, "needs_compact") and t.needs_compact():
            t.compact()
        b = len(topics)
        if b == 0:
            return []
        padded = max(self.ndev, 1 << (b - 1).bit_length() if b > 1 else 1)
        if padded % self.ndev:
            padded = self.ndev * ((padded + self.ndev - 1) // self.ndev)
        while True:
            enc, enc_epoch = t.encode_topics_versioned(topics, pad_batch_to=padded)
            ttok, tlen, tdollar, chunk_ids, _nc = enc
            rows = self._refresh()
            if self._dev_epoch == enc_epoch:
                break
            # a background compaction installed between encode and refresh:
            # chunk ids reference the old layout — re-encode (rare)
        bl = padded // self.ndev
        # the words kernels take int32 inputs throughout
        host = tuple(np.asarray(a, dtype=np.int32) for a in (ttok, tlen, tdollar, chunk_ids))
        inputs = [tuple(to_device(np.ascontiguousarray(a[d * bl:(d + 1) * bl]), dev)
                        for a in host)
                  for d, dev in enumerate(self.devices)]
        # the words of every device, launched in turn before any is read
        words = [words_any(rows[d], *inputs[d]) for d in range(self.ndev)]
        if self.compact_mode == "global":
            if self._fused is not False and self._dev_fids is not None:
                out = self._match_fused(words, inputs, b, padded)
                self.fused_batches += 1
                return out
            return self._match_global_unfused(words, chunk_ids, b, padded)
        while True:
            wires = [_topk_wire(w, self.max_words) for w in words]
            parts = [fetch(w, "sharded match fetch") for w in wires]
            k = (parts[0].size - bl) // (2 * bl)
            wi = np.concatenate([p[:bl * k].reshape(bl, k) for p in parts])
            wb = np.concatenate([p[bl * k:2 * bl * k].reshape(bl, k) for p in parts])
            cn = np.concatenate([p[2 * bl * k:] for p in parts])
            if int(cn[:b].max(initial=0)) <= self.max_words:
                break
            # rare overflow: compact the same words again, wider
            self.max_words = 1 << (int(cn[:b].max()) - 1).bit_length()
        wb = wb.view(np.uint32)
        return self._decode_revalidated(
            lambda fid_map, overlay, strict: _decode_batch(
                wi[:b], wb[:b], chunk_ids[:b], b, fid_map,
                overlay=overlay, strict=strict))

    def _decode_state(self):
        """The refresh-time fid map plus the undo overlay for mutations that
        landed during the device round trip."""
        t = self.table
        fid_map = self._dev_fid_map if self._dev_fid_map is not None else t._fid_of_row
        overlay, ok = t.fid_overlay(self._dev_version, self._dev_epoch)
        return fid_map, (overlay or None) if ok else None, ok

    def _decode_revalidated(self, decode):
        """Decode lock-free, then revalidate ``table.version`` under the
        lock: unchanged proves no in-place fid-map write raced the decode;
        changed (a rare raced mutation) decodes again under the lock."""
        t = self.table
        v0 = t.version
        res = decode(*self._decode_state())
        with t._mu:
            if t.version == v0:
                return res
            return decode(*self._decode_state())

    def _budget(self, padded: int) -> int:
        gd = self._budgets.get(padded)
        if gd is None:
            gd = max(256, 1 << (4 * (padded // self.ndev) - 1).bit_length())
            self._budgets[padded] = gd
        return gd

    def _regrow(self, padded: int, mx: int) -> int:
        gd = 1 << max(8, (mx - 1).bit_length())
        self._budgets[padded] = max(self._budgets[padded], gd)
        return gd

    def _step(self, name: str, fn, gd: int, *args):
        """One sharded step (every device's tail): a profiled seam keyed on
        the first device's inputs and the budget, as the JAX step's
        closure bakes the budget in."""
        if not _DEVPROF.enabled:
            return fn(*args)
        return _pj(name, fn, *args,
                   _key=_DEVPROF.key_of(tuple(a[0] for a in args), {}) + ("budget", gd))

    def _match_fused(self, words, inputs, b: int, padded: int) -> list:
        """Fused wire: per device ``[fids(gd)... | cnts(bl)...]`` int32 —
        final GLOBAL fids, device-sorted per topic; host work is np.split."""
        bl = padded // self.ndev
        gd = self._budget(padded)
        cids = [ins[3] for ins in inputs]

        def tails(words, fids, cids):
            return [fused_compact_decode(w, f, c, gd) for w, f, c in zip(words, fids, cids)]

        while True:
            wires = self._step("sharded_fused", tails, gd, words, self._dev_fids, cids)
            per_dev = np.stack([fetch(w, "sharded fused fetch") for w in wires])
            cn = per_dev[:, gd:].astype(np.int64)
            totals = cn.sum(axis=1)
            mx = int(totals.max(initial=0))
            if mx <= gd:
                break
            gd = self._regrow(padded, mx)
        flat_cn = cn.ravel()
        if flat_cn[b:].any():
            raise AssertionError("padded topic produced routes — device bug")
        parts = [per_dev[i, :int(totals[i])].astype(np.int64) for i in range(self.ndev)]
        flat = np.concatenate(parts)
        if flat.size and int(flat.min()) < 0:
            raise AssertionError("cleared-row fid escaped the fused device decode")
        return np.split(flat, np.cumsum(flat_cn[:b - 1]))

    def _match_global_unfused(self, words, chunk_ids, b: int, padded: int) -> list:
        from rmqtt_tpu_torch.ops.partitioned import _decode_routes

        gd = self._budget(padded)

        def tails(words):
            return [compact_global(w, gd) for w in words]

        while True:
            # per device [routes(gd)... | cnts(bl)...], uint16 or uint32
            wires = self._step("sharded_global", tails, gd, words)
            per_dev = np.stack([_unsigned(fetch(w, "sharded match fetch")) for w in wires])
            cn = per_dev[:, gd:].astype(np.int64)  # [ndev, bl], shard-major
            totals = cn.sum(axis=1)
            mx = int(totals.max(initial=0))
            if mx <= gd:
                break
            # a shard overflowed its slice: regrow (sticky) and compact again
            gd = self._regrow(padded, mx)
        parts = [per_dev[i, :int(totals[i])] for i in range(self.ndev)]
        return self._decode_revalidated(
            lambda fid_map, overlay, strict: _decode_routes(
                np.concatenate(parts), cn.ravel(), chunk_ids, b, fid_map,
                overlay=overlay, strict=strict))
