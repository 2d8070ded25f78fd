"""Match-words producers: the CUDA kernels' wrappers and their plain twins.

For every topic ``b`` and candidate slot ``k`` the words producer tests the
128 rows of tile ``chunk_ids[b, k]`` against the topic and packs the row
results into four 32-bit words: ``out[b, k*4 + w]`` bit ``i`` is row
``w*32 + i``. A row matches iff every level passes (its token equals the
topic's, is ``+``, or lies beyond the filter's prefix), its length rule
holds (``#`` filters: ``tlen >= prefix_len``; others: ``tlen == flen``) and
it is not a wildcard-first filter against a ``$`` topic.

Two tile formats, one function each, as in the JAX package:

- :func:`match_words_packed` — bit-packed tiles ``[up_chunks, groups*128]``
  int32 (``pack_device_rows_packed``); topic tokens are LEVEL-LOCAL ids.
  Kernel: ``csrc/match_words.cu`` ``launch_match_words_packed``, replacing
  the Pallas ``match_words_pallas_packed``. Plain twin:
  :func:`match_words_packed_plain` (of ``scan_words_packed_impl``).
- :func:`match_words_legacy` — field-major tiles ``[up_chunks, L+3, 128]``
  int16/int32 (``pack_device_rows``); topic tokens are global ids. Kernel:
  ``launch_match_words_legacy``, replacing the Pallas
  ``match_words_pallas``. Plain twin: :func:`match_words_legacy_plain` (of
  ``scan_words_impl``).

Words are int32 tensors bit-identical to the JAX package's uint32 words
(compare through a uint32 view). A wrapper given CPU tensors runs its plain
twin; given CUDA tensors it launches its kernel or raises — it never falls
back. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from rmqtt_tpu_torch.ops._build import KernelError
from rmqtt_tpu_torch.ops.encode import PLUS_TOK, PackedLayout

CHUNK = 128  # rows per tile (ops/partitioned.py CHUNK)
WORDS_PER_CHUNK = CHUNK // 32


def _pack_bits(m: torch.Tensor) -> torch.Tensor:
    """``[B, CHUNK]`` bool → ``[B, WORDS_PER_CHUNK]`` int32, bit i of word w
    = row ``w*32 + i`` (two's-complement view of the uint32 word)."""
    b = m.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=m.device)
    v = (m.reshape(b, WORDS_PER_CHUNK, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _plane(tile: torch.Tensor, p: int) -> torch.Tensor:
    """Byte plane ``p`` of packed tiles ``[.., groups*CHUNK]`` int32."""
    grp, sh = p // 4, (p % 4) * 8
    x = tile[..., grp * CHUNK:(grp + 1) * CHUNK]
    if sh:
        x = x >> sh
    return x & 0xFF


def match_words_packed_plain(tiles, ttok, tlen, tdollar, chunk_ids,
                             layout: PackedLayout) -> torch.Tensor:
    """Plain PyTorch twin of the packed kernel (and of the JAX package's
    ``scan_words_packed_impl``): one tile gather per candidate slot, the
    level formula on ``[B, CHUNK]`` tensors, bits packed per 32 rows.
    → ``[B, NC*4]`` int32."""
    b, nc = chunk_ids.shape
    ttok = ttok.to(torch.int32)
    tlen = tlen.to(torch.int32)[:, None]
    tdollar = tdollar.to(torch.bool)[:, None]
    cid = chunk_ids.to(torch.int64)
    offs = layout.plane_offsets()
    meta_p = layout.planes - 1
    out = torch.empty((b, nc, WORDS_PER_CHUNK), dtype=torch.int32,
                      device=tiles.device)
    for k in range(nc):
        g = tiles[cid[:, k]]  # [B, groups*CHUNK]
        meta = _plane(g, meta_p)
        flen = (meta & 31) - 1  # empty rows encode flen+1 = 0
        hh = (meta >> 5) & 1
        fw = (meta >> 6) & 1
        plen = flen - hh
        ok = torch.ones((b, CHUNK), dtype=torch.bool, device=tiles.device)
        for i, w in enumerate(layout.widths):
            f = _plane(g, offs[i])
            if w == 2:
                f = f | (_plane(g, offs[i] + 1) << 8)
            ok &= (f == ttok[:, i, None]) | (f == PLUS_TOK) | (plen <= i)
        len_ok = torch.where(hh == 1, tlen >= plen, tlen == flen)
        m = ok & len_ok & ~(tdollar & (fw == 1))
        out[:, k] = _pack_bits(m)
    return out.reshape(b, nc * WORDS_PER_CHUNK)


def match_words_legacy_plain(tiles, ttok, tlen, tdollar, chunk_ids) -> torch.Tensor:
    """Plain PyTorch twin of the legacy kernel (and of the JAX package's
    ``scan_words_impl``) over field-major ``[up_chunks, L+3, CHUNK]`` tiles.
    → ``[B, NC*4]`` int32."""
    b, nc = chunk_ids.shape
    lvl = tiles.shape[1] - 3
    ttok = ttok.to(torch.int32)[:, :, None]
    tlen = tlen.to(torch.int32)[:, None]
    tdollar = tdollar.to(torch.bool)[:, None]
    cid = chunk_ids.to(torch.int64)
    lvl_idx = torch.arange(lvl, dtype=torch.int32, device=tiles.device)[None, :, None]
    out = torch.empty((b, nc, WORDS_PER_CHUNK), dtype=torch.int32,
                      device=tiles.device)
    for k in range(nc):
        g = tiles[cid[:, k]].to(torch.int32)  # [B, L+3, CHUNK]
        ftok = g[:, :lvl, :]
        flen = g[:, lvl, :]
        plen = g[:, lvl + 1, :]
        flags = g[:, lvl + 2, :]
        hh = (flags & 1) != 0
        fw = (flags & 2) != 0
        prefix_ok = ((ftok == ttok) | (ftok == PLUS_TOK)
                     | (lvl_idx >= plen[:, None, :])).all(dim=1)
        len_ok = torch.where(hh, tlen >= plen, tlen == flen)
        m = prefix_ok & len_ok & ~(tdollar & fw)
        out[:, k] = _pack_bits(m)
    return out.reshape(b, nc * WORDS_PER_CHUNK)


def _check_cuda(name: str, tiles, tile_dtypes, ttok, tlen, tdollar,
                chunk_ids) -> None:
    dev = tiles.device
    for arg, t in (("tiles", tiles), ("ttok", ttok), ("tlen", tlen),
                   ("tdollar", tdollar), ("chunk_ids", chunk_ids)):
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, tiles on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        want = tile_dtypes if arg == "tiles" else (torch.int32,)
        if t.dtype not in want:
            raise TypeError(f"{name}: {arg} dtype {t.dtype}, expected one of {want}")
    b, nc = chunk_ids.shape
    if ttok.dim() != 2 or ttok.shape[0] != b or tlen.shape != (b,) \
            or tdollar.shape != (b,):
        raise ValueError(
            f"{name}: shapes ttok {tuple(ttok.shape)} tlen {tuple(tlen.shape)} "
            f"tdollar {tuple(tdollar.shape)} do not fit chunk_ids {(b, nc)}")
    if tiles.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: {tiles.shape[0]} tiles exceed the int32 index")
    if tiles.data_ptr() % 16:
        raise ValueError(f"{name}: tiles must start on a 16-byte boundary "
                         f"(the kernel reads four rows per 16-byte load)")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise KernelError(f"{name}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name()})")


def match_words_packed(tiles, ttok, tlen, tdollar, chunk_ids,
                       layout: PackedLayout) -> torch.Tensor:
    """Packed-tile match words ``[B, NC*4]`` int32. CUDA tensors (all int32,
    contiguous, one device) launch the kernel; CPU tensors run the plain
    twin."""
    if tiles.device.type == "cpu":
        return match_words_packed_plain(tiles, ttok, tlen, tdollar, chunk_ids,
                                        layout)
    if tiles.device.type != "cuda":
        raise ValueError(f"match_words_packed: unsupported device {tiles.device}")
    _check_cuda("match_words_packed", tiles, (torch.int32,), ttok, tlen,
                tdollar, chunk_ids)
    if tiles.dim() != 2 or tiles.shape[1] != layout.groups * CHUNK \
            or ttok.shape[1] != layout.nlvl:
        raise ValueError(
            f"match_words_packed: tiles {tuple(tiles.shape)} / ttok "
            f"{tuple(ttok.shape)} do not fit layout {layout}")
    b, nc = chunk_ids.shape
    out = torch.empty((b, nc * WORDS_PER_CHUNK), dtype=torch.int32,
                      device=tiles.device)
    if b == 0 or nc == 0:
        return out
    from rmqtt_tpu_torch.ops._build import kernel_library

    lib = kernel_library().lib
    wide_mask = sum(1 << i for i, w in enumerate(layout.widths) if w == 2)
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        err = lib.launch_match_words_packed(
            tiles.data_ptr(), tiles.shape[0], layout.groups, ttok.data_ptr(),
            layout.nlvl, wide_mask, layout.planes - 1, tlen.data_ptr(),
            tdollar.data_ptr(), chunk_ids.data_ptr(), b, nc, out.data_ptr(),
            stream)
    _raise_on(err, "match_words_packed")
    match_words_packed.launches += 1
    return out


match_words_packed.launches = 0


def match_words_legacy(tiles, ttok, tlen, tdollar, chunk_ids) -> torch.Tensor:
    """Legacy-tile match words ``[B, NC*4]`` int32. CUDA tensors (int16 or
    int32 tiles, int32 inputs, contiguous, one device) launch the kernel;
    CPU tensors run the plain twin."""
    if tiles.device.type == "cpu":
        return match_words_legacy_plain(tiles, ttok, tlen, tdollar, chunk_ids)
    if tiles.device.type != "cuda":
        raise ValueError(f"match_words_legacy: unsupported device {tiles.device}")
    _check_cuda("match_words_legacy", tiles, (torch.int16, torch.int32), ttok,
                tlen, tdollar, chunk_ids)
    if tiles.dim() != 3 or tiles.shape[2] != CHUNK \
            or ttok.shape[1] != tiles.shape[1] - 3:
        raise ValueError(
            f"match_words_legacy: tiles {tuple(tiles.shape)} / ttok "
            f"{tuple(ttok.shape)} are not [n, L+3, {CHUNK}] / [B, L]")
    b, nc = chunk_ids.shape
    out = torch.empty((b, nc * WORDS_PER_CHUNK), dtype=torch.int32,
                      device=tiles.device)
    if b == 0 or nc == 0:
        return out
    from rmqtt_tpu_torch.ops._build import kernel_library

    lib = kernel_library().lib
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        err = lib.launch_match_words_legacy(
            tiles.data_ptr(), tiles.element_size(), tiles.shape[0],
            tiles.shape[1] - 3, ttok.data_ptr(), tlen.data_ptr(),
            tdollar.data_ptr(), chunk_ids.data_ptr(), b, nc, out.data_ptr(),
            stream)
    _raise_on(err, "match_words_legacy")
    match_words_legacy.launches += 1
    return out


match_words_legacy.launches = 0


def words_any(tiles, ttok, tlen, tdollar, chunk_ids,
              layout: Optional[PackedLayout] = None,
              use_kernel: bool = True) -> torch.Tensor:
    """The one words-producer seam (twin of the JAX ``words_any_impl``):
    packed tiles when ``layout`` is given, else legacy; the kernel wrapper
    unless ``use_kernel`` is False, which runs the plain twin on any device
    (the reference run of ``chip_smoke.py``)."""
    if layout is not None:
        fn = match_words_packed if use_kernel else match_words_packed_plain
        return fn(tiles, ttok, tlen, tdollar, chunk_ids, layout)
    fn = match_words_legacy if use_kernel else match_words_legacy_plain
    return fn(tiles, ttok, tlen, tdollar, chunk_ids)
