"""The partitioned match's compaction tails: the CUDA kernels' wrappers and
their plain twins.

Both read the match words ``[B, W]`` int32 (``W = NC*4`` uint32 words a
topic; bit ``i`` of word ``w`` is row ``(w%4)*32 + i`` of the topic's
candidate chunk ``w//4``) and write one wire ``[budget + B]``: the first
``budget`` routes in flat (topic, word, bit) order, zeros in the slots
they leave unfilled, then each topic's route count (its words' popcount,
whatever the budget, so ``counts.sum() > budget`` signals overflow).

- :func:`fused_compact_decode` — the fused path's tail: each kept route
  resolves through ``chunk_ids`` and the row→fid map ``fid_rows`` to its
  fid, and each topic's fids come sorted (signed: a ``-1``, a cleared row,
  first); int32. Kernel: ``csrc/compact_tail.cu``
  ``launch_fused_compact_decode``, in place of the JAX package's
  ``fused_compact_decode_impl``. Plain twin:
  :func:`fused_compact_decode_plain`.
- :func:`compact_global` — the unfused global path's tail: each kept
  route as ``word*32 + bit``; one width for routes and counts, 16 bits
  while ``W*32 < 0x10000`` (int16 holding uint16 values), else int32.
  Kernel: ``launch_compact_global``, in place of ``compact_global_impl``.
  Plain twin: :func:`compact_global_plain`.

A wrapper given CPU tensors runs its plain twin; given CUDA tensors it
launches its kernel or raises — it never falls back. Each wrapper counts
its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from rmqtt_tpu_torch.ops.match_words import CHUNK, WORDS_PER_CHUNK, _raise_on


def _popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as uint32) → int64. PyTorch has no
    popcount: this is the SWAR bit count on int64."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def fused_compact_decode_plain(words: torch.Tensor, fid_rows: torch.Tensor,
                               chunk_ids: torch.Tensor, budget: int) -> torch.Tensor:
    """Match words → final per-topic fid buffer in torch ops (twin of the
    JAX ``fused_compact_decode_impl`` and of the fused tail kernel).

    1. word compaction — an exclusive prefix sum over the nonzero-word mask
       gives each nonzero word a slot of the shared ``budget``; the slot
       remembers the word's flat index (topic, word) and its bits;
    2. route expansion — a second prefix sum over the compacted words' set
       bits gives each matched row a slot; the row's global id
       ``chunk_ids[topic, w//4]*CHUNK + (w%4)*32 + bit`` resolves to its
       fid through ``fid_rows``;
    3. one sort on the int64 key ``topic * 2**32 + (fid + 2**31)`` puts the
       buffer in (topic, fid) order — the offset keeps the signed order, so
       a -1 fid (a cleared row) sorts exactly as in JAX's two-key sort.

    Slots past the budget go to a sentinel slot ``budget`` that is sliced
    off (JAX drops them with ``mode="drop"``). Unfilled slots carry the
    sentinel topic B and sort last. → ``[budget + B]`` int32
    ``[fids..., cnts...]``."""
    b, w = words.shape
    dev = words.device
    cnts = _popcount32(words).sum(dim=1)
    if b == 0:
        return torch.zeros(budget, dtype=torch.int32, device=dev)
    cid = chunk_ids.to(torch.int64)
    flat = words.reshape(-1)
    nz = flat != 0
    nzi = nz.to(torch.int64)
    pos = torch.cumsum(nzi, 0) - nzi
    idx = torch.where(nz & (pos < budget), pos, budget)
    src = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    src[idx] = torch.arange(b * w, dtype=torch.int64, device=dev)
    bits = torch.zeros(budget + 1, dtype=torch.int32, device=dev)
    bits[idx] = flat
    src, bits = src[:budget], bits[:budget]
    wtop, widx = src // w, src % w  # unfilled slots: (0, 0) with no bits
    lanes = torch.arange(32, dtype=torch.int32, device=dev)
    rnzi = ((bits[:, None] >> lanes) & 1).reshape(-1).to(torch.int64)
    rpos = torch.cumsum(rnzi, 0) - rnzi
    ridx = torch.where((rnzi > 0) & (rpos < budget), rpos, budget)
    wpc = WORDS_PER_CHUNK
    rows = (cid[wtop, widx // wpc] * CHUNK + (widx % wpc) * 32)[:, None] + lanes
    fvals = fid_rows.reshape(-1)[rows.reshape(-1)].to(torch.int64)
    tj = torch.full((budget + 1,), b, dtype=torch.int64, device=dev)
    tj[ridx] = wtop[:, None].expand(budget, 32).reshape(-1)
    fids = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    fids[ridx] = fvals
    key = tj[:budget] * (1 << 32) + (fids[:budget] + (1 << 31))
    fid_s = (torch.sort(key).values & 0xFFFFFFFF) - (1 << 31)
    return torch.cat([fid_s.to(torch.int32), cnts.to(torch.int32)])


def compact_global_plain(words: torch.Tensor, budget: int) -> torch.Tensor:
    """Match words → batch-global ROUTE compaction in torch ops (twin of the
    JAX ``compact_global_impl`` and of the ``compact_global`` kernel):

    1. word compaction — an exclusive prefix sum over the nonzero-word mask
       gives each nonzero word a slot of the shared ``budget``; the slot
       keeps the word's index within its topic and its bits;
    2. route expansion — a second prefix sum over the compacted words' set
       bits gives each matched row a slot holding ``widx*32 + bit``.

    Slots fill in flat (topic, word, bit) order, so the per-topic counts
    reattribute them on the host. Slots past the budget go to a sentinel
    slot ``budget`` that is sliced off (JAX drops them with
    ``mode="drop"``). One width for routes and counts, as in JAX: 16 bits
    while ``w*32 < 0x10000`` (a count can reach ``w*32``), else 32, held in
    int16 / int32 (``partitioned._unsigned`` reads them as the JAX
    package's uint16 / uint32). → ``[budget + B]`` ``[routes..., cnts...]``."""
    b, w = words.shape
    dev = words.device
    cnts = _popcount32(words).sum(dim=1)
    flat = words.reshape(-1)
    nz = flat != 0
    nzi = nz.to(torch.int64)
    pos = torch.cumsum(nzi, 0) - nzi
    idx = torch.where(nz & (pos < budget), pos, budget)
    widx = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    widx[idx] = torch.arange(w, dtype=torch.int64, device=dev).repeat(b)
    bits = torch.zeros(budget + 1, dtype=torch.int32, device=dev)
    bits[idx] = flat
    widx, bits = widx[:budget], bits[:budget]
    lanes = torch.arange(32, dtype=torch.int32, device=dev)
    rnzi = ((bits[:, None] >> lanes) & 1).reshape(-1).to(torch.int64)
    rpos = torch.cumsum(rnzi, 0) - rnzi
    ridx = torch.where((rnzi > 0) & (rpos < budget), rpos, budget)
    routes = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    routes[ridx] = (widx[:, None] * 32 + lanes).reshape(-1)
    wire = torch.cat([routes[:budget], cnts])
    return wire.to(torch.int16 if w * 32 < 0x10000 else torch.int32)


def _check_cuda(name: str, words: torch.Tensor, budget: int, **others) -> None:
    dev = words.device
    for arg, t in (("words", words), *others.items()):
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, words on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} dtype {t.dtype}, expected torch.int32")
    if words.dim() != 2:
        raise ValueError(f"{name}: words {tuple(words.shape)} are not [B, W]")
    b, w = words.shape
    if not 0 <= budget < 1 << 31 or b + budget >= 1 << 31 or w * 32 >= 1 << 31:
        raise ValueError(f"{name}: budget {budget} with words {(b, w)} exceed "
                         f"the int32 indices")


def _wire(lib, b: int, budget: int, dtype, dev) -> torch.Tensor:
    """The ``[budget + B]`` wire, in an allocation that also holds what the
    launch needs past it (``compact_tail_scratch_bytes``, from the wire's
    end rounded up to 16 bytes; none on the one-launch path)."""
    extra = lib.compact_tail_scratch_bytes(b, budget)
    if extra < 0:
        raise ValueError(f"compaction tail: no scratch size for B={b}, budget {budget}")
    wire = (budget + b) * (4 if dtype == torch.int32 else 2)
    nbytes = -(-wire // 16) * 16 + extra if extra else wire
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)[:wire].view(dtype)


def launch_fused(lib, words: torch.Tensor, fid_rows: torch.Tensor,
                 chunk_ids: torch.Tensor, budget: int) -> torch.Tensor:
    """One call of ``lib``'s ``launch_fused_compact_decode`` on checked
    tensors, on the current stream of their device; counts nothing. The
    wrapper passes the kernel library; a benchmark may pass another build
    of the source."""
    b, w = words.shape
    dev = words.device
    out = _wire(lib, b, budget, torch.int32, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.launch_fused_compact_decode(
            words.data_ptr(), w, fid_rows.data_ptr(), fid_rows.numel() // CHUNK,
            chunk_ids.data_ptr(), chunk_ids.shape[1], b, budget, out.data_ptr(), stream)
    _raise_on(err, "fused_compact_decode")
    return out


def launch_global(lib, words: torch.Tensor, budget: int) -> torch.Tensor:
    """One call of ``lib``'s ``launch_compact_global``, as
    :func:`launch_fused`."""
    b, w = words.shape
    wide = w * 32 >= 0x10000
    dev = words.device
    out = _wire(lib, b, budget, torch.int32 if wide else torch.int16, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.launch_compact_global(words.data_ptr(), w, b, budget, out.data_ptr(),
                                        int(wide), stream)
    _raise_on(err, "compact_global")
    return out


def fused_compact_decode(words: torch.Tensor, fid_rows: torch.Tensor,
                         chunk_ids: torch.Tensor, budget: int) -> torch.Tensor:
    """The fused tail ``[budget + B]`` int32 ``[fids..., cnts...]``. CUDA
    tensors (int32, contiguous, one device; ``chunk_ids [B, W/4]``) launch
    the kernel; CPU tensors run the plain twin."""
    if words.device.type == "cpu":
        return fused_compact_decode_plain(words, fid_rows, chunk_ids, budget)
    name = "fused_compact_decode"
    if words.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {words.device}")
    _check_cuda(name, words, budget, fid_rows=fid_rows, chunk_ids=chunk_ids)
    b, w = words.shape
    if chunk_ids.dim() != 2 or chunk_ids.shape[0] != b \
            or chunk_ids.shape[1] * WORDS_PER_CHUNK != w:
        raise ValueError(f"{name}: chunk_ids {tuple(chunk_ids.shape)} do not fit "
                         f"words {(b, w)}")
    if fid_rows.numel() == 0 or fid_rows.numel() % CHUNK \
            or fid_rows.numel() // CHUNK >= 1 << 31:
        raise ValueError(f"{name}: fid_rows {tuple(fid_rows.shape)} are not "
                         f"[chunks, {CHUNK}]")
    from rmqtt_tpu_torch.ops._build import kernel_library

    out = launch_fused(kernel_library().lib, words, fid_rows, chunk_ids, budget)
    fused_compact_decode.launches += 1
    return out


fused_compact_decode.launches = 0


def compact_global(words: torch.Tensor, budget: int) -> torch.Tensor:
    """The unfused global wire ``[budget + B]`` ``[routes..., cnts...]``,
    int16 while ``W*32 < 0x10000``, else int32. CUDA tensors (int32,
    contiguous) launch the kernel; CPU tensors run the plain twin."""
    if words.device.type == "cpu":
        return compact_global_plain(words, budget)
    name = "compact_global"
    if words.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {words.device}")
    _check_cuda(name, words, budget)
    from rmqtt_tpu_torch.ops._build import kernel_library

    out = launch_global(kernel_library().lib, words, budget)
    compact_global.launches += 1
    return out


compact_global.launches = 0
