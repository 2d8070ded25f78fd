"""The partitioned match's compaction tails: the CUDA kernels' wrappers and
their plain twins.

Each reads the match words ``[B, W]`` int32 (``W = NC*4`` uint32 words a
topic; bit ``i`` of word ``w`` is row ``(w%4)*32 + i`` of the topic's
candidate chunk ``w//4``). The two global tails write one wire
``[budget + B]``: the first
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
- :func:`compact_words` — the topk mode's tail: each topic's first
  ``K = min(max_words, W)`` nonzero word indices ascending, then its
  lowest-index zero words, those words and its route count, as one int32
  wire ``[word_idx..., word_bits..., counts...]``.
  Kernel: ``csrc/dense_match.cu`` ``launch_dense_match_words`` (the dense
  words path's kernel computes the same function), writing the wire's
  three slices in place, in place of ``compact_words_impl``. Plain twin:
  :func:`match_words_plain` (as a wire, :func:`topk_wire_plain`), which is
  also the twin of the dense backend's ``match_words`` on the same kernel.

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


def match_words_plain(words: torch.Tensor, max_words: int):
    """Match words (or the dense backend's bitmap) → each topic's first
    words in torch ops (twin of the JAX ``compact_words_impl`` and
    ``match_words_impl``'s popcount and ``lax.top_k``, and of the words
    kernel): ``(word_idx [B, K], word_bits [B, K], counts [B])`` int32 with
    ``K = min(max_words, W)``: each topic's first ``min(K, nnz)`` nonzero
    word indices ascending, then its lowest-index zero words ascending
    (``lax.top_k`` puts the lower index first among equal keys), their bits
    (the uint32 words) and the exact match counts (``_popcount32``). The
    keys are unique — a nonzero word ``2W - idx``, a zero word ``W - idx`` —
    so ``torch.topk`` has no ties to order and gives JAX's indices exactly
    (int32 keys: W < 2^30, a row of 2^35 filters). A topic has more than
    ``max_words`` nonzero words only if it has more than ``max_words``
    matches, so ``counts > max_words`` is the exact overflow signal."""
    b, w = words.shape
    k = min(max_words, w)
    counts = _popcount32(words).sum(dim=1).to(torch.int32)
    idx = torch.arange(w, dtype=torch.int32, device=words.device)
    key = torch.where(words != 0, 2 * w - idx, w - idx)
    word_idx = torch.topk(key, k, dim=1).indices
    return word_idx.to(torch.int32), torch.gather(words, 1, word_idx), counts


def topk_wire_plain(words: torch.Tensor, max_words: int) -> torch.Tensor:
    """:func:`match_words_plain`'s three arrays as one int32 wire
    ``[word_idx..., word_bits..., counts...]``."""
    wi, wb, cn = match_words_plain(words, max_words)
    return torch.cat([wi.reshape(-1), wb.reshape(-1), cn])


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


def launch_words(lib, words: torch.Tensor, k: int, name: str = "compact_words"
                 ) -> torch.Tensor:
    """One call of ``lib``'s ``launch_dense_match_words`` on checked words
    (``k <= W``), writing ``word_idx``, ``word_bits`` and ``counts`` into the
    slices of one ``[2*B*k + B]`` int32 wire; counts nothing. As
    :func:`launch_fused`, a benchmark may pass another build of the
    source."""
    b, w = words.shape
    dev = words.device
    out = torch.empty(2 * b * k + b, dtype=torch.int32, device=dev)
    ptr, step = out.data_ptr(), b * k * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.launch_dense_match_words(words.data_ptr(), w, b, k, ptr, ptr + step,
                                           ptr + 2 * step, stream)
    _raise_on(err, name)
    return out


def split_topk_wire(wire: torch.Tensor, b: int, k: int):
    """A topk wire → its ``(word_idx [B, k], word_bits [B, k], counts [B])``
    views."""
    return (wire[:b * k].view(b, k), wire[b * k:2 * b * k].view(b, k), wire[2 * b * k:])


def words_wire(wrapper, words: torch.Tensor, max_words: int) -> torch.Tensor:
    """The words kernel's wire for ``wrapper`` (:func:`compact_words`, or the
    dense backend's ``match_words``), which names the errors and counts the
    launch: CUDA words only. The kernel reads four words a load, so W must
    be a multiple of 4 and the start 16-byte aligned (``words_any``'s ``[B,
    NC*4]`` output and the dense bitmap are)."""
    name = wrapper.__name__
    if words.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {words.device}")
    _check_cuda(name, words, 0)
    b, w = words.shape
    if w % 4 or words.data_ptr() % 16:
        raise ValueError(f"{name}: words need W % 4 == 0 (W = {w}) and a 16-byte "
                         "aligned start")
    if max_words < 0:
        raise ValueError(f"{name}: max_words {max_words} is negative")
    k = min(max_words, w)
    if b == 0:
        return torch.empty(0, dtype=torch.int32, device=words.device)
    from rmqtt_tpu_torch.ops._build import kernel_library

    out = launch_words(kernel_library().lib, words, k, name)
    wrapper.launches += 1
    return out


def compact_words(words: torch.Tensor, max_words: int) -> torch.Tensor:
    """:func:`match_words_plain`'s ``(word_idx, word_bits, counts)`` as the
    one int32 wire ``[word_idx..., word_bits..., counts...]`` that a topk
    batch fetches (:func:`split_topk_wire` gives the three back). A
    contiguous int32 CUDA tensor launches the words kernel
    (:func:`words_wire`), which writes the three slices in place; CPU
    tensors run the plain twin (:func:`topk_wire_plain`)."""
    if words.device.type == "cpu":
        return topk_wire_plain(words, max_words)
    return words_wire(compact_words, words, max_words)


compact_words.launches = 0
