"""The dense retained-message topic scan (the SUBSCRIBE-side full scan).

The reference scans its ``RetainTree`` on every SUBSCRIBE to replay
retained messages (`rmqtt/src/retain.rs:373-450`). Here the stored retained
*topic names* are rows of a ``FilterTable`` on the device and a batch of
newly subscribed wildcard filters is resolved against all of them in one
launch of the inverse kernel (``ops.match.match_retained``): the dense
automaton reused in the other direction. The port of the JAX package's
``ops/retained.py``; ``ops/retained_part.py`` holds the partitioned scanner
the broker uses.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rmqtt_tpu_torch.ops.encode import FilterTable
from rmqtt_tpu_torch.ops.match import match_retained, unpack_bitmap
from rmqtt_tpu_torch.ops.partitioned import resolve_device, to_device
from rmqtt_tpu_torch.utils.devfetch import fetch


class RetainedScanner:
    """Device mirror of a retained-topics table + batched inverse match.
    The mirror is uploaded whole whenever the table's version changed.
    Entry points run on CUDA unless the caller passes ``device="cpu"``."""

    def __init__(self, table: FilterTable, device=None) -> None:
        self.table = table
        self.device = resolve_device(device)
        self._dev_version = -1
        self._dev_arrays: Optional[Tuple[torch.Tensor, ...]] = None

    def _refresh(self) -> Tuple[torch.Tensor, ...]:
        t = self.table
        if self._dev_version != t.version or self._dev_arrays is None:
            version = t.version
            self._dev_arrays = tuple(to_device(a, self.device)
                                     for a in (t.tok, t.flen, t.row_dollar))
            self._dev_version = version
        return self._dev_arrays

    def scan_encoded(self, ftok, flen, fprefix, fhash, fwild) -> torch.Tensor:
        """Encoded filters (numpy, as ``FilterTable.encode_filters`` gives
        them) → device bitmap ``[B, capacity // 32]``."""
        rtok, rlen, rdollar = self._refresh()
        put = lambda a, dt: to_device(np.asarray(a, dtype=dt), self.device)  # noqa: E731
        return match_retained(rtok, rlen, rdollar, put(ftok, np.int32),
                              put(flen, np.int32), put(fprefix, np.int32),
                              put(fhash, bool), put(fwild, bool))

    def scan(self, filters: Sequence[str], pad_to_pow2: bool = True) -> List[np.ndarray]:
        """→ per-filter arrays of matched retained-topic row ids."""
        b = len(filters)
        padded = 1 << (b - 1).bit_length() if (pad_to_pow2 and b > 1) else b
        enc = self.table.encode_filters(filters, pad_batch_to=padded)
        packed = fetch(self.scan_encoded(*enc), "retained scan fetch")
        return unpack_bitmap(packed[:b], nrows=self.table.capacity)
