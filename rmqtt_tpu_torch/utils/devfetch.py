"""Device→host fetch: the one copy of a batch's result back to the host."""

from __future__ import annotations

import numpy as np
import torch


def fetch(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array. On a CUDA tensor this waits for the
    work queued before it on the stream (``np.asarray`` would raise)."""
    return t.cpu().numpy()
