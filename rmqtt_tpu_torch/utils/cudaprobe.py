"""Subprocess CUDA probe: the port's counterpart of the JAX package's
``utils/tpuprobe.py``.

A wedged card can make the first in-process CUDA call (driver init,
``torch.cuda.is_available()``) block forever, and a broker that touches
the card at start would then hang instead of failing. So wherever a device
is resolved from the default (``--router xla``, ``TorchRouter()`` with no
device, ``[retain] tpu`` with no device), the card is first counted from
the outside: in a throwaway subprocess, which can be timed out safely.

Unlike the JAX package's ``ensure_safe_platform`` this never falls back to
the CPU: a probe that times out, fails or counts no device raises
``RuntimeError``, so a wedged or missing card refuses the start. An
explicit device (``device="cpu"`` or a CUDA device) skips the probe.
"""

from __future__ import annotations

import logging
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

_LOG = logging.getLogger("rmqtt_tpu_torch.cudaprobe")

#: the child that counts the devices; its last line of output is the count
PROBE_CMD = (sys.executable, "-c", "import torch; print(torch.cuda.device_count())")
PROBE_TIMEOUT_S = 60.0
PROBE_RETRIES = 2

_count: Optional[int] = None  # the default probe's result, memoized per process


def probe_device_count(timeout: float = PROBE_TIMEOUT_S, retries: int = 1,
                       retry_sleep: float = 5.0,
                       cmd: Optional[Sequence[str]] = None) -> int:
    """Count CUDA devices via a throwaway subprocess (``cmd``, by default
    ``PROBE_CMD``); 0 if it times out, fails or prints no count."""
    for attempt in range(retries):
        try:
            r = subprocess.run(list(cmd or PROBE_CMD), timeout=timeout,
                               capture_output=True, text=True)
            if r.returncode == 0:
                return int(r.stdout.strip().splitlines()[-1])
        except (subprocess.TimeoutExpired, ValueError, IndexError, OSError):
            pass
        if attempt + 1 < retries:
            time.sleep(retry_sleep)
    return 0


def require_cuda(timeout: Optional[float] = None, retries: Optional[int] = None,
                 cmd: Optional[Sequence[str]] = None) -> int:
    """→ the CUDA device count, probed in a subprocess before this process
    touches CUDA; raises ``RuntimeError`` when the probe finds none.
    ``timeout`` and ``retries`` default to ``PROBE_TIMEOUT_S`` and
    ``PROBE_RETRIES``.

    The default probe runs once per process (its result, refusal included,
    is memoized); a ``cmd`` of the caller's runs every time. A PyTorch
    built without CUDA refuses without a probe."""
    global _count
    timeout = PROBE_TIMEOUT_S if timeout is None else timeout
    retries = PROBE_RETRIES if retries is None else retries
    no_build = cmd is None and torch.version.cuda is None
    if cmd is None:
        if _count is None:
            if no_build:
                _count = 0
            else:
                t0 = time.perf_counter()
                _count = probe_device_count(timeout, retries)
                _LOG.info("cuda probe: %d device(s) in %.3f s", _count,
                          time.perf_counter() - t0)
        n = _count
    else:
        n = probe_device_count(timeout, retries, cmd=cmd)
    if n <= 0:
        why = ("this PyTorch build has no CUDA" if no_build else
               f"the subprocess probe ({' '.join(cmd or PROBE_CMD)}; "
               f"{timeout:g} s limit, {retries} tries) counted none or did "
               "not answer")
        raise RuntimeError(f"no CUDA device usable: cuda probe: {why}; pass "
                           "device='cpu' to run on the CPU")
    return n
