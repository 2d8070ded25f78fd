"""Process resource probes.

One definition of "resident set size" shared by the overload sampler
(`broker/overload.py`), the admin gauges (`ServerContext.stats()`,
`http_api.sysinfo`), and the bench/scenario runners (`rmqtt_tpu_torch/bench`,
`scripts/soak_bench.py`, ...) — previously each carried its own
/proc-parsing copy with subtly different fallbacks.
"""

from __future__ import annotations

from typing import Optional


def rss_mb(pid: Optional[int] = None) -> float:
    """Resident set of ``pid`` (default: this process) in MB.

    Reads ``/proc/<pid>/status`` VmRSS; returns 0.0 where /proc is
    unavailable (non-Linux) or the process is gone — callers treat 0.0 as
    "no signal", never as "no memory"."""
    path = f"/proc/{pid}/status" if pid else "/proc/self/status"
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0
