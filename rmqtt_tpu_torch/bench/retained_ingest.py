"""Retained-publish ingest into a broker child process, with and without
client flow control.

Starts ``python -m rmqtt_tpu_torch.broker`` (``--router``, ``[retain] tpu =
true`` unless ``--no-retain-tpu``) and has 8 clients publish the first
60,000 unique topics of cfg5's retained draw at QoS 0 with RETAIN set,
dealt round-robin, as ``chip_smoke.py`` phase 6d does. With ``--pace N`` a
client waits for a PINGREQ round trip after every N publishes, so it never
runs further ahead of the broker than N publishes; with ``--pace 0`` it
writes as fast as its socket takes them, draining every 64, and ends with
one PINGREQ. It prints
the rate, the broker's stored count and CPU seconds every 2 s, and the CPU
seconds of each broker thread over the ingest (Linux ``/proc``).

Run:  python -m rmqtt_tpu_torch.bench.retained_ingest --router xla --pace 0
      (``--router xla`` needs a CUDA device, as the broker does)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

from rmqtt_tpu_torch.bench.mqtt_load import LoadClient
from rmqtt_tpu_torch.bench.workloads import gen_retained_topics

PUBLISHES = 60_000
CONNECTIONS = 8


def thread_cpu_s(pid: int) -> dict:
    """{thread name:id: CPU seconds} of process ``pid``."""
    out = {}
    for tid in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{tid}/stat") as f:
                st = f.read()
        except OSError:
            continue
        comm = st[st.index("(") + 1:st.rindex(")")]
        fields = st[st.rindex(")") + 2:].split()
        out[f"{comm}:{tid}"] = (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def ingest(port: int, http_port: int, pid: int, topics, conns: int,
                 pace: int) -> None:
    def stats() -> dict:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http_port}/api/v1/stats", timeout=60) as r:
            return json.loads(r.read())[0]["stats"]

    loop = asyncio.get_running_loop()
    pubs = [await LoadClient.connect(port, f"ingest{k}") for k in range(conns)]
    cpu0 = thread_cpu_s(pid)
    t0 = time.perf_counter()
    progress = []

    async def poll() -> None:
        while True:
            await asyncio.sleep(2.0)
            st = await loop.run_in_executor(None, stats)
            progress.append((round(time.perf_counter() - t0, 1), st["retaineds"],
                             round(sum(thread_cpu_s(pid).values()), 1)))

    async def run(k: int, pub: LoadClient) -> None:
        for n, i in enumerate(range(k, len(topics), conns)):
            pub.publish(topics[i], b"r%d" % i, retain=True)
            if pace and n % pace == pace - 1:
                await pub.ping(600)
            elif not pace and n % 64 == 63:
                await pub.writer.drain()
        await pub.ping(600)

    poller = loop.create_task(poll())
    await asyncio.gather(*(run(k, p) for k, p in enumerate(pubs)))
    secs = time.perf_counter() - t0
    poller.cancel()
    cpu1 = thread_cpu_s(pid)
    busy = {k: round(v - cpu0.get(k, 0.0), 2) for k, v in cpu1.items()
            if v - cpu0.get(k, 0.0) > 0.05}
    stored = (await loop.run_in_executor(None, stats))["retaineds"]
    for c in pubs:
        await c.close()
    print(f"progress (s, stored, broker CPU s): {progress}")
    print(f"{len(topics)} retained publishes from {conns} connections, pace {pace}: "
          f"{secs:.3f} s, {len(topics) / secs:.1f} publishes/s, {stored} stored; "
          f"broker CPU s by thread {busy}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--router", choices=["trie", "native", "xla"], default="xla")
    ap.add_argument("--no-retain-tpu", action="store_true")
    ap.add_argument("--pace", type=int, default=256)
    args = ap.parse_args(argv)
    rng = random.Random(5)
    topics = list(dict.fromkeys(gen_retained_topics(rng, 2 * PUBLISHES)))[:PUBLISHES]
    port, http_port = _free_port(), _free_port()
    root = Path(__file__).resolve().parents[2]
    with tempfile.TemporaryDirectory(prefix="retained_ingest_") as tmp:
        cfg = Path(tmp) / "broker.toml"
        cfg.write_text('[listener]\nhost = "127.0.0.1"\n'
                       f'[http_api]\nhost = "127.0.0.1"\nport = {http_port}\n'
                       + ("" if args.no_retain_tpu else "[retain]\ntpu = true\n"))
        with open(Path(tmp) / "broker.log", "wb") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "rmqtt_tpu_torch.broker", "--router", args.router,
                 "--port", str(port), "--config", str(cfg)],
                stdout=log, stderr=subprocess.STDOUT, cwd=root,
                env={**os.environ, "PYTHONPATH": os.pathsep.join(
                    p for p in (str(root), os.environ.get("PYTHONPATH")) if p)})
            try:
                deadline = time.perf_counter() + 300
                while True:
                    if proc.poll() is not None or time.perf_counter() > deadline:
                        raise RuntimeError("broker did not start:\n"
                                           + (Path(tmp) / "broker.log").read_text()[-4000:])
                    try:
                        for p in (port, http_port):
                            socket.create_connection(("127.0.0.1", p), timeout=1).close()
                        break
                    except OSError:
                        time.sleep(0.2)
                asyncio.run(ingest(port, http_port, proc.pid, topics,
                                   CONNECTIONS, args.pace))
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
