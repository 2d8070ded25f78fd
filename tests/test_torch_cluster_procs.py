"""Three ``python -m rmqtt_tpu_torch.broker --cluster-mode raft`` processes
over real TCP, driven through their listeners: the chaos sequence of the
JAX package's ``tests/test_cluster_procs.py``. A node is SIGTERM'd
mid-traffic and the survivors keep routing; a replacement with the same
id, ports and an empty log rejoins, answers CONNECT and SUBSCRIBE, and
receives a publish routed from another node; a client id taken on another
node kicks the old session across processes. The nodes use the default
trie router, so no card is needed."""

from __future__ import annotations

import asyncio
import os
import signal
import socket
import subprocess
import sys

from tests.mqtt_client import TestClient

#: the whole case, three starts and the rejoin included
LIMIT_S = 60.0


def _free_ports(n: int) -> list:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _spawn_node(node_id: int, port: int, cport: int, peers: list, log) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "rmqtt_tpu_torch.broker",
           "--port", str(port), "--node-id", str(node_id),
           "--cluster-listen", f"127.0.0.1:{cport}", "--cluster-mode", "raft"]
    for nid, pport in peers:
        cmd += ["--peer", f"{nid}@127.0.0.1:{pport}"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.getcwd(), os.environ.get("PYTHONPATH", "")) if p))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=log)


async def _wait_port(port: int, proc: subprocess.Popen) -> None:
    """Until the listener accepts; fails if the process died first (the
    case's own limit bounds the wait)."""
    while True:
        assert proc.poll() is None, f"the node on port {port} exited"
        try:
            _, w = await asyncio.open_connection("127.0.0.1", port)
            w.close()
            return
        except OSError:
            await asyncio.sleep(0.1)


def test_three_process_cluster_with_chaos(tmp_path):
    mports = _free_ports(3)
    cports = _free_ports(3)
    procs = {}

    def spawn(i):  # node 4 is node 3 again: same id, same ports, empty log
        nid = min(i, 3)
        peers = [(j, cports[j - 1]) for j in (1, 2, 3) if j != nid]
        with open(tmp_path / f"node{i}.log", "wb") as log:
            procs[i] = _spawn_node(nid, mports[nid - 1], cports[nid - 1], peers, log)

    async def drive():
        loop = asyncio.get_running_loop()
        for i in (1, 2, 3):
            spawn(i)
        for i in (1, 2, 3):
            await _wait_port(mports[i - 1], procs[i])
        sub = await TestClient.connect(mports[0], "proc-sub")
        ack = await sub.subscribe("pc/+/t", qos=1)
        assert ack.reason_codes[0] < 0x80
        pub = await TestClient.connect(mports[1], "proc-pub")

        async def publish_until_delivered(client, topic, payload):
            """Cross-node route visibility is eventual: publish again each
            second until ``client`` receives ``payload``."""
            while True:
                await pub.publish(topic, payload, qos=1)
                try:
                    p = await client.recv(timeout=1.0)
                    while p.payload != payload:
                        p = await client.recv(timeout=1.0)
                    return p
                except asyncio.TimeoutError:
                    pass

        await publish_until_delivered(sub, "pc/a/t", b"m-before")

        # chaos: SIGTERM node 3 mid-traffic; the survivors keep routing
        procs[3].send_signal(signal.SIGTERM)
        await loop.run_in_executor(None, procs[3].wait, 10)
        await publish_until_delivered(sub, "pc/b/t", b"m-after-kill")

        # the replacement rejoins: its first CONNECT takes the cluster's
        # handshake lock (an hs_lock raft entry) within the client's 5 s
        spawn(4)
        await _wait_port(mports[2], procs[4])
        sub3 = await TestClient.connect(mports[2], "proc-sub3")
        assert sub3.connack.reason_code == 0
        ack = await sub3.subscribe("pc/rejoin/#", qos=1)
        assert ack.reason_codes[0] < 0x80
        await publish_until_delivered(sub3, "pc/rejoin/x", b"to-newbie")

        # cross-process kick: the same client id on another node
        dup = await TestClient.connect(mports[1], "proc-sub")
        assert dup.connack.reason_code == 0
        await asyncio.wait_for(sub.closed.wait(), timeout=5.0)
        for c in (dup, sub3, pub):
            await c.close()

    try:
        asyncio.run(asyncio.wait_for(drive(), timeout=LIMIT_S))
    finally:
        errs = {}
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for i, proc in procs.items():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
            tail = (tmp_path / f"node{i}.log").read_text()[-2000:]
            if tail:
                errs[i] = tail
    # a node exits cleanly on SIGTERM (no traceback)
    for i, tail in errs.items():
        assert "Traceback" not in tail, f"node {i} stderr:\n{tail}"
