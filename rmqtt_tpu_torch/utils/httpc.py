"""Minimal raw asyncio HTTP client (shared by web-hook, auth-http and the
ReductStore bridge — one copy of the connect/TLS/status/body skeleton).

No external deps; Connection: close per request (plugin traffic volumes
don't need pooling). Malformed/empty responses raise ``ConnectionError``
(an OSError subclass) so every caller's network-error handling covers
them; header NAMES are caller-controlled constants, header VALUES are
sanitized against CR/LF injection (MQTT topics may legally contain them).
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional, Tuple
from urllib.parse import urlparse


def _clean(value: str) -> str:
    """Header values must not break the request framing."""
    return value.replace("\r", " ").replace("\n", " ")


async def request(
    url: str,
    method: str = "GET",
    path: Optional[str] = None,
    body: bytes = b"",
    headers: Optional[Dict[str, str]] = None,
    timeout: float = 5.0,
    read_body: bool = False,
) -> Tuple[int, bytes]:
    """→ (status, response_body if read_body else b"").

    ``url`` carries scheme/host/port (and the default path+query);
    ``path`` overrides the target when given."""
    u = urlparse(url)
    port = u.port or (443 if u.scheme == "https" else 80)
    if u.scheme == "https":
        import ssl

        sslctx = ssl.create_default_context()
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(u.hostname, port, ssl=sslctx), timeout
        )
    else:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(u.hostname, port), timeout
        )
    try:
        if path is None:
            path = u.path or "/"
            if u.query:
                path += "?" + u.query
        head = [
            f"{method} {path} HTTP/1.1",
            f"Host: {u.hostname}",
            f"Content-Length: {len(body)}",
            "Connection: close",
        ]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {_clean(str(v))}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()
        status_line = await asyncio.wait_for(reader.readline(), timeout)
        parts = status_line.split()
        if len(parts) < 2 or not parts[1].isdigit():
            raise ConnectionError(f"bad http status line {status_line!r}")
        status = int(parts[1])
        if not read_body:
            return status, b""
        length = 0
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout)
            if line in (b"\r\n", b""):
                break
            k, _, v = line.decode("latin1").partition(":")
            if k.strip().lower() == "content-length":
                length = int(v)
        payload = await asyncio.wait_for(reader.readexactly(length), timeout) if length else b""
        return status, payload
    finally:
        try:
            writer.close()
        except Exception:
            pass
