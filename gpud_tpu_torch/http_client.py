"""HTTP requests on the standard library (``http.client``), for the
session's v1 streams, the login post and the manager federation's fan-out.

The reference package makes these requests with ``requests`` (and the
fan-out with ``urllib.request``); a host may lack that package, and the
daemon's memory grows with every import. This module gives the three call
shapes those callers need — a POST whose answer is read as a stream, a
JSON POST and a JSON GET — with ``requests``' error contract: a non-2xx
answer raises ``HTTPStatusError`` with the message ``raise_for_status()``
gives, and the status as an attribute. No proxy variable is read: every
request goes to the host its URL names.
"""

from __future__ import annotations

import http.client
import json
import socket
import ssl
from typing import Dict, Iterable, Optional, Tuple, Union
from urllib.parse import urlsplit

CONNECT_TIMEOUT = 10.0


class HTTPStatusError(OSError):
    """A non-2xx answer. ``status`` is the HTTP status code."""

    def __init__(self, status: int, reason: str, url: str) -> None:
        kind = "Client" if 400 <= status < 500 else "Server"
        super().__init__(f"{status} {kind} Error: {reason} for url: {url}")
        self.status = status
        self.reason = reason
        self.url = url


def _connection(url: str, timeout: float) -> Tuple[http.client.HTTPConnection, str]:
    u = urlsplit(url)
    if u.scheme not in ("http", "https") or not u.hostname:
        raise ValueError(f"invalid URL {url!r}")
    path = (u.path or "/") + (f"?{u.query}" if u.query else "")
    if u.scheme == "https":
        conn = http.client.HTTPSConnection(
            u.hostname, u.port, timeout=timeout,
            context=ssl.create_default_context(),
        )
    else:
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    return conn, path


def open_post(
    url: str,
    headers: Dict[str, str],
    body: Union[bytes, Iterable[bytes], None] = b"",
    connect_timeout: float = CONNECT_TIMEOUT,
    read_timeout: Optional[float] = None,
) -> Tuple[http.client.HTTPConnection, http.client.HTTPResponse]:
    """POST ``body`` (bytes, or an iterable sent chunked) and return the
    connection and its response, whose body the caller reads. The connect
    takes at most ``connect_timeout``; reads then wait ``read_timeout``
    (None: as long as the peer keeps the stream open), as ``requests``'
    ``timeout=(connect, read)``. Raises ``HTTPStatusError`` on a non-2xx
    answer and ``OSError`` on a transport failure; the connection is closed
    either way."""
    conn, path = _connection(url, connect_timeout)
    try:
        conn.connect()
        conn.sock.settimeout(read_timeout)
        conn.request("POST", path, body=body, headers=headers)
        resp = conn.getresponse()
        if resp.status >= 400:
            raise HTTPStatusError(resp.status, resp.reason, url)
    except BaseException:
        conn.close()
        raise
    return conn, resp


def shutdown(conn: http.client.HTTPConnection) -> None:
    """Unblock a thread reading or writing ``conn`` from another thread,
    then close it (closing alone does not wake a blocked ``recv``)."""
    sock = conn.sock
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    conn.close()


def post_json(url: str, body: dict, timeout: float) -> dict:
    """POST ``body`` as JSON and return the decoded JSON answer
    (``requests.post(url, json=body, timeout=timeout)``, then
    ``raise_for_status()`` and ``json()``)."""
    data = json.dumps(body).encode("utf-8")
    conn, resp = open_post(
        url, {"Content-Type": "application/json"}, body=data,
        connect_timeout=timeout, read_timeout=timeout,
    )
    try:
        return json.loads(resp.read().decode("utf-8"))
    finally:
        conn.close()


def get_json(url: str, headers: Dict[str, str], timeout: float) -> dict:
    """GET ``url`` and return the decoded JSON answer; the connect and each
    read take at most ``timeout`` (``urllib.request.urlopen(req,
    timeout=timeout)``). Raises ``HTTPStatusError`` on a non-2xx answer and
    ``OSError`` on a transport failure."""
    conn, path = _connection(url, timeout)
    try:
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        if resp.status >= 400:
            raise HTTPStatusError(resp.status, resp.reason, url)
        return json.loads(resp.read().decode("utf-8"))
    finally:
        conn.close()
