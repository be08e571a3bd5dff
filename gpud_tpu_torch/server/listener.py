"""The HTTP listener of the port's APIs, on the standard library: an
``App``'s route table (``app.py``) served by ``http.server.ThreadingHTTPServer``
in place of the reference's aiohttp site.

The daemon's local API (``server.py``) and the manager's (``manager/
control_plane.py``) both serve on it. Each connection runs on a daemon
thread of its own, TLS handshakes included; an answer leaves in one write
with Nagle off, so no answer waits on the client's delayed ACK. A request
body is read whole (at most 1 MiB, aiohttp's limit) unless its route has
``stream_body``: its handler then reads ``Request.stream`` as the body
arrives, one line at a time. A ``Response`` with ``chunks`` is sent with
the chunked transfer coding, one write per chunk, and ends the connection.
``close`` stops accepting, shuts every open connection down (which wakes a
thread blocked on its socket) and joins the connection threads within a
bound.
"""

from __future__ import annotations

import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, unquote, urlsplit

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.server.app import App, Request, Response

logger = get_logger(__name__)

# aiohttp's limits: a request body of at most 1 MiB, an idle keep-alive
# connection closed after 75 s
MAX_BODY_BYTES = 1024 ** 2
KEEPALIVE_SECONDS = 75.0
HANDSHAKE_SECONDS = 10.0
JOIN_SECONDS = 5.0


class BodyReader:
    """A request body read as it arrives: the chunked transfer coding
    decoded, or ``length`` bytes. ``readline`` returns one line with its
    newline, the unterminated rest at the end, then b""; a line longer
    than ``MAX_BODY_BYTES`` raises ``ValueError``."""

    def __init__(self, rfile, chunked: bool, length: int) -> None:
        self._rfile = rfile
        self._chunked = chunked
        self._left = length
        self._buf = b""
        self._done = False

    def _fill(self) -> bool:
        if self._done:
            return False
        if self._chunked:
            size_line = self._rfile.readline(1024)
            size = int(size_line.split(b";")[0].strip() or b"0", 16) if size_line else 0
            if size == 0:
                while size_line and self._rfile.readline(1024) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                self._done = True
                return False
            data = self._rfile.read(size)
            self._rfile.readline(1024)
        else:
            data = self._rfile.read1(min(self._left, 65536)) if self._left > 0 else b""
            self._left -= len(data)
        if not data:
            self._done = True
            return False
        self._buf += data
        return True

    def readline(self) -> bytes:
        while b"\n" not in self._buf:
            if len(self._buf) > MAX_BODY_BYTES:
                raise ValueError(f"line longer than {MAX_BODY_BYTES} bytes")
            if not self._fill():
                out, self._buf = self._buf, b""
                return out
        i = self._buf.index(b"\n") + 1
        out, self._buf = self._buf[:i], self._buf[i:]
        return out


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    timeout = KEEPALIVE_SECONDS
    # an answer leaves in one write, and nothing waits for a delayed ACK
    disable_nagle_algorithm = True

    def version_string(self) -> str:
        return "tpud"

    def _serve(self) -> None:
        u = urlsplit(self.path)
        path = unquote(u.path)
        app: App = self.server.app
        route, _resp, _match = app.resolve(self.command, path)
        length = self.headers.get("Content-Length")
        chunked = "chunked" in self.headers.get("Transfer-Encoding", "").lower()
        body, stream, resp = b"", None, None
        try:
            n = int(length) if length and not chunked else 0
            if n < 0:
                raise ValueError(length)
            if route is not None and route.stream_body:
                stream = BodyReader(self.rfile, chunked, n)
                # the handler may stop reading mid-body
                self.close_connection = True
            elif chunked:
                body = self._read_chunked()
            elif n:
                if n > MAX_BODY_BYTES:
                    raise OverflowError(n)
                body = self.rfile.read(n)
        except ValueError:
            resp = Response(status=400, body=b"400: Bad Request",
                            content_type="text/plain; charset=utf-8")
        except OverflowError:
            resp = Response(status=413, body=b"413: Request Entity Too Large",
                            content_type="text/plain; charset=utf-8")
        if resp is None:
            req = Request(
                method=self.command,
                path=path,
                query=dict(reversed(parse_qsl(u.query, keep_blank_values=True))),
                body=body,
                headers=self.headers,
                stream=stream,
            )
            resp = app.handle(req)
        else:
            self.close_connection = True
        if resp.chunks is not None:
            self._send_chunked(resp)
            return
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        for k, v in resp.headers.items():
            self.send_header(k, v)
        self._headers_buffer.append(b"\r\n")
        if self.command != "HEAD":
            self._headers_buffer.append(resp.body)
        self.flush_headers()

    def _send_chunked(self, resp: Response) -> None:
        """Headers, then one write per chunk and the last chunk; the
        connection ends with the stream. A failed write closes the
        iterator, so a generator's ``finally`` runs on this thread."""
        self.close_connection = True
        chunks = iter(resp.chunks)
        try:
            self.send_response(resp.status)
            self.send_header("Content-Type", resp.content_type)
            self.send_header("Transfer-Encoding", "chunked")
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.end_headers()
            for chunk in chunks:
                if chunk:
                    self.wfile.write(b"%X\r\n%s\r\n" % (len(chunk), chunk))
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass  # the client went away
        finally:
            close = getattr(chunks, "close", None)
            if close is not None:
                close()

    def _read_chunked(self) -> bytes:
        out = b""
        while True:
            size = int(self.rfile.readline(1024).split(b";")[0].strip(), 16)
            if size == 0:
                while self.rfile.readline(1024) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                return out
            if len(out) + size > MAX_BODY_BYTES:
                raise OverflowError(len(out) + size)
            out += self.rfile.read(size)
            self.rfile.readline(1024)

    do_GET = do_HEAD = do_POST = do_PUT = do_DELETE = do_PATCH = do_OPTIONS = _serve

    def log_message(self, fmt, *args) -> None:  # noqa: D401 — no access log
        logger.debug("http: " + fmt, *args)


class Listener(ThreadingHTTPServer):
    """One daemon thread per connection, each tracked so ``close`` can
    shut the connection down and join the thread."""

    request_queue_size = 128  # aiohttp's backlog

    def __init__(self, address, app: App, ssl_context=None) -> None:
        self.app = app
        self.ssl_context = ssl_context
        self._mu = threading.Lock()
        self._conns = set()
        self._conn_threads = set()
        super().__init__(address, Handler)

    def process_request(self, request, client_address) -> None:
        t = threading.Thread(target=self._serve_connection, args=(request, client_address),
                             name="tpud-http-conn", daemon=True)
        with self._mu:
            self._conn_threads.add(t)
        t.start()

    def _serve_connection(self, request, client_address) -> None:
        try:
            if self.ssl_context is not None:
                request.settimeout(HANDSHAKE_SECONDS)
                request = self.ssl_context.wrap_socket(request, server_side=True)
            with self._mu:
                self._conns.add(request)
            self.finish_request(request, client_address)
        except Exception:  # noqa: BLE001 — one connection's fault stays its own
            logger.debug("connection from %s failed", client_address, exc_info=True)
        finally:
            with self._mu:
                self._conns.discard(request)
                self._conn_threads.discard(threading.current_thread())
            self.shutdown_request(request)

    def close(self, timeout: float) -> None:
        """Stop accepting, end every open connection and join its thread."""
        self.server_close()
        with self._mu:
            conns, threads = list(self._conns), list(self._conn_threads)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
