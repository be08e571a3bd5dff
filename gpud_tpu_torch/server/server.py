"""The daemon with its local API; the port of ``gpud_tpu/server/server.py``.

``Server`` is the port's ``Daemon`` (``gpud_tpu_torch/daemon.py``: what the
reference's ``Server.__init__``, ``start`` and ``stop`` compose) plus the
listener of ``_serve`` (server.py:683-716): the route table of ``app.py``
on ``http.server.ThreadingHTTPServer``, bound at ``config.port`` (0 picks
a free port, which ``port`` then holds; on every interface unless
``TPUD_LISTEN_HOST`` names an address) and wrapped in the self-signed TLS
of ``tls.py`` when ``config.tls``. Each connection is served on a daemon
thread of its own; TLS handshakes run there, never on the accept loop.
``stop`` closes the listener where the reference stops its loop, shuts
down the open connections and joins their threads within a bound.
"""

from __future__ import annotations

import os
import shutil
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl, unquote, urlsplit

from gpud_tpu_torch import sdnotify
from gpud_tpu_torch.daemon import Daemon
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.server import tls
from gpud_tpu_torch.server.app import App, Request, Response

logger = get_logger(__name__)

# aiohttp's limits: a request body of at most 1 MiB, an idle keep-alive
# connection closed after 75 s
MAX_BODY_BYTES = 1024 ** 2
KEEPALIVE_SECONDS = 75.0
HANDSHAKE_SECONDS = 10.0
CERT_SECONDS = 60.0  # the child interpreter that makes the certificate
JOIN_SECONDS = 5.0
# the address the listener binds: the reference's all-interfaces, unless
# the environment names one (127.0.0.1 keeps the API on the host)
DEFAULT_LISTEN_HOST = "0.0.0.0"
ENV_LISTEN_HOST = "TPUD_LISTEN_HOST"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    timeout = KEEPALIVE_SECONDS
    # an answer leaves in one write, and nothing waits for a delayed ACK
    disable_nagle_algorithm = True

    def version_string(self) -> str:
        return "tpud"

    def _serve(self) -> None:
        u = urlsplit(self.path)
        length = self.headers.get("Content-Length")
        chunked = "chunked" in self.headers.get("Transfer-Encoding", "").lower()
        body, resp = b"", None
        try:
            if chunked:
                body = self._read_chunked()
            elif length:
                n = int(length)
                if n < 0:
                    raise ValueError(length)
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
                path=unquote(u.path),
                query=dict(reversed(parse_qsl(u.query, keep_blank_values=True))),
                body=body,
            )
            resp = self.server.app.handle(req)
        else:
            self.close_connection = True
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        for k, v in resp.headers.items():
            self.send_header(k, v)
        self._headers_buffer.append(b"\r\n")
        if self.command != "HEAD":
            self._headers_buffer.append(resp.body)
        self.flush_headers()

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


class _Listener(ThreadingHTTPServer):
    """One daemon thread per connection, each tracked so ``close`` can
    shut the connection down and join the thread."""

    request_queue_size = 128  # aiohttp's backlog

    def __init__(self, address, app: App, ssl_context=None) -> None:
        self.app = app
        self.ssl_context = ssl_context
        self._mu = threading.Lock()
        self._conns = set()
        self._conn_threads = set()
        super().__init__(address, _Handler)

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


class Server(Daemon):
    """Lifecycle: construct → ``start`` → ``stop``, as the reference's.
    ``start`` is a no-op while the listener runs, and may be retried after
    a failed bind: the assembly runs once."""

    def __init__(self, config=None, failure_injector=None, metrics_registry=None) -> None:
        super().__init__(config=config, failure_injector=failure_injector,
                         metrics_registry=metrics_registry)
        # chaos campaigns are not ported: its routes answer as the
        # reference's do with chaos_enabled off
        self.chaos = None
        self._app = App(self)
        self._httpd: Optional[_Listener] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None
        self.port = self.config.port

    def start(self) -> None:
        """Start the checks, planes and session (``Daemon``), then the API
        listener; tell systemd once it listens (server.py:557-671)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._started.clear()
        self._start_error = None
        self._assemble()
        try:
            ssl_context = None
            if self.config.tls:
                cert, key = tls.generate_in_child(timeout=CERT_SECONDS)
                try:
                    ssl_context = tls.server_ssl_context(cert, key)
                finally:
                    # the context holds the key; nothing needs the files
                    shutil.rmtree(os.path.dirname(cert), ignore_errors=True)
            host = os.environ.get(ENV_LISTEN_HOST) or DEFAULT_LISTEN_HOST
            httpd = _Listener((host, self.config.port), self._app, ssl_context)
        except Exception as e:  # noqa: BLE001 — reported as the reference does
            self._start_error = e
            self._started.set()
            raise RuntimeError(f"API listener failed: {e}") from e
        self.port = httpd.server_address[1]
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
                                        name="tpud-http", daemon=True)
        self._thread.start()
        self._started.set()
        sdnotify.ready()

    def _close_listener(self) -> None:
        httpd, thread = self._httpd, self._thread
        if httpd is None:
            return
        if thread is not None and thread.is_alive():
            httpd.shutdown()  # returns once serve_forever has
        httpd.close(JOIN_SECONDS)
        if thread is not None:
            thread.join(timeout=JOIN_SECONDS)
        self._httpd = None
        self._thread = None

    def base_url(self) -> str:
        scheme = "https" if self.config.tls else "http"
        return f"{scheme}://localhost:{self.port}"
