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
down the open connections and joins their threads within a bound. The
listener itself is ``listener.py``, which the manager serves on too.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

from gpud_tpu_torch import sdnotify
from gpud_tpu_torch.daemon import Daemon
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.server import tls
from gpud_tpu_torch.server.app import App
from gpud_tpu_torch.server.listener import JOIN_SECONDS, MAX_BODY_BYTES, Listener  # noqa: F401

logger = get_logger(__name__)

CERT_SECONDS = 60.0  # the child interpreter that makes the certificate
# the address the listener binds: the reference's all-interfaces, unless
# the environment names one (127.0.0.1 keeps the API on the host)
DEFAULT_LISTEN_HOST = "0.0.0.0"
ENV_LISTEN_HOST = "TPUD_LISTEN_HOST"


class Server(Daemon):
    """Lifecycle: construct → ``start`` → ``stop``, as the reference's.
    ``start`` is a no-op while the listener runs, and may be retried after
    a failed bind: the assembly runs once."""

    def __init__(self, config=None, failure_injector=None, metrics_registry=None) -> None:
        super().__init__(config=config, failure_injector=failure_injector,
                         metrics_registry=metrics_registry)
        self._app = App(self)
        self._httpd: Optional[Listener] = None
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
            httpd = Listener((host, self.config.port), self._app, ssl_context)
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
