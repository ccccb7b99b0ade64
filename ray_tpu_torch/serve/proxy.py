"""HTTP ingress proxy over the stdlib ``http.server``.

The port of ``ray_tpu/serve/proxy.py``: a ``ThreadingHTTPServer`` routing
by ``route_prefix`` to the applications' handles; the data path (proxy,
router, replica actor) is the handle's.

Request mapping: ``POST/GET <route_prefix>`` → ingress ``__call__`` with
the JSON-decoded body (or raw bytes) as the single argument. JSON-encodes
the response (raw str/bytes pass through).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ray_tpu_torch.exceptions import (
    GetTimeoutError,
    SystemOverloadedError,
    TaskTimeoutError,
)
from ray_tpu_torch.serve.config import HTTPOptions


class HTTPProxy:
    def __init__(self, controller_handle, options: HTTPOptions):
        self._controller = controller_handle
        self._options = options
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # Route table: longest matching route_prefix wins.
    def _resolve_route(self, path: str):
        from ray_tpu_torch.serve import api as serve_api

        with serve_api._lock:
            apps = dict(serve_api._apps)
        best = None
        for app_name, app in apps.items():
            prefix = app.deployment.route_prefix or "/"
            if path == prefix or path.startswith(
                    prefix.rstrip("/") + "/") or prefix == "/":
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, app_name, app)
        if best is None:
            return None
        _, app_name, app = best
        return serve_api.get_app_handle(app_name)

    def start(self) -> None:
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 => persistent connections: a load-generating
            # client reuses one socket for its whole request stream
            # instead of a TCP+accept+thread-spawn per request (the
            # dominant cost of the stdlib server). Requires accurate
            # Content-Length framing on EVERY response path.
            protocol_version = "HTTP/1.1"
            # Nagle + delayed ACK between the two buffered writes of a
            # reply (headers, then body) adds ~40ms per request on
            # loopback; every serious HTTP server disables Nagle.
            disable_nagle_algorithm = True

            def log_message(self, *args):  # silence request logging
                pass

            def _reply(self, code: int, payload: bytes,
                       ctype: str = "text/plain") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _handle(self):
                if "chunked" in (self.headers.get("Transfer-Encoding")
                                 or "").lower():
                    # Unread chunk framing would desync the kept-alive
                    # socket (parsed as the next request line): refuse
                    # and close, per RFC 7230's 411 escape hatch.
                    self.close_connection = True
                    self._reply(411, b"chunked request bodies are not "
                                     b"supported; send Content-Length")
                    return
                # Drain the body BEFORE any reply: an unconsumed body
                # on a kept-alive socket becomes the next request line.
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                handle = proxy._resolve_route(self.path)
                if handle is None:
                    self._reply(404, b"no app bound to this route")
                    return
                try:
                    arg = json.loads(body) if body else None
                except json.JSONDecodeError:
                    arg = body
                # The HTTP budget is inherited end to end: the replica
                # call carries it as a deadline (refused typed once
                # dead, never executed late) and the result wait is
                # bounded by the same clock.
                timeout_s = float(proxy._options.request_timeout_s)
                try:
                    result = handle.options(
                        deadline_s=timeout_s).remote(arg).result(
                        timeout_s=timeout_s)
                except SystemOverloadedError as exc:
                    # Load shed (router max_queued_requests or cluster
                    # admission): retryable — tell the client when.
                    self.send_response(503)
                    payload = str(exc).encode()
                    self.send_header("Retry-After", str(max(1, int(
                        getattr(exc, "retry_after_s", 1) or 1))))
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length",
                                     str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                except (TaskTimeoutError, GetTimeoutError,
                        TimeoutError) as exc:
                    self._reply(504, str(exc).encode())
                    return
                except Exception as exc:  # noqa: BLE001 — 500 + message
                    self._reply(500, str(exc).encode())
                    return
                if isinstance(result, bytes):
                    self._reply(200, result, "application/octet-stream")
                elif isinstance(result, str):
                    self._reply(200, result.encode())
                else:
                    self._reply(200, json.dumps(result).encode(),
                                "application/json")

            do_GET = do_POST = do_PUT = _handle

        self._server = ThreadingHTTPServer(
            (self._options.host, self._options.port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="serve-proxy",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else -1

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
