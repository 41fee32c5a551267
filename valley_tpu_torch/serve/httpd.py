"""Minimal JSON-over-HTTP server and client for the serve control plane,
the port's own copy of ``valley_tpu/serve/httpd.py`` (standard library
only: the client uses ``urllib``, not ``requests``).

The reference uses FastAPI+uvicorn (`valley/serve/controller.py:239-285`);
the control plane runs on a small stdlib `ThreadingHTTPServer` wrapper with
the same wire format: POST endpoints taking and returning JSON, and
streaming endpoints yielding ``b"...json...\\0"`` chunks (the reference's
delimiter, `model_worker.py:278-291`).  The client ignores proxy settings:
the stack's addresses are its own hosts.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

logger = logging.getLogger(__name__)

Handler = Callable[[dict], Union[dict, Iterator[bytes], Tuple[int, dict]]]


class StreamResponse:
    """Wrap a bytes iterator with an explicit Content-Type (e.g.
    ``text/event-stream`` for SSE endpoints like /v1/chat/completions)."""

    def __init__(self, iterator: Iterator[bytes],
                 content_type: str = "application/octet-stream"):
        self.iterator = iterator
        self.content_type = content_type


class JsonHttpServer:
    """Route registry + threading HTTP server.

    Handlers receive the parsed JSON body (``{}`` for empty) and return
    either a dict (JSON response), a (status, dict) tuple, or a bytes
    iterator (streamed chunked response).
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.routes: Dict[Tuple[str, str], Handler] = {}
        self.host, self._port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def post(self, path: str):
        def deco(fn: Handler) -> Handler:
            self.routes[("POST", path)] = fn
            return fn
        return deco

    def get(self, path: str):
        def deco(fn: Handler) -> Handler:
            self.routes[("GET", path)] = fn
            return fn
        return deco

    # -- server lifecycle ------------------------------------------------

    def _make_handler(self):
        server = self

        class RequestHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet default access log
                logger.debug("%s " + fmt, self.client_address[0], *args)

            def _dispatch(self, method: str):
                handler = server.routes.get((method, self.path))
                if handler is None:
                    self._send_json(404, {"error": f"no route {self.path}"})
                    return
                body = {}
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    try:
                        body = json.loads(self.rfile.read(length) or b"{}")
                    except json.JSONDecodeError:
                        self._send_json(400, {"error": "invalid JSON"})
                        return
                try:
                    result = handler(body)
                except Exception as e:  # handler crash -> 500
                    logger.exception("handler %s failed", self.path)
                    self._send_json(500, {"error": str(e)})
                    return
                if isinstance(result, tuple):
                    status, payload = result
                    self._send_json(status, payload)
                elif isinstance(result, dict) or result is None:
                    self._send_json(200, result or {})
                elif isinstance(result, (bytes, str)):
                    data = result.encode() if isinstance(result, str) \
                        else result
                    ctype = "text/html" if data[:1] == b"<" else \
                        "application/octet-stream"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:  # streaming iterator (optionally typed)
                    ctype = "application/octet-stream"
                    if isinstance(result, StreamResponse):
                        ctype = result.content_type
                        result = result.iterator
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    try:
                        for chunk in result:
                            self.wfile.write(
                                f"{len(chunk):X}\r\n".encode())
                            self.wfile.write(chunk + b"\r\n")
                            self.wfile.flush()
                        self.wfile.write(b"0\r\n\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        logger.info("client disconnected mid-stream")

            def _send_json(self, status: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                self._dispatch("POST")

            def do_GET(self):
                self._dispatch("GET")

        return RequestHandler

    def start(self) -> int:
        """Start serving on a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((self.host, self._port),
                                          self._make_handler())
        self._httpd.daemon_threads = True
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._port

    def serve_forever(self):
        port = self.start()
        logger.info("serving on %s:%d", self.host, port)
        self._thread.join()

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    @property
    def port(self) -> int:
        return self._port


# the stack talks to its own hosts: no proxy from the environment
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def open_json(url: str, payload: dict, timeout: float):
    """POST ``payload`` as JSON; the response (HTTP errors raise
    `urllib.error.HTTPError`, unreachable hosts `urllib.error.URLError`)."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return _OPENER.open(req, timeout=timeout)


def post_json(url: str, payload: dict, timeout: float = 10.0) -> dict:
    with open_json(url, payload, timeout) as r:
        return json.loads(r.read() or b"{}")


def iter_delimited(resp, delimiter: bytes = b"\0") -> Iterator[bytes]:
    """The non-empty ``delimiter``-separated records of a (chunked)
    response, each as soon as it has arrived."""
    buf = b""
    while True:
        data = resp.read1(65536)
        if not data:
            break
        buf += data
        *parts, buf = buf.split(delimiter)
        yield from (p for p in parts if p)
    if buf:
        yield buf


def stream_chunks(url: str, payload: dict,
                  timeout: float = 60.0) -> Iterator[dict]:
    """POST and iterate the reference's b'\\0'-delimited JSON chunks."""
    with open_json(url, payload, timeout) as r:
        for chunk in iter_delimited(r):
            yield json.loads(chunk.decode())
