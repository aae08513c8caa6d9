"""Shared lifecycle for the daemons' HTTP servers.

The port's own copy of ``koordinator_tpu/httpserving.py``.

``BaseServer.shutdown()`` blocks on an event only ``serve_forever()``'s
``finally`` sets, so calling it when the serving loop never ran deadlocks
— and checking a started-inside-the-thread flag instead is a TOCTOU race
(stop() between ``thread.start()`` and the loop's first iteration would
``server_close()`` a socket ``serve_forever()`` is about to use).  The
flag here flips BEFORE ``thread.start()``: once the thread is started,
``serve_forever()`` is guaranteed to run eventually and release
``shutdown()``.
"""

from __future__ import annotations

import sys
import threading
import traceback
from socketserver import BaseServer


def format_thread_stacks() -> str:
    """Live stack dump of every thread — the per-binary net/http/pprof
    analog (reference serves pprof on each daemon,
    cmd/koord-scheduler/app/server.go:287 etc.)."""
    lines = []
    for tid, frame in sys._current_frames().items():
        lines.append(f"Thread {tid}:\n")
        lines.extend(traceback.format_stack(frame))
    return "".join(lines)


def reply_text(handler, body: str, code: int = 200) -> None:
    data = body.encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "text/plain")
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)


class HTTPLifecycle:
    """Owns the serve thread + safe shutdown for one http.server."""

    def __init__(self, httpd: BaseServer):
        self.httpd = httpd
        self._started = False
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    def start(self) -> None:
        self._started = True  # before thread.start(): shutdown() may block
        self._thread.start()

    def stop(self) -> None:
        if self._started:
            self.httpd.shutdown()
        self.httpd.server_close()
