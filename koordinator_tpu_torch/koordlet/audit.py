"""Audit: ring-file log of agent actuations + reader.

Reference: ``pkg/koordlet/audit`` — every actuation (cgroup write, evict,
suppress) appends a structured record to size-rotated files
(``auditor.go:38``), readable via the ``/events`` HTTP handler
(``cmd/koordlet/main.go:64-67,86``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, List, Optional


class Auditor:
    """Size-rotated JSONL audit log."""

    def __init__(
        self,
        directory: str,
        *,
        max_file_bytes: int = 1 << 20,
        max_files: int = 8,
    ):
        self.directory = directory
        self.max_file_bytes = max_file_bytes
        self.max_files = max_files
        os.makedirs(directory, exist_ok=True)
        self._active = os.path.join(directory, "audit.log")

    def log(self, event: str, **fields) -> None:
        record = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(record, sort_keys=True) + "\n"
        self._rotate_if_needed(len(line))
        with open(self._active, "a") as f:
            f.write(line)

    def _rotate_if_needed(self, incoming: int) -> None:
        try:
            size = os.path.getsize(self._active)
        except OSError:
            return
        if size + incoming <= self.max_file_bytes:
            return
        # shift audit.log.N -> .N+1, drop the oldest
        for i in range(self.max_files - 1, 0, -1):
            src = f"{self._active}.{i}"
            if os.path.exists(src):
                if i + 1 >= self.max_files:
                    os.remove(src)
                else:
                    os.replace(src, f"{self._active}.{i + 1}")
        os.replace(self._active, f"{self._active}.1")

    def read_events(
        self, *, limit: int = 256, event: Optional[str] = None
    ) -> List[Dict]:
        """Newest-first event records (the /events handler's view)."""
        out: List[Dict] = []
        files = [self._active] + [
            f"{self._active}.{i}" for i in range(1, self.max_files)
        ]
        for path in files:
            try:
                with open(path) as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in reversed(lines):
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if event is not None and rec.get("event") != event:
                    continue
                out.append(rec)
                if len(out) >= limit:
                    return out
        return out


    # -- HTTP /events handler (cmd/koordlet/main.go:64-67,86) --
    def wsgi_app(self, environ, start_response):
        from urllib.parse import parse_qs

        try:
            query = parse_qs(environ.get("QUERY_STRING", ""))
            try:
                limit = int(query.get("limit", ["256"])[0])
            except ValueError:
                limit = 256
            event = query.get("event", [None])[0]
            events = self.read_events(limit=limit, event=event)
            status, body = "200 OK", json.dumps(events).encode()
        except Exception as exc:  # never crash the scrape path
            status, body = "500 Internal", json.dumps({"error": str(exc)}).encode()
        start_response(
            status,
            [("Content-Type", "application/json"),
             ("Content-Length", str(len(body)))],
        )
        return [body]
