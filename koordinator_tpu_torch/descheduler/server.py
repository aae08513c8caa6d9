"""koord-descheduler app/server: CLI, leader election, the ticking loop.

The port's own copy of ``koordinator_tpu/descheduler/server.py``.

Mirrors ``cmd/koord-descheduler/app/server.go``: flags (:70), dry-run,
profiles, leader election (:182-200) gating the Descheduler loop — only
the elected leader ticks ``descheduler_once``; on losing the lease the
loop pauses, on regaining it resumes (the reference restarts the loop in
OnStartedLeading).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Mapping, Optional, Sequence

from koordinator_tpu_torch.descheduler.evictions import PodEvictor
from koordinator_tpu_torch.descheduler.migration import MigrationController
from koordinator_tpu_torch.descheduler.runtime import (
    Descheduler,
    DeschedulerProfile,
    PluginSet,
)
from koordinator_tpu_torch.httpserving import (
    HTTPLifecycle,
    format_thread_stacks,
    reply_text,
)
from koordinator_tpu_torch.leaderelection import LeaderElector


class DeschedulerServer:
    def __init__(
        self,
        profiles: Sequence[DeschedulerProfile],
        nodes_fn: Callable[[], List[Mapping]],
        *,
        lease_path: str = "/tmp/koord-descheduler/leader.lease",
        identity: Optional[str] = None,
        descheduling_interval: float = 120.0,
        dry_run: bool = False,
        http_host: str = "127.0.0.1",
        http_port: int = 0,
        migration: Optional[MigrationController] = None,
        evictor: Optional[PodEvictor] = None,
    ):
        self.descheduler = Descheduler(
            profiles,
            nodes_fn,
            descheduling_interval=descheduling_interval,
            dry_run=dry_run,
            migration=migration,
            evictor=evictor,
        )
        self.elector = LeaderElector(
            lease_path, identity or f"{socket.gethostname()}-{os.getpid()}"
        )
        self.ticks = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/debug/stacks":
                    reply_text(self, format_thread_stacks())
                    return
                if self.path == "/healthz":
                    doc = {
                        "ok": True,
                        "leader": outer.elector.is_leader,
                        "ticks": outer.ticks,
                    }
                    data = json.dumps(doc).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self.send_response(404)
                    self.end_headers()

        self._httpd = ThreadingHTTPServer((http_host, http_port), Handler)
        self._http = HTTPLifecycle(self._httpd)

    @property
    def http_port(self) -> int:
        return self._httpd.server_address[1]

    def _loop(self, sleep):
        # the leader-gated tick loop: followers idle at the retry period
        while not self._stop.is_set():
            if self.elector.is_leader:
                self.descheduler.descheduler_once()
                self.ticks += 1
                interval = self.descheduler.descheduling_interval
                if interval <= 0:
                    return
                sleep(interval)
            else:
                sleep(self.elector.retry_period)

    def start(self, sleep=None) -> "DeschedulerServer":
        sleep = sleep or (lambda s: self._stop.wait(s))
        for target in (
            lambda: self.elector.run(),
            lambda: self._loop(sleep),
        ):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        self._http.start()
        return self

    def stop(self):
        self._stop.set()
        self.elector.stop()
        self._http.stop()
        for t in self._threads[:2]:
            t.join(timeout=5)


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="koord-descheduler")
    ap.add_argument(
        "--descheduling-interval", type=float, default=120.0,
        help="seconds between ticks; 0 runs once (descheduler.go:251)",
    )
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument(
        "--lease", default="/tmp/koord-descheduler/leader.lease"
    )
    ap.add_argument("--identity", default=None)
    ap.add_argument("--http-host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=10258)
    ap.add_argument(
        "--nodes-json", default=None,
        help="path to a JSON node list (standalone mode node source)",
    )
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    def nodes_fn():
        if args.nodes_json and os.path.exists(args.nodes_json):
            with open(args.nodes_json) as fh:
                return json.load(fh)
        return []

    server = DeschedulerServer(
        [DeschedulerProfile(plugins=PluginSet(balance=["LowNodeLoad"]))],
        nodes_fn,
        lease_path=args.lease,
        identity=args.identity,
        descheduling_interval=args.descheduling_interval,
        dry_run=args.dry_run,
        http_port=args.http_port,
        http_host=args.http_host,
    ).start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
