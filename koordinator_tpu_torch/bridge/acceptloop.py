"""Stopping a thread blocked in ``accept()`` on a unix socket.

Neither closing a listening socket nor shutting it down wakes ``accept()``
on every kernel, so a server whose ``stop`` only closes its socket keeps
its accept thread, and whatever that thread holds, alive.  Every UDS
server of the port (``bridge/udsserver.py``, ``runtimeproxy_server.py``,
``koordlet/nri.py``) stops through these two helpers: one connection to
its own socket, then a join.
"""

from __future__ import annotations

import socket
import threading


def wake_accept_loop(path: str, thread: threading.Thread) -> None:
    """Connect once to the listening socket at ``path``, so ``thread``,
    blocked in ``accept()``, returns and sees the stop."""
    if not thread.is_alive():
        return
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as poke:
            poke.settimeout(1.0)
            poke.connect(path)
    except OSError:
        pass


def join_unless_current(thread: threading.Thread, timeout: float = 5.0) -> None:
    """Join a server's accept thread, unless ``stop`` runs on it."""
    if thread.is_alive() and thread is not threading.current_thread():
        thread.join(timeout=timeout)
