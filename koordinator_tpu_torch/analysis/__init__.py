"""Warm-path guards of the port (``retrace_guard.py``)."""
