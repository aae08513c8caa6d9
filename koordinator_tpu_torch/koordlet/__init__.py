"""Node-agent helpers the port needs: the metrics registry
(``koordlet/metrics.py``, a copy of the reference's)."""
