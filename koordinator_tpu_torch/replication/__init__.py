"""Serving-tier helpers the port needs: admission control and the circuit
breaker (``replication/admission.py``, a copy of the reference's).  The
leader/follower replication itself is not ported yet."""
