"""Serving-tier helpers the port needs: admission control and the circuit
breaker (``replication/admission.py``) and the client's retry policy
(``replication/retry.py``), copies of the reference's.  The
leader/follower replication itself is not ported yet."""
