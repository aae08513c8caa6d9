"""The replicated serving tier and its helpers.

Counterpart of ``koordinator_tpu/replication/``.  One **leader** daemon
applies client Syncs to its device-resident snapshot and streams the
already-encoded frames to N **follower** daemons, each keeping its own
device-resident copy and serving Score/Assign locally.  The
``s<epoch>-<gen>`` snapshot id is the fencing token: a follower applies
only frames that extend its exact chain, and any discontinuity triggers
the one-shot full resync.

Modules:

* ``codec``      — the ``KRPL`` frame layout (``bridge/wirecheck.py`` is
  the independent second decoder).
* ``admission``  — queue-depth admission control and the circuit breaker.
* ``leader``     — ReplicationPublisher: per-follower bounded queues over
  a unix socket; the writer path never blocks on a reader.
* ``follower``   — ReplicaApplier, ReplicationSubscriber,
  FollowerServicer (refuses client Syncs until promoted) and
  ``promote_replica`` (the raw-UDS admin call).
* ``journal``    — FrameJournal, the CRC'd, compacting frame journal under
  the daemon's state dir (replay on boot resumes the same chain), and
  RelayFrameCache, its in-memory twin for a relay.
* ``autoscale``  — the SLO-driven replica autoscaler (decisions only).
* ``retry``      — the one jittered-exponential backoff policy.

``leader``/``follower`` import the bridge server and are therefore not
imported here (``bridge/server.py`` imports ``admission``); import them
explicitly.
"""

from koordinator_tpu_torch.replication.admission import (  # noqa: F401
    AdmissionGate,
    ResourceExhausted,
)
from koordinator_tpu_torch.replication.codec import (  # noqa: F401
    Frame,
    FrameError,
    KIND_DELTA,
    KIND_FULL,
    KIND_FULL_Z,
    KIND_HELLO,
    decode_frame,
    encode_frame,
)
from koordinator_tpu_torch.replication.journal import (  # noqa: F401
    FrameJournal,
    JournalError,
    RelayFrameCache,
)
from koordinator_tpu_torch.replication.retry import (  # noqa: F401
    BackoffPolicy,
    call_with_retry,
)
