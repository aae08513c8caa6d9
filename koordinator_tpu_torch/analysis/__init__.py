"""koordlint over the port: the static rules, the whole-program lock
graph and the wire contract, run over ``koordinator_tpu_torch/`` and
``chip_smoke.py`` (``python -m koordinator_tpu_torch.analysis``, and
``tests/test_torch_koordlint*.py`` under tier-1).

The port's own copy of every rule of the reference's
``koordinator_tpu/analysis/``, under the reference's rule ids.  The
device-discipline rules read PyTorch's idiom: a "device program" is a
function registered with ``@devprof.boundary`` or one that launches a
hand-written kernel (``jitscope.py``, the shared recogniser, which has no
rule id of its own, as in the reference), and a "retrace" is another
``nvcc`` build of a kernel variant, keyed by ``(source, defines)``.

Rules (each suppressible per line with ``# koordlint: disable=<rule>``):

* ``donation-safety``   — a name bound before an in-place writer
  (``apply_flat_delta``, ``rescore_dirty``'s scores, a module-local
  function that writes a parameter) to a view, slice or alias of the
  written tensor must not be read after it as the pre-write value; a
  writer under ``bridge/`` runs only where the drain was decided by
  ``ResidentState.commit_donates``.
* ``retrace-hazard``    — a kernel variant keyed on a call's data:
  ``defines`` built from data, a name or string payload in a build key or
  in the ladder's demotion bucket key, ``wave``/``top_m``/mesh/dirty or
  candidate knobs interpolated into ``defines``, a per-shard body taking
  a mesh knob, and unfrozen ``CycleConfig`` term configs.
* ``host-sync-in-jit``  — inside a device program, ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray`` or
  ``int()``/``float()``/``bool()`` of a tensor, ``synchronize()``, a
  Python ``if``/``while``/``assert`` on a tensor, an obs ``.note()`` of a
  tensor.

* ``broad-except``      — ``except Exception:`` handlers must re-raise,
  log (``log``/``logger``/``logging``/``_log``), or surface the bound
  error; silent swallowers need a reasoned
  ``# koordlint: disable=broad-except(<reason>)`` tag.
* ``span-leak``         — raw ``begin_span`` calls must guarantee the
  matching ``end_span`` on every exit path; a ``start_trace_span`` must
  end or abort on every exit; a ``SpanExporter`` must be closed.
* ``lock-held-dispatch`` — blocking readbacks (``.cpu()``, ``.numpy()``,
  ``.tolist()``, ``.item()``, ``torch.cuda.synchronize()``,
  ``Event.synchronize()``/``elapsed_time()``, ``np.asarray`` of a
  tensor) inside a ``with <state lock>:`` block, a ``*_launch_lock``
  block or an ``@launch_section`` body.
* ``bare-retry``        — a retry loop sleeping a fixed
  ``time.sleep(<literal>)``: pace it through
  ``replication.retry.BackoffPolicy``.
* ``unbounded-wait``    — ``Condition.wait()``/``Event.wait()`` with no
  timeout, and client RPC stub calls with no ``timeout=``/``deadline=``.
* ``wire-contract``     — scorer.proto against the Go codec
  (go/scorerclient/wire.go, delta.go, replica.go), against the port's
  codec (``bridge/wire.py``: every message class, field names, numbers,
  kinds, wire types and packedness, both directions), against the
  port's independent mirror (``bridge/wirecheck.py``), and the
  replication frame table of ``replication/codec.py`` against the
  mirror's and replica.go's.
* ``metrics-doc-drift`` — the ``koord_scorer_*`` families registered in
  ``obs/scorer_metrics.py`` against the family table of
  ``docs/OBSERVABILITY.md`` (read only), both directions plus kinds.
* ``lock-order-cycle``  — a cycle in the whole-program lock graph
  (``analysis/lockgraph.py``).
* ``lockorder-doc-drift`` — the derived order against the generated
  ``analysis/LOCKORDER.md`` (``--write-lockorder``), both directions,
  and each witness factory's name against its derived identity.
* ``unguarded-shared-state`` — guarded-state inference
  (``analysis/guards.py``).
* ``unregistered-jit-boundary`` — a kernel launch under ``solver/``,
  ``bridge/`` or ``parallel/`` carries ``@devprof.boundary("<name>")`` as
  its outermost decorator; a module-level launch handle and a per-shard
  launch outside a device program are flagged; host-only entries (no
  CUDA stream) are classified, not flagged.
* ``prewarm-drift``     — every boundary registration against
  ``obs/prewarm.py``'s ``PREWARM_BOUNDARIES`` and ``PREWARM_EXCLUDED``,
  both directions, and a name in both tables.

The runtime companion: ``obs.lockwitness.install()`` arms the witness on
the order this pass derives (``lockgraph.static_order``).  The
suppression ledger is auditable: ``--suppressions`` lists every live tag
and fails on stale tags or reason-required rules without a reason.
"""

from koordinator_tpu_torch.analysis.core import (  # noqa: F401
    Violation,
    iter_python_files,
    run_repo,
    run_rules_on_source,
)
from koordinator_tpu_torch.analysis.retrace_guard import (  # noqa: F401
    RetraceBudgetExceeded,
    retrace_guard,
)

RULES = (
    "donation-safety",
    "retrace-hazard",
    "host-sync-in-jit",
    "broad-except",
    "span-leak",
    "lock-held-dispatch",
    "bare-retry",
    "unbounded-wait",
    "wire-contract",
    "metrics-doc-drift",
    "lock-order-cycle",
    "lockorder-doc-drift",
    "unguarded-shared-state",
    "unregistered-jit-boundary",
    "prewarm-drift",
)
