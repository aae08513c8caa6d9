"""The device-time ledger's interface, without the ledger.

The reference's ``koordinator_tpu/obs/devprof.py`` samples the device time
of its compiled programs; the port has not ported it yet.  The servicer
calls these two functions around every launch, so they are here as no-ops:
``drain_notes`` returns no notes (launch spans carry no device-time
attributes) and ``configure`` records nothing.
"""

from __future__ import annotations


def drain_notes() -> list:
    """The launch notes recorded on this thread since the last drain."""
    return []


def configure(sample=None, metrics=None, state_dir=None) -> None:
    """Set the ledger's sampling rate and sinks (nothing to set here)."""
