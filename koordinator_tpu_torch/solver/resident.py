"""Sparse updates of a resident snapshot tensor on its device.

Counterpart of ``koordinator_tpu/solver/resident.py`` (single device).  A
warm Sync's delta frame, (flat index, value) pairs in the unpadded host
mirror's index space, is scattered straight into the resident tensor: the
flat index space of the unpadded [N, ...] mirror embeds prefix-wise into the
row-padded [N_bucket, ...] tensor, so the same indices address the same
cells.  The tensor is updated in place, the port's form of the reference's
donation: the caller's reference is the updated tensor.

The reference pads (idx, val) to power-of-two buckets and lets
``mode="drop"`` discard the pad slots and any index past the tensor.  The
port keeps the buckets but must never hand an out-of-range index to a
CUDA scatter (a device-side assert ends the context), so it settles the
drop rule on the host before the upload: negative indices wrap once, as
in JAX, and what is still out of range is dropped; the pad slots are
sliced off by their host-known count.
"""

from __future__ import annotations

import numpy as np
import torch

from koordinator_tpu_torch.model.snapshot import pad_bucket
from koordinator_tpu_torch.obs import devprof


@devprof.boundary("solver.resident.apply_flat_delta")
def apply_flat_delta(arr: torch.Tensor, idx, val, mesh=None) -> torch.Tensor:
    """``arr.flat[idx] = val`` in place (values cast to ``arr``'s dtype),
    dropping indices outside the tensor; returns ``arr``.

    ``idx``/``val`` are host arrays in the unpadded mirror's flat index
    space.  ``mesh``: node-sharded residency is Queue A item 13 of the
    port; a mesh of more than one device is refused."""
    if mesh is not None and getattr(mesh, "size", 1) > 1:
        raise NotImplementedError(
            "sharded apply_flat_delta is not ported (ROADMAP Queue A item 13)"
        )
    idx = np.asarray(idx, np.int64).reshape(-1)
    val = np.asarray(val, np.int64).reshape(-1)
    # JAX's scatter rule for mode="drop": negative indices wrap once, then
    # what lies outside [0, size) is dropped
    idx = np.where(idx < 0, idx + arr.numel(), idx)
    keep = (idx >= 0) & (idx < arr.numel())
    idx, val = idx[keep], val[keep]
    n = len(idx)
    bucket = pad_bucket(max(n, 1))
    pad = bucket - n
    idx = np.concatenate([idx, np.full(pad, arr.numel(), np.int64)])
    val = np.concatenate([val, np.zeros(pad, np.int64)])
    dev = arr.device
    idx_d = torch.from_numpy(idx).to(dev)[:n]
    val_d = torch.from_numpy(val).to(dev)[:n].to(arr.dtype)
    arr.view(-1)[idx_d] = val_d
    return arr
