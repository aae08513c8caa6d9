"""Sparse updates of a resident snapshot tensor on its device.

Counterpart of ``koordinator_tpu/solver/resident.py``.  A
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


def _drop_rule(idx, val, size: int):
    """JAX's scatter rule for ``mode="drop"``, settled on the host:
    negative indices wrap once, then what lies outside [0, size) is
    dropped."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    val = np.asarray(val, np.int64).reshape(-1)
    idx = np.where(idx < 0, idx + size, idx)
    keep = (idx >= 0) & (idx < size)
    return idx[keep], val[keep]


@devprof.boundary("solver.resident._scatter_flat_sharded")
def _scatter_flat_sharded(arr, idx, val):
    """Shard-local scatter into a tensor placed on a mesh
    (``parallel/mesh.py ShardedTensor``), in place.  ``arr`` is split along
    its leading (node) axis, or replicated.  Each shard rebases the global
    flat indices against its own block's flat offset and writes only the
    cells it owns; the rebasing runs on the host, so a shard that owns none
    of the delta launches nothing and is not written."""
    from koordinator_tpu_torch.parallel.mesh import P, axis_index, mesh_axis, shard_map

    sharding = arr.sharding
    ax = mesh_axis(sharding.mesh)
    idx, val = _drop_rule(idx, val, arr.numel())

    def body(a, idx, val):
        rows = sharding.block(axis_index(ax), arr.shape)[0]
        lo = (rows.start or 0) * (a.numel() // max(a.shape[0], 1))
        loc = idx - lo
        mine = np.flatnonzero((loc >= 0) & (loc < a.numel()))
        if len(mine):
            dev = a.device
            a.view(-1)[torch.from_numpy(loc[mine]).to(dev)] = (
                torch.from_numpy(val[mine]).to(dev).to(a.dtype))
        return a

    shard_map(body, mesh=sharding.mesh, in_specs=(sharding.spec, P(), P()),
              out_specs=sharding.spec)(arr, idx, val)
    return arr


def _check_placement(arr, mesh) -> None:
    """Refuse a tensor that is not placed on the mesh its caller expects:
    a sharded one on another mesh, a plain one with a mesh of more than
    one device."""
    from koordinator_tpu_torch.parallel.mesh import ShardedTensor

    if isinstance(arr, ShardedTensor):
        if mesh is not None and arr.mesh != mesh:
            raise ValueError("apply_flat_delta: the tensor lives on another mesh")
    elif mesh is not None and mesh.size > 1:
        raise ValueError(
            "apply_flat_delta: the tensor is not placed on the given mesh; place it "
            "with parallel.mesh.shard_tensor"
        )


@devprof.boundary("solver.resident.apply_flat_delta")
def apply_flat_delta(arr, idx, val, mesh=None):
    """``arr.flat[idx] = val`` in place (values cast to ``arr``'s dtype),
    dropping indices outside the tensor; returns ``arr``.

    ``idx``/``val`` are host arrays in the unpadded mirror's flat index
    space.  A tensor placed on a mesh (a ``ShardedTensor``, node-split or
    replicated) takes the shard-local scatter, :func:`_scatter_flat_sharded`.
    ``mesh``: the mesh the caller expects ``arr`` on; a tensor that is not
    placed on a given mesh of more than one device is refused."""
    from koordinator_tpu_torch.parallel.mesh import ShardedTensor, check_mesh

    _check_placement(arr, check_mesh(mesh))
    if type(arr) is ShardedTensor:
        return _scatter_flat_sharded(arr, idx, val)
    idx, val = _drop_rule(idx, val, arr.numel())
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
