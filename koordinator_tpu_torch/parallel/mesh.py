"""The device mesh and the placement of the snapshot's tensors on it.

Counterpart of ``koordinator_tpu/parallel/mesh.py``.  The reference's mesh
is a single-controller ``jax.sharding.Mesh``: one Python process drives
every device, and a sharded array is one value whose blocks live on the
devices.  The port keeps that model in one process:

* :class:`Mesh` is an array of ``torch.device``s with axis names.  A
  device may be named more than once: ``cluster_mesh([torch.device("cpu")]
  * 8)`` is an 8-shard mesh on the CPU, ``[torch.device("cuda:0")] * 4`` a
  4-shard mesh on one card, as the reference's tests run 8 virtual devices
  on one host (``--xla_force_host_platform_device_count``).
* :class:`ShardedTensor` is the counterpart of a sharded ``jax.Array``: one
  tensor per mesh position, each its own allocation on that position's
  device (also when devices repeat, so a shard-local write provably
  touches one shard), with the :class:`NamedSharding` that says which
  block each holds.
* :func:`shard_map` runs a collective-free body once per mesh position on
  that position's blocks and assembles the outputs by their specs.  What
  the reference does with a collective inside a body becomes, here, a loop
  of ``shard_map`` calls with the "collective" between them
  (``parallel/shard_assign.py``).

Mesh axes, as in the reference:

* ``nodes`` (:data:`CLUSTER_AXIS`): the resident cluster's node rows split
  over it; pod rows and the gang/quota tables replicate;
* ``pods`` (:data:`POD_AXIS`): the sparse candidate engine's pod rows split
  over it, the node table replicates;
* :func:`make_mesh` folds the devices into a 2-D ``("pods", "nodes")``
  mesh for the scoring tensor.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from koordinator_tpu_torch.model.snapshot import SNAPSHOT_FIELDS, ClusterSnapshot

# the one mesh axis of the resident cluster: node rows spread over it, pod
# rows and the gang/quota tables replicate
CLUSTER_AXIS = "nodes"

# the pod axis of the sparse candidate engine: the [P, C] candidate tensors
# split over pod rows against a replicated node table, with no collective
POD_AXIS = "pods"

_HOST_DEVICES_FLAG = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


class PartitionSpec(tuple):
    """Per-dimension placement of a tensor over a mesh, the counterpart of
    ``jax.sharding.PartitionSpec``: ``None`` keeps a dimension whole, an
    axis name splits it over that mesh axis, a tuple of names over their
    product (row-major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """An n-D array of ``torch.device``s with one name per axis.

    ``devices`` keeps the reference's form (a numpy array, ``.size`` the
    shard count); :attr:`device_list` is the flat order every per-shard
    list of this module follows."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.reshape(-1)]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        names = tuple(axis_names)
        if len(names) != arr.ndim:
            raise ValueError(f"{arr.ndim}-D devices for axis names {names}")
        out = np.empty(len(flat), dtype=object)
        out[:] = flat
        self.devices = out.reshape(arr.shape)
        self.axis_names = names
        self.device_list = tuple(flat)

    @property
    def size(self) -> int:
        return len(self.device_list)

    @property
    def lead(self) -> torch.device:
        """The device of position 0: where replicated work runs once and
        where gathered tensors are assembled."""
        return self.device_list[0]

    @property
    def distinct_devices(self) -> int:
        return len(set(self.device_list))

    def coords(self, position: int) -> tuple:
        return tuple(int(c) for c in np.unravel_index(position, self.devices.shape))

    def _key(self):
        return (self.device_list, self.devices.shape, self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh(axis_names={self.axis_names}, shape={self.devices.shape}, "
                f"devices={sorted({str(d) for d in self.device_list})})")


def check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` when it is None or a :class:`Mesh`; anything else is
    refused, since the port shards only over its own meshes."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"expected a koordinator_tpu_torch.parallel.mesh.Mesh, got "
            f"{type(mesh).__name__}"
        )
    return mesh


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` bound to a mesh."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def device_set(self) -> frozenset:
        """The mesh positions holding a block, each as ``(position,
        device)``: a device named twice counts twice, as a virtual device
        of the reference's forced host platform does."""
        return frozenset(enumerate(str(d) for d in self.mesh.device_list))

    def _parts(self, entry) -> tuple:
        """(axis indices, part count) of one spec entry."""
        if entry is None:
            return (), 1
        names = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(self.mesh.axis_names.index(n) for n in names)
        return axes, int(np.prod([self.mesh.devices.shape[a] for a in axes]))

    def block(self, position: int, shape) -> tuple:
        """The slices of a tensor of global ``shape`` that ``position``
        holds.  Raises ``ValueError`` when a split dimension does not
        divide over its axes."""
        coords = self.mesh.coords(position)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for dim, (length, entry) in enumerate(zip(shape, spec)):
            axes, parts = self._parts(entry)
            if parts == 1:
                out.append(slice(None))
                continue
            if length % parts:
                raise ValueError(
                    f"dimension {dim} of {tuple(shape)} ({length}) does not divide "
                    f"over {parts} devices"
                )
            sizes = [self.mesh.devices.shape[a] for a in axes]
            part = int(np.ravel_multi_index([coords[a] for a in axes], sizes))
            step = length // parts
            out.append(slice(part * step, (part + 1) * step))
        return tuple(out)

    def global_shape(self, local_shape) -> tuple:
        spec = tuple(self.spec) + (None,) * (len(local_shape) - len(self.spec))
        return tuple(n * self._parts(e)[1] for n, e in zip(local_shape, spec))


class ShardedTensor:
    """A tensor split over a mesh: ``shards[i]`` is the block mesh
    position ``i`` holds, on ``mesh.device_list[i]``.  Replicated
    dimensions repeat whole in every shard.

    It is read through :meth:`full` (an assembled copy on one device, also
    what ``np.asarray`` returns); shard-local code reads and writes
    ``shards`` directly."""

    __slots__ = ("shards", "sharding", "shape", "dtype")

    def __init__(self, shards, sharding: NamedSharding, shape=None):
        self.shards = list(shards)
        self.sharding = sharding
        if len(self.shards) != sharding.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of {sharding.mesh.size}")
        self.shape = tuple(shape) if shape is not None else sharding.global_shape(
            self.shards[0].shape)
        self.dtype = self.shards[0].dtype

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor assembled on ``device`` (default the lead
        device): a new tensor, each block copied once."""
        dev = self.mesh.lead if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        seen = set()
        for i, shard in enumerate(self.shards):
            sl = self.sharding.block(i, self.shape)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out[sl] = shard.to(dev)
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self.full("cpu").numpy()
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self) -> str:
        return f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, spec={self.sharding.spec})"


def _own_copy(t: torch.Tensor, device) -> torch.Tensor:
    """A new allocation of ``t`` on ``device``, never a view or an alias."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def shard_tensor(t, sharding: NamedSharding) -> ShardedTensor:
    """Place ``t`` (a tensor, array or :class:`ShardedTensor`) with
    ``sharding``: every position gets its block as its own allocation."""
    if isinstance(t, ShardedTensor):
        if t.sharding == sharding:
            return t
        t = t.full()
    t = torch.as_tensor(t)
    mesh = sharding.mesh
    return ShardedTensor(
        [_own_copy(t[sharding.block(i, t.shape)], d) for i, d in enumerate(mesh.device_list)],
        sharding, t.shape,
    )


def gather(x, device=None):
    """``x`` whole on one device: a :class:`ShardedTensor` assembled (on
    ``device``, default its lead device), a tensor moved when ``device`` is
    given, anything else as it is."""
    if isinstance(x, ShardedTensor):
        return x.full(device)
    if isinstance(x, torch.Tensor) and device is not None:
        return x.to(device)
    return x


def local(x, position: int = 0):
    """The block of ``x`` that mesh ``position`` holds (a plain tensor
    stands for itself)."""
    return x.shards[position] if isinstance(x, ShardedTensor) else x


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def _host_device_count() -> int:
    """CPU devices of the forced host platform (``XLA_FLAGS``'s
    ``--xla_force_host_platform_device_count``, the setting the test
    configuration exports), else 1."""
    m = _HOST_DEVICES_FLAG.search(os.environ.get("XLA_FLAGS", ""))
    return max(1, int(m.group(1))) if m else 1


def visible_devices(device=None) -> list:
    """The devices a default mesh spans: every CUDA device (``device``
    None or a CUDA device; raises when CUDA is absent), or for ``"cpu"``
    the CPU repeated as many times as the forced host platform has
    devices — the counterpart of ``jax.devices()``."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * _host_device_count()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "koordinator_tpu_torch: CUDA is not available; pass devices (or "
            "device='cpu') to build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _devices(devices, device) -> list:
    return list(devices) if devices is not None else visible_devices(device)


def cluster_mesh(devices: Optional[Sequence] = None, device=None) -> Mesh:
    """The 1-D resident-snapshot mesh: every position holds one node-axis
    shard of the cluster.  ``devices`` defaults to :func:`visible_devices`
    of ``device``; pass a prefix to shard over fewer."""
    return Mesh(_devices(devices, device), (CLUSTER_AXIS,))


def pod_mesh(devices: Optional[Sequence] = None, device=None) -> Mesh:
    """The 1-D pod-axis mesh of the sparse candidate engine: every position
    owns a pod-row slice of the [P, C] candidate tensors.  Pass a
    power-of-two prefix so the pod bucket divides."""
    return Mesh(_devices(devices, device), (POD_AXIS,))


def _factor2(n: int):
    """Split n into (a, b) with a*b = n, as square as possible."""
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return a, n // a


def make_mesh(devices: Optional[Sequence] = None, device=None) -> Mesh:
    """The 2-D ``("pods", "nodes")`` scoring mesh, as square as the device
    count allows."""
    devs = _devices(devices, device)
    dp, tp = _factor2(len(devs))
    arr = np.empty(len(devs), dtype=object)
    arr[:] = [torch.device(d) for d in devs]
    return Mesh(arr.reshape(dp, tp), ("pods", "nodes"))


def pow2_device_count(n: int) -> int:
    """Largest power of two <= ``n`` (>= 1).  Node buckets are powers of
    two, so only a power-of-two mesh divides every geometry; daemons round
    their device count down through this."""
    n = max(1, int(n))
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# the placement policy
# ---------------------------------------------------------------------------


def node_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """A node-major tensor ([N], [N, R], [N, A, R]): leading axis split
    over the cluster mesh, trailing axes whole."""
    return NamedSharding(mesh, P(CLUSTER_AXIS, *([None] * (ndim - 1))))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def score_sharding(mesh: Mesh) -> NamedSharding:
    """The resident [P, N] score/feasible tensors: the node axis (axis 1)
    split over the cluster mesh, so column j lives with node j's rows and
    the dirty-column rescore is shard-local like the delta scatter."""
    return NamedSharding(mesh, P(None, CLUSTER_AXIS))


def sparse_score_sharding(mesh: Mesh) -> NamedSharding:
    """The sparse [P, C] candidate-index / score / feasible tensors: the
    pod axis (axis 0) split over the pod mesh, the transpose of
    :func:`score_sharding`, because the sparse engine's scale axis is pods
    (C is a small static width, never worth splitting)."""
    return NamedSharding(mesh, P(POD_AXIS, None))


def _ndim(a) -> int:
    return len(a.shape)


def _map_tables(snap: ClusterSnapshot, node, pod, rep) -> ClusterSnapshot:
    """``snap`` with every node leaf through ``node``, every pod leaf
    through ``pod`` and every other leaf through ``rep`` (None stays
    None, names stay)."""
    def table(t, fn):
        fields = SNAPSHOT_FIELDS[_table_name(t)][1]
        return dataclasses.replace(t, **{
            f: (None if getattr(t, f) is None else fn(getattr(t, f))) for f in fields
        })

    return ClusterSnapshot(
        nodes=table(snap.nodes, node),
        pods=table(snap.pods, pod),
        gangs=table(snap.gangs, rep),
        quotas=table(snap.quotas, rep),
        throughput=None if snap.throughput is None else rep(snap.throughput),
    )


def _table_name(t) -> str:
    for name, (cls, _) in SNAPSHOT_FIELDS.items():
        if isinstance(t, cls):
            return name
    raise TypeError(f"not a snapshot table: {type(t).__name__}")


def _snapshot_spec_tree(snap: ClusterSnapshot, node, rep) -> ClusterSnapshot:
    """The per-leaf classification shared by :func:`snapshot_shardings`
    and :func:`snapshot_partition_specs`: node leaves through ``node``,
    pod rows, gang/quota tables and the throughput matrix through ``rep``."""
    return _map_tables(snap, node, rep, rep)


def snapshot_partition_specs(snap: ClusterSnapshot) -> ClusterSnapshot:
    """Bare :class:`PartitionSpec`s matching ``snap`` leaf for leaf: the
    mesh-independent half of the placement policy, the in/out specs of the
    sharded rescore."""
    return _snapshot_spec_tree(
        snap, lambda a: P(CLUSTER_AXIS, *([None] * (_ndim(a) - 1))), lambda a: P())


def snapshot_shardings(snap: ClusterSnapshot, mesh: Mesh) -> ClusterSnapshot:
    """:class:`NamedSharding`s matching ``snap`` leaf for leaf: node
    tensors split along the cluster axis, everything else replicated — the
    one statement of which leaf gets which placement
    (``bridge/state.py`` places its resident leaves by the same policy)."""
    return _snapshot_spec_tree(
        snap, lambda a: node_sharding(mesh, _ndim(a)), lambda a: replicated_sharding(mesh))


def snapshot_pod_partition_specs(snap: ClusterSnapshot) -> ClusterSnapshot:
    """Bare specs placing ``snap`` for the sparse engine's pod-parallel
    ``shard_map``: pod rows split over :data:`POD_AXIS`, the node table and
    the gang/quota/throughput side tables replicated."""
    return _map_tables(
        snap, lambda a: P(), lambda a: P(POD_AXIS, *([None] * (_ndim(a) - 1))),
        lambda a: P())


def snapshot_leaves(snap: ClusterSnapshot) -> list:
    """The snapshot's tensor leaves in the reference's pytree order (each
    table's fields in ``SNAPSHOT_FIELDS`` order, then the throughput
    matrix), absent optional leaves skipped: the counterpart of
    ``jax.tree_util.tree_leaves``."""
    out = []
    for name, (_, fields) in SNAPSHOT_FIELDS.items():
        table = getattr(snap, name)
        out.extend(getattr(table, f) for f in fields if getattr(table, f) is not None)
    if snap.throughput is not None:
        out.append(snap.throughput)
    return out


def place_snapshot(snap: ClusterSnapshot, shardings: ClusterSnapshot) -> ClusterSnapshot:
    """``snap`` with every leaf placed by the matching leaf of
    ``shardings`` (a tree of :class:`NamedSharding`s)."""
    placed = [shard_tensor(leaf, sh) for leaf, sh in
              zip(snapshot_leaves(snap), snapshot_leaves(shardings))]
    it = iter(placed)
    return _map_tables(snap, lambda a: next(it), lambda a: next(it), lambda a: next(it))


def shard_cluster_snapshot(snap: ClusterSnapshot, mesh: Mesh) -> ClusterSnapshot:
    """Place ``snap`` mesh-resident by :func:`snapshot_shardings`.  The
    node bucket must divide over the mesh."""
    n = snap.nodes.allocatable.shape[0]
    if n % mesh.size:
        raise ValueError(
            f"node bucket {n} does not divide over {mesh.size} devices; "
            "resize the mesh to a power-of-two prefix"
        )
    return place_snapshot(snap, snapshot_shardings(snap, mesh))


def shard_snapshot_for_scoring(snap: ClusterSnapshot, mesh: Mesh) -> ClusterSnapshot:
    """Pods over the ``pods`` axis, nodes over the ``nodes`` axis, side
    tables replicated: :func:`score_cycle <koordinator_tpu_torch.solver.
    greedy.score_cycle>` then computes each [P, N] block on its own
    device with no communication."""
    node = lambda a: NamedSharding(mesh, P("nodes", *([None] * (_ndim(a) - 1))))  # noqa: E731
    pod = lambda a: NamedSharding(mesh, P("pods", *([None] * (_ndim(a) - 1))))  # noqa: E731
    rep = lambda a: replicated_sharding(mesh)  # noqa: E731
    return place_snapshot(snap, _map_tables(snap, node, pod, rep))


def shard_snapshot_for_assign(snap: ClusterSnapshot, mesh: Mesh) -> ClusterSnapshot:
    """Node state over ALL mesh devices, pod rows replicated: the layout
    of the sharded greedy scan."""
    ax = mesh_axis(mesh)
    node = lambda a: NamedSharding(mesh, P(ax, *([None] * (_ndim(a) - 1))))  # noqa: E731
    rep = lambda a: replicated_sharding(mesh)  # noqa: E731
    return place_snapshot(snap, _map_tables(snap, node, rep, rep))


def mesh_axis(mesh: Mesh):
    """The spec entry that splits over every axis of ``mesh``."""
    axes = tuple(mesh.axis_names)
    return axes if len(axes) > 1 else axes[0]


def spec_tree(snap: ClusterSnapshot) -> ClusterSnapshot:
    """The spec of every leaf of ``snap`` as it is placed (a plain leaf
    counts as replicated)."""
    spec = lambda a: a.sharding.spec if isinstance(a, ShardedTensor) else P()  # noqa: E731
    return _map_tables(snap, spec, spec, spec)


def is_sharded(snap: ClusterSnapshot) -> bool:
    return isinstance(snap.nodes.allocatable, ShardedTensor)


def snapshot_mesh(snap: ClusterSnapshot) -> Optional[Mesh]:
    """The mesh a sharded snapshot lives on, or None."""
    return snap.nodes.allocatable.mesh if is_sharded(snap) else None


def unshard_snapshot(snap: ClusterSnapshot, device=None) -> ClusterSnapshot:
    """``snap`` whole on one device (default the lead device): every
    sharded leaf assembled, a plain snapshot as it is."""
    if not is_sharded(snap):
        return snap
    dev = snap.nodes.allocatable.mesh.lead if device is None else device
    fn = lambda a: gather(a, dev)  # noqa: E731
    return _map_tables(snap, fn, fn, fn)


def lead_snapshot(snap: ClusterSnapshot) -> ClusterSnapshot:
    """The tables a replicated computation reads, on the lead device: a
    replicated leaf's lead copy, a split leaf assembled."""
    if not is_sharded(snap):
        return snap

    def pick(a):
        if isinstance(a, ShardedTensor) and not any(e is not None for e in a.sharding.spec):
            return a.shards[0]
        return gather(a)

    return _map_tables(snap, pick, pick, pick)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

_TLS = threading.local()


def axis_index(axis) -> int:
    """Inside a :func:`shard_map` body: the running shard's coordinate
    along ``axis`` (a name, or a tuple of names for their row-major
    product), the counterpart of ``lax.axis_index``."""
    mesh, position = _TLS.current
    coords = mesh.coords(position)
    names = axis if isinstance(axis, tuple) else (axis,)
    axes = [mesh.axis_names.index(n) for n in names]
    return int(np.ravel_multi_index([coords[a] for a in axes],
                                    [mesh.devices.shape[a] for a in axes]))


def _local_arg(arg, spec, mesh: Mesh, position: int):
    """The block of one operand that ``position`` computes on: a snapshot
    (or one of its tables) leaf by leaf with its tree of specs, a tuple
    element by element with the same spec."""
    if dataclasses.is_dataclass(arg) and not isinstance(arg, type):
        return dataclasses.replace(arg, **{
            f.name: _local_arg(getattr(arg, f.name), getattr(spec, f.name), mesh, position)
            for f in dataclasses.fields(arg)
            if getattr(arg, f.name) is not None and f.name != "names"
        })
    if isinstance(arg, (tuple, list)):
        return type(arg)(_local_arg(a, spec, mesh, position) for a in arg)
    dev = mesh.device_list[position]
    if isinstance(arg, ShardedTensor):
        if arg.sharding.mesh is mesh and tuple(arg.sharding.spec) == tuple(spec) or \
                arg.sharding == NamedSharding(mesh, spec):
            return arg.shards[position]
        arg = arg.full(dev)
    if isinstance(arg, torch.Tensor):
        return arg[NamedSharding(mesh, spec).block(position, arg.shape)].to(dev)
    return arg


def shard_map(f, *, mesh: Mesh, in_specs, out_specs):
    """``f`` run once per mesh position on that position's blocks, the
    counterpart of ``jax.shard_map`` for collective-free bodies.

    Each operand is a tensor, a :class:`ShardedTensor` or a snapshot, with
    its spec in ``in_specs`` (a snapshot takes a tree of specs; a non-tensor
    operand passes through).  A :class:`ShardedTensor` already placed by its
    spec hands its own shards to the body, so an in-place write in the body
    is a shard-local write; other operands are sliced onto the position's
    device.  ``out_specs`` (a spec or a tuple of specs; None for a body
    that returns nothing) assemble the per-position outputs into
    :class:`ShardedTensor`s; a replicated output keeps every position's
    copy, as ``check_vma=False`` trusts them to agree."""

    def run(*args):
        specs = (in_specs,) if isinstance(in_specs, PartitionSpec) or not isinstance(
            in_specs, (tuple, list)) else in_specs
        if len(specs) != len(args):
            raise ValueError(f"{len(args)} operands for {len(specs)} in_specs")
        outs = []
        prev = getattr(_TLS, "current", None)
        try:
            for position in range(mesh.size):
                _TLS.current = (mesh, position)
                local_args = [_local_arg(a, s, mesh, position) for a, s in zip(args, specs)]
                outs.append(f(*local_args))
        finally:
            _TLS.current = prev
        if out_specs is None:
            return None
        single = isinstance(out_specs, PartitionSpec)
        ospecs = (out_specs,) if single else out_specs
        per_pos = [(o,) if single else tuple(o) for o in outs]
        results = tuple(
            ShardedTensor([p[k] for p in per_pos], NamedSharding(mesh, spec))
            for k, spec in enumerate(ospecs)
        )
        return results[0] if single else results

    return run
