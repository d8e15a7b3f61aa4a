"""The device mesh: an ordered list of devices, one per shard.

The counterpart of ``implicit_tpu/parallel/mesh.py``. One process drives
every shard, as JAX's single-controller ``shard_map`` does: a shard's work
runs on its own device, and the collectives are tensor ops (``torch.cat``
of the shards copied to a device for an all-gather; a sum in shard order
for a psum). A device may repeat: ``virtual_mesh(4, "cuda:0")`` runs four
shards on one card, the counterpart of XLA's
``--xla_force_host_platform_device_count`` on the host.
"""

import numpy as np
import torch

from .._device import resolve_device


class Mesh:
    """A 1-D mesh: ``devices`` in shard order, on the axis ``"d"``.

    ``shape`` is ``{"d": size}``, as the JAX mesh's; ``virtual`` is True
    when a device holds more than one shard. Two meshes over the same
    devices in the same order are equal (and hash alike), so a mesh keys
    the serving caches.
    """

    axis_names = ("d",)

    def __init__(self, devices):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got {devices}")
        self.devices = devices

    @property
    def size(self):
        return len(self.devices)

    @property
    def shape(self):
        return {"d": self.size}

    @property
    def virtual(self):
        return len(set(self.devices)) < self.size

    def distinct(self):
        """The mesh's devices, each once, in shard order."""
        return list(dict.fromkeys(self.devices))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def create_mesh(n_devices=None, device="cuda"):
    """A mesh over the first ``n_devices`` devices of ``device``'s type.

    On CUDA it takes cards 0..n-1 (all visible cards by default) and raises
    when fewer are visible: it never moves to the CPU, as the JAX
    function's fallback to virtual host devices does. On the CPU it builds
    ``n_devices`` virtual shards on the one host device (1 by default).
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return virtual_mesh(1 if n_devices is None else n_devices, dev)
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if n > visible:
        raise ValueError(
            f"requested a {n}-device mesh but only {visible} CUDA device(s) are visible; "
            "pass mesh<=" f"{visible}, or a virtual mesh (parallel.virtual_mesh) to run "
            "several shards on one card")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def virtual_mesh(n_shards, device):
    """``n_shards`` shards on the one device ``device``."""
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return Mesh([resolve_device(device)] * n)


def check_mesh_arg(mesh):
    """Raises ``ValueError`` unless ``mesh`` is what a model's ``mesh=``
    takes: None, a :class:`Mesh`, or an int >= 1 (resolved when it is used,
    :func:`resolve_mesh`)."""
    if not (mesh is None or isinstance(mesh, Mesh)
            or (isinstance(mesh, (int, np.integer)) and not isinstance(mesh, bool)
                and mesh >= 1)):
        raise ValueError(f"mesh must be None, a parallel.Mesh or an int >= 1, got {mesh!r}")


def resolve_mesh(mesh, device, virtual=False):
    """A ``mesh=`` argument as a :class:`Mesh`, or None: a Mesh as it is; an
    int n as ``create_mesh(n, device)`` (n cards on CUDA, raising where
    fewer are visible; n virtual shards on the CPU), or as
    ``virtual_mesh(n, device)`` with ``virtual`` (a model pickled with a
    virtual mesh)."""
    check_mesh_arg(mesh)
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return (virtual_mesh if virtual else create_mesh)(int(mesh), device)


def mesh_state(state):
    """A model's pickled ``state`` with its ``mesh`` stored as the mesh's
    size (and ``_mesh_virtual``), rebuilt on the model's device where it is
    next resolved: a mesh over several cards then raises where fewer are
    visible, a virtual mesh stays virtual."""
    mesh = state.get("mesh")
    if isinstance(mesh, Mesh):
        state["mesh"] = mesh.size
        state["_mesh_virtual"] = mesh.virtual
    return state


def replicated(mesh, x):
    """``x`` (a tensor or an array) on every device of the mesh: one tensor
    per shard, shards of one device sharing theirs."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    copies = {d: t.to(d) for d in mesh.distinct()}
    return [copies[d] for d in mesh.devices]


class ShardedBucketClass:
    """One bucket class with its chunks' row axis split over the mesh:
    ``rows[k]`` (n, C) and ``indices[k]`` / ``data[k]`` (n, C, L) on shard
    k's device, global row ids (the sentinel is the bucketed matrix's)."""

    __slots__ = ("L", "C", "n_chunks", "rows", "indices", "data", "lengths")

    def __init__(self, L, rows, indices, data, lengths):
        self.L = L
        self.n_chunks, self.C = rows[0].shape
        self.rows = rows
        self.indices = indices
        self.data = data
        self.lengths = lengths


class ShardedBuckets:
    """The replicated-factor layout of a host ``BucketedCSR``: every class's
    C rows padded with the sentinel to a multiple of the mesh size and split
    into equal slices, one per shard; the factors stay whole on every device
    (:func:`replicated`). Each shard solves its slice of every chunk against
    its replica, and the solved rows are then merged, the counterpart of the
    JAX layout's all-reduce of scattered updates."""

    def __init__(self, bucketed, mesh):
        n = mesh.size
        self.shape = bucketed.shape
        self.n_rows = bucketed.n_rows
        self.nnz = bucketed.nnz
        self.sentinel = bucketed.sentinel
        self.empty_rows = (replicated(mesh, bucketed.empty_rows.astype(np.int64))
                           if len(bucketed.empty_rows) else None)
        self.classes = []
        for cls in bucketed.classes:
            rows, idx, dat, lens = cls.rows, cls.indices, cls.data, cls.lengths
            pad = -rows.shape[1] % n
            if pad:
                rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=bucketed.sentinel)
                idx = np.pad(idx, ((0, 0), (0, pad), (0, 0)))
                dat = np.pad(dat, ((0, 0), (0, pad), (0, 0)))
                lens = np.pad(lens, ((0, 0), (0, pad)))
            split = lambda a: [torch.as_tensor(np.ascontiguousarray(p)).to(d)  # noqa: E731
                               for p, d in zip(np.split(a, n, axis=1), mesh.devices)]
            self.classes.append(ShardedBucketClass(
                cls.L, split(rows.astype(np.int64)), split(idx), split(dat), split(lens)))


def shard_buckets(bucketed, mesh):
    """A host ``BucketedCSR``'s chunk tensors split over the mesh on the
    row axis (:class:`ShardedBuckets`)."""
    return ShardedBuckets(bucketed, mesh)
