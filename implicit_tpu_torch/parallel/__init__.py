"""Training and serving over a mesh of devices, driven from one process.

The counterpart of ``implicit_tpu/parallel/``. A ``Mesh`` is an ordered list
of devices (:mod:`.mesh`); a device may repeat, so D shards can run on one
card (``virtual_mesh``). Every collective is an explicit tensor op: an
all-gather is a ``torch.cat`` of the shards copied to a device, a psum a sum
in shard order. No ``torch.distributed`` process group is involved: the
public surface, ``AlternatingLeastSquares(mesh=4).fit(...)`` from one
process returning whole factor tables, stays the JAX package's.

Two training layouts exist:

- **Row-sharded** (:mod:`.als_sharded`, the layout ``mesh=`` models use):
  both factor tables are sharded on their rows in a strided permutation,
  each shard packs and solves only its own rows with the single-device
  solves (the CUDA kernels, launched per shard), and the collectives are
  one all-gather of the opposite side and one sum of gramians per
  half-iteration.
- **Replicated-factor** (:func:`shard_buckets`): chunk tensors split on the
  row axis while the factors stay whole on every device.

Serving (:func:`sharded_topk`, and ``recommend`` / ``similar_*`` on meshed
models) shards the item axis: each shard scores and selects, and one
``torch.topk`` merges the candidates.
"""

from . import als_sharded
from .als_sharded import RowShardedBuckets
from .mesh import Mesh, create_mesh, replicated, shard_buckets, virtual_mesh
from .topk_sharded import sharded_topk

__all__ = [
    "als_sharded", "create_mesh", "shard_buckets", "sharded_topk", "virtual_mesh",
    "Mesh", "RowShardedBuckets", "replicated",
]
