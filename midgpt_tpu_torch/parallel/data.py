"""Host-side batch plumbing of a multi-rank run (counterpart of
midgpt_tpu/parallel/data.py:19-38).

JAX: each process draws its process-local batch (batch_size //
process_count rows) from its own slice of the token stream, and
`make_array_from_process_local_data` lays those rows over the process's
devices along ('data', 'fsdp'), and along 'sp' on the sequence axis under
sequence parallelism (batch_spec(shard_seq=True)). The port: every rank
of a node draws the node's batch the same way (the node is JAX's
process, parallel/dist.py) and keeps the rows of its batch position, in
the mesh's flattened (data, fsdp) order (parallel/mesh.py), then the
contiguous T/sp columns of its sequence shard; the ranks of a tp row, the
stages of a pipeline and the ep ranks of a position keep the same rows
and columns (JAX's batch spec replicates the batch over 'tp', 'pp' and
'ep'). On one node the global batch is then
positional and does not depend on the rank count, as JAX's is on one
host: a resume across rank counts continues the same trajectory.
"""

from __future__ import annotations

import numpy as np

from midgpt_tpu_torch.parallel import dist as pdist
from midgpt_tpu_torch.parallel.mesh import Mesh


def node_batch_size(batch_size: int, mesh: Mesh) -> int:
    """Rows of the global batch each node draws (JAX's batch_size //
    process_count); the global batch must split evenly over the batch
    positions (data x fsdp: the ranks of a tp row share their rows, as
    JAX's batch_spec leaves 'tp' off the batch axis, and so do the stages
    of a pipeline and the ep ranks of a position), and a batch position's
    sp x tp x pp x ep ranks must sit on one node."""
    if batch_size % mesh.batch_size:
        raise ValueError(f"batch_size={batch_size} does not split over the mesh's {mesh.batch_size} batch positions "
                         f"(data x fsdp)")
    pp, ep = getattr(mesh, "pp", 1), getattr(mesh, "ep", 1)
    if (mesh.size // pdist.n_nodes()) % (mesh.sp * mesh.tp * pp * ep):
        raise ValueError(f"{mesh.size // pdist.n_nodes()} ranks a node do not hold whole sp x tp x pp x ep blocks "
                         f"of {mesh.sp} x {mesh.tp} x {pp} x {ep}")
    return batch_size // pdist.n_nodes()


def rank_rows(a: np.ndarray, mesh: Mesh) -> np.ndarray:
    """This rank's block of a node batch, (G, B, T) or (B, T): the batch
    positions on this node take equal consecutive slices of the B axis
    (the ranks of a tp row, an sp group, a pp group and an ep group the
    same slice), and the sp
    ranks of a position equal consecutive slices of the T axis."""
    per_node = mesh.batch_size // pdist.n_nodes()
    if per_node > 1:
        b = a.shape[-2] // per_node
        i = mesh.batch_index % per_node
        a = a[..., i * b:(i + 1) * b, :]
    if mesh.sp > 1:
        if a.shape[-1] % mesh.sp:
            raise ValueError(f"sequence length {a.shape[-1]} does not split over mesh.sp={mesh.sp}")
        t = a.shape[-1] // mesh.sp
        a = a[..., mesh.sp_index * t:(mesh.sp_index + 1) * t]
    return a
