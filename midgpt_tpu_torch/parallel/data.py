"""Host-side batch plumbing of a multi-rank run (counterpart of
midgpt_tpu/parallel/data.py:19-38).

JAX: each process draws its process-local batch (batch_size //
process_count rows) from its own slice of the token stream, and
`make_array_from_process_local_data` lays those rows over the process's
devices along ('data', 'fsdp'). The port: every rank of a node draws the
node's batch the same way (the node is JAX's process, parallel/dist.py)
and keeps the rows of its batch position, in the mesh's flattened (data,
fsdp) order (parallel/mesh.py); the ranks of a tp row keep the same rows. On
one node the global batch is then positional and does not depend on the
rank count, as JAX's is on one host: a resume across rank counts
continues the same trajectory.
"""

from __future__ import annotations

import numpy as np

from midgpt_tpu_torch.parallel import dist as pdist
from midgpt_tpu_torch.parallel.mesh import Mesh


def node_batch_size(batch_size: int, mesh: Mesh) -> int:
    """Rows of the global batch each node draws (JAX's batch_size //
    process_count); the global batch must split evenly over the batch
    positions (data x fsdp: the ranks of a tp row share their rows, as
    JAX's batch_spec leaves 'tp' off the batch axis), and a tp row must
    sit on one node."""
    if batch_size % mesh.batch_size:
        raise ValueError(f"batch_size={batch_size} does not split over the mesh's {mesh.batch_size} batch positions "
                         f"(data x fsdp)")
    if (mesh.size // pdist.n_nodes()) % mesh.tp:
        raise ValueError(f"{mesh.size // pdist.n_nodes()} ranks a node do not hold whole tp rows of {mesh.tp}")
    return batch_size // pdist.n_nodes()


def rank_rows(a: np.ndarray, mesh: Mesh) -> np.ndarray:
    """This rank's rows of a node batch, (G, B, T) or (B, T): the batch
    positions on this node take equal consecutive slices of the B axis,
    and the ranks of a tp row take the same slice."""
    per_node = mesh.batch_size // pdist.n_nodes()
    if per_node == 1:
        return a
    b = a.shape[-2] // per_node
    i = mesh.batch_index % per_node
    return a[..., i * b:(i + 1) * b, :]
