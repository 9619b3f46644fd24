"""Process plumbing of a multi-rank run: what `jax.distributed.initialize()`
and `jax.process_count/index` are to the JAX package (launch.py:98-99).

JAX runs one process per host, which drives every chip of that host;
PyTorch runs one process per device. So the port's *node* (torchrun's
GROUP_RANK, WORLD_SIZE // LOCAL_WORLD_SIZE) is JAX's process, and the
port's *rank* is JAX's device: the data split is by node
(data/dataset.py), the batch rows by rank (parallel/data.py).

`init` joins the process group from torchrun's environment (`env://`:
RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or, when MIDGPT_DIST_FILE
names a file, through a FileStore on that file (no port to pick; the
tests and `robustness/chaos_train.py` spawn their ranks that way). The
backend follows the device: NCCL for CUDA ranks, gloo for CPU ranks. A
caller may name it: NCCL refuses two ranks of one communicator on one
card, so ranks that share a card name gloo, whose collectives take CUDA
tensors as they are (all_gather_into_tensor, reduce_scatter_tensor,
all_reduce and broadcast, in f32 and bf16, as torch 2.11's gloo does).
A backend that cannot start raises; nothing falls back to another.

Rank r runs on `cuda:(LOCAL_RANK mod the card count)`: one card per rank
when there are enough, ranks sharing cards round robin when not (which
only gloo accepts), or on the CPU when the caller asks for it.
"""

from __future__ import annotations

import datetime
import os
import typing as tp

import torch
import torch.distributed as dist

from midgpt_tpu_torch.device import DeviceLike, resolve_device

STORE_ENV = "MIDGPT_DIST_FILE"
BACKENDS = ("nccl", "gloo")
# a collective that waits longer than this raises instead of hanging the run
TIMEOUT = datetime.timedelta(minutes=10)


def _env(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def local_rank() -> int:
    return _env("LOCAL_RANK", 0)


def local_world() -> int:
    return _env("LOCAL_WORLD_SIZE", 1)


def node() -> int:
    """This rank's node (JAX's process index)."""
    return _env("GROUP_RANK", 0)


def n_nodes() -> int:
    """The node count (JAX's process count)."""
    return max(1, _env("WORLD_SIZE", 1) // local_world())


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: the CPU when asked, else
    cuda:(LOCAL_RANK mod the card count) (raises without CUDA)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def init(device: DeviceLike = None, backend: tp.Optional[str] = None) -> torch.device:
    """Join the process group (module docstring); returns this rank's
    device. Idempotent: a second call only returns the device."""
    dev = rank_device(device)
    if initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} ({' or '.join(BACKENDS)})")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA ranks; CPU ranks take 'gloo'")
        if local_world() > torch.cuda.device_count():
            raise ValueError(
                f"{local_world()} ranks on this node but {torch.cuda.device_count()} card(s): NCCL takes one "
                "card per rank (ranks that share a card name backend 'gloo')"
            )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    r, n = _env("RANK", 0), _env("WORLD_SIZE", 1)
    kw = dict(backend=backend, rank=r, world_size=n, timeout=TIMEOUT)
    path = os.environ.get(STORE_ENV)
    if path:
        dist.init_process_group(store=dist.FileStore(path, n), **kw)
    else:
        dist.init_process_group(init_method="env://", **kw)
    return dev


def backend() -> tp.Optional[str]:
    return dist.get_backend() if initialized() else None


def shutdown() -> None:
    if initialized():
        dist.destroy_process_group()
