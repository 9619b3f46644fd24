"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import typing as tp

import torch

DeviceLike = tp.Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one. Asking for CUDA (explicitly or by default) on a machine
    without it raises — nothing quietly continues on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "(--device cpu) to run on the CPU explicitly"
        )
    return dev
