"""Device selection. The port never picks a device on its own: callers
name one, and asking for CUDA on a machine without it is an error, not
a silent fall-back to the CPU."""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

ENV = "MINIALIGN_TORCH_DEVICE"


def resolve_device(name: str | None = "cuda") -> torch.device:
    """`"cuda"` (the default) or `"cpu"` -> torch.device. Raises when
    CUDA is asked for and absent."""
    import torch

    if name is None:
        name = "cuda"
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                f"False; pass device='cpu' (or {ENV}=cpu) to run the "
                "plain PyTorch path")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev


def env_device() -> torch.device:
    """The CLI's device: $MINIALIGN_TORCH_DEVICE, default cuda."""
    return resolve_device(os.environ.get(ENV, "cuda"))


def env_device_type() -> str:
    """env_device()'s type ("cuda" or "cpu") from the variable alone,
    without importing torch or checking the device."""
    return os.environ.get(ENV, "cuda").split(":")[0]
