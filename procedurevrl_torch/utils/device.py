"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fall-back from one to the other."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  Raises if a CUDA device is asked for and
    there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain PyTorch path on the CPU")
    return device
