"""Device resolution for the port's entry points: the card by default, the
CPU only when the caller asks for it, never a silent fallback."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``. Raises when a
    CUDA device is asked for and PyTorch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
