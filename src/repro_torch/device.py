"""Device choice shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` unless the caller names another device.

    Raises when CUDA is asked for (explicitly or by default) and absent:
    the port never falls back to the CPU on its own.  A bare ``cuda``
    becomes the current card (``cuda:0``), so it compares equal to the
    device of tensors placed there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (or --device cpu) to "
                "run on the CPU")
        if dev.index is None:          # name the card, as tensors on it do
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
