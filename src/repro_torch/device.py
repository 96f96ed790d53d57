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


KERNELS = ("plain", "cuda")


def resolve_kernel(kernel: Optional[str], device: Union[str, torch.device]) -> str:
    """The kernel choice (``attn_kernel``): plain PyTorch or the hand-written
    kernels.  ``None`` follows the device: ``"cuda"`` on a CUDA device,
    ``"plain"`` elsewhere.  An explicit ``"plain"`` on the card is allowed;
    an explicit ``"cuda"`` reaches the kernel wrappers, which take their
    plain versions for CPU tensors."""
    if kernel is None:
        return "cuda" if torch.device(device).type == "cuda" else "plain"
    if kernel not in KERNELS:
        raise ValueError(f"unknown attn_kernel {kernel!r}; expected one of {KERNELS} or None")
    return kernel
