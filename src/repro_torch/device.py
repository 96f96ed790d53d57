"""Device choice shared by the port's entry points."""
from __future__ import annotations

import os
import sys
from typing import Optional, Union

import torch
import torch.distributed as dist


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


def join_group(device: torch.device) -> bool:
    """Join ``torchrun``'s world when its environment is set, else make a
    world of 1 (NCCL on the card, gloo on the CPU), unless a default group
    exists already.  Returns whether this call made the group (and so must
    destroy it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


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


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, without importing DTensor's package (no
    DTensor exists before something imported it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)
