"""Every kernel wrapper of the port called once on small inputs, for the
tests that hold the wrappers' refusal of autograd (CPU: ``meta`` tensors
stand in for a card; ``test_torch_cuda.py``: the card).  Imports torch
alone."""
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssd as SSD


def wrapper_calls(device, requires_grad):
    """Each kernel wrapper called once on small float inputs on ``device``
    (the float inputs requiring grad when asked); name -> thunk."""
    gen = torch.Generator().manual_seed(0)

    def f(*shape):
        x = torch.randn(shape, generator=gen).to(device)
        return x.requires_grad_(requires_grad)

    def i32(*values):
        return torch.tensor(values, dtype=torch.int32, device=device)

    b, hkv, g, d, page = 2, 1, 2, 8, 4
    return {
        "rmsnorm": lambda: RN.rmsnorm(f(3, 8), f(8)),
        "flash_attention": lambda: FA.flash_attention(f(1, 2, 5, 8), f(1, 1, 5, 8),
                                                      f(1, 1, 5, 8)),
        "rglru_scan": lambda: RS.rglru_scan(f(1, 5, 4).sigmoid(), f(1, 5, 4), f(1, 4)),
        "ssd_scan": lambda: SSD.ssd_scan(f(1, 6, 2, 4), f(1, 6, 2).abs(), -f(2).abs(),
                                         f(1, 6, 4), f(1, 6, 4), chunk=4),
        "paged_attention_scatter": lambda: PA.paged_attention_scatter(
            f(b, hkv, g, d), f(b, hkv, d), f(b, hkv, d), f(5, page, hkv, d),
            f(5, page, hkv, d), i32([1, 2], [3, 4]), i32(5, 6), i32(2, 4), i32(1, 2)),
        "paged_attention": lambda: PA.paged_attention(
            f(b, hkv, g, d), f(5, page, hkv, d), f(5, page, hkv, d),
            i32([1, 2], [3, 4]), i32(5, 6)),
        "paged_scatter": lambda: PA.paged_scatter(
            (f(5, page, hkv, d), f(5, page, hkv, d)), (f(b, hkv, d), f(b, hkv, d)),
            i32(2, 4), i32(1, 2)),
        "paged_scatter_step": lambda: PA.paged_scatter_step(
            torch.zeros(b, 2 * hkv * d * 4, dtype=torch.uint8, device=device),
            [(f(5, page, hkv, d), f(5, page, hkv, d))], i32(2, 4), i32(1, 2)),
    }
