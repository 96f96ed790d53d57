"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

It stands beside the JAX package and imports nothing of it: modules that
``repro`` keeps free of JAX are copied here with their imports pointed at
``repro_torch``, and the rest is ported to PyTorch.  Entry points run on
``cuda`` unless the caller asks for ``device="cpu"``; see
:func:`repro_torch.device.resolve_device`.
"""
