"""``repro_torch.serve`` — continuous-batching serving, ported from ``repro.serve``.

``kvcache``    paged KV pool (host accounting copied, device blocks as
               tensors) and the paged single-token decode attention.
``scheduler``  copied: arrival queue, page-bounded admission, Poisson traces.
``slack``      copied: decode underfill and idle gaps as governor phases.
``slo``        copied: TTFT/TPOT percentiles and the concurrency cap.
``engine``     :class:`ContinuousEngine`, :class:`EngineSession` and the
               legacy :class:`ServeEngine`.
"""
