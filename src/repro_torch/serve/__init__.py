"""``repro_torch.serve`` — continuous-batching serving, ported from ``repro.serve``.

``kvcache``    paged KV pool (host accounting copied, device blocks as
               tensors), the paged single-token decode attention and the
               copy-on-write page clone for prefix sharing.
``scheduler``  copied: arrival queue, page-bounded admission, Poisson traces.
``slack``      copied: decode underfill and idle gaps as governor phases.
``slo``        copied: TTFT/TPOT percentiles and the concurrency cap.
``engine``     :class:`ContinuousEngine` (with prefix-cache joins and the
               tracer's join/evict instants), :class:`EngineSession` and
               the legacy :class:`ServeEngine`.
``fleet``      so far the per-replica :class:`~repro_torch.serve.fleet.
               prefix.PrefixCache`; the rest of the fleet is the next slice.
"""
