"""Copied from ``repro.obs``: so far only the structured launcher logger
(``log``); the metrics registry, the span tracer and the exporters come
with the observability slice (ROADMAP.md, queue 1)."""
