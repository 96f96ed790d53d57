"""``repro_torch.dist`` — the distributed-runtime substrate, ported from
``repro.dist``.

``elastic``      :class:`ElasticMesh` (a rank set over the default process
                 group that survives rank failures: the survivors' group is
                 rebuilt) and :class:`FailureInjector` (deterministic fault
                 injection for the recovery path; copied).
``checkpoint``   :class:`CheckpointManager` — atomic, optionally async
                 save/restore with retention pruning, in the reference's
                 file format; the restart substrate for the launcher's
                 mesh-epoch recovery loop.
``compression``  int8 gradient codec + :func:`compressed_psum`, the
                 wire-thrifty cross-pod reduction.
``straggler``    :class:`StragglerDetector` — turns barrier-arrival events
                 into a per-rank laggard signal (copied).
``sharding``     partition rules: FSDP/TP parameter shardings (2-d and
                 zero3), optimizer-state mirrors, batch/cache/page-pool
                 layouts, tensor-parallel serving rules, activation
                 constraints; each spec becomes DTensor placements over a
                 ``DeviceMesh``.

``compat`` holds the reference's jax shims and has no counterpart.
"""
from repro_torch.dist import sharding  # noqa: F401
from repro_torch.dist.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.dist.compression import compressed_psum  # noqa: F401
from repro_torch.dist.elastic import ElasticMesh, FailureInjector  # noqa: F401
from repro_torch.dist.straggler import StragglerDetector  # noqa: F401
