"""Partition rules: parameters, optimizer state, batches, caches, activations.

Ported from ``repro.dist.sharding``: the same rule tables compute the same
specs, and a spec becomes DTensor placements over a
``torch.distributed.device_mesh.DeviceMesh``.

One table of *requested* specs plus one safety pass:

* ``_param_spec(name, ndim, fsdp)`` — the Megatron/FSDP rule table, keyed by
  the leaf's name.  Column-parallel matrices (``wq/wk/wv/w1/w3/...``) put
  tensor-parallel ``'model'`` on the output dim and FSDP axes on the input
  dim; row-parallel ones (``wo/w2/w_out``) the reverse; the embedding shards
  its (padded) vocab over ``'model'``.  Extra leading dims (the reference's
  scan-stacked layer axis, the MoE expert axis) are left unsharded by
  left-padding the base rule with ``None``.
* ``sanitize_spec(mesh, spec, shape)`` — drops any spec entry whose mesh-axis
  product does not divide the corresponding dim, so every *requested* layout
  degrades to a legal one on any mesh (1-rank runs, odd survivor counts
  after an elastic rebuild, the 256- and 512-rank production meshes).

Entry points (all return trees of :class:`NamedSharding` matching the input;
a tree is nested dicts, lists and tuples of anything with ``.shape`` and
``.ndim``: the port's split layout, or the reference's stacked one as
:mod:`repro_torch.bridge` lays it out):

  ``param_shardings``       2-d FSDPxTP (default) or ``mode="zero3"``;
                            ``include_pod=False`` keeps parameters replicated
                            over the pod axis; ``gather_safe=True`` drops the
                            tensor-parallel entries, so each leaf is sharded
                            along at most the FSDP axes.
  ``opt_state_shardings``   mirrors the parameter rules onto m/v/master.
  ``batch_shardings``       batch dim over the data axes (all axes in zero3).
  ``cache_shardings``       KV/recurrent-state layout; ``serve_tp=True``
                            shards heads/channels over ``'model'``.
  ``page_pool_shardings``   the paged serving pool's layout.
  ``serve_param_shardings`` pure tensor-parallel serving rules (no FSDP).
  ``activation_constraint_fn``  the hook installed into the model layer
                            (:mod:`repro_torch.models.hooks`): redistributes
                            residuals and logits that are DTensors.

**What a sharding is here.**  :class:`PartitionSpec` is a tuple of entries,
each ``None``, an axis name or a tuple of names, with the reference's
equality (a one-name tuple is that name).  ``NamedSharding(mesh, spec)``
keeps both; :meth:`NamedSharding.placements` gives one ``Shard(d)`` or
``Replicate()`` per mesh dim.  A grouped entry ``("pod", "data")`` on
tensor dim ``d`` is ``Shard(d)`` on both mesh dims: DTensor splits a dim
over several mesh dims in mesh-dim order, which is the reference's
major-to-minor order only when the tuple names the axes in the mesh's
order, so any other order is refused.  A mesh is a ``DeviceMesh`` with
``mesh_dim_names``, or anything with ``.axis_names`` and a ``.shape``
mapping of name to size (enough for the specs; placements need names only).

:func:`distribute` puts a tree of tensors onto its shardings, each rank
keeping its own slice of the whole tensor it holds (no collective: every
rank built or loaded the same values); :func:`gather` brings a sharded
tree back to whole tensors.
"""
from __future__ import annotations

from typing import Any, Callable, FrozenSet, Iterable, Optional, Tuple, Union

import torch

Axes = Union[None, str, Tuple[str, ...]]

# leaf-name rule tables -------------------------------------------------------
# column-parallel: (d_in -> fsdp, d_out -> model)
_COL = frozenset({
    "wq", "wk", "wv", "w1", "w3", "w_in", "w_gelu", "router", "head",
})
# row-parallel: (d_in -> model, d_out -> fsdp)
_ROW = frozenset({"wo", "w2", "w_out", "w_r", "w_i"})


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry a tensor dim, each
    ``None``, an axis name or a tuple of names (a one-name tuple is stored
    as the name, so ``P(("data",)) == P("data")``, as in jax)."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return "PartitionSpec" + (super().__repr__() if len(self) != 1
                                  else f"({self[0]!r},)")


P = PartitionSpec


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def _axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a mesh-shaped namespace."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(_axis_names(mesh), (int(s) for s in shape)))


def placements_of(mesh, spec: PartitionSpec) -> tuple:
    """One DTensor placement per mesh dim for ``spec``; a mesh dim of size 1
    replicates (a split into one piece is the whole tensor, and DTensor
    would refuse to reshape a dim it counts as split)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    sizes = _axis_sizes(mesh)
    dim_of = {}
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in group if a in names]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} names its axes out of the mesh's "
                             f"order {names}: DTensor cannot split a dim that way")
        dim_of.update((a, d) for a in group)
    return tuple(Shard(dim_of[a]) if a in dim_of and sizes[a] > 1 else Replicate()
                 for a in names)


class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def placements(self) -> tuple:
        return placements_of(self.mesh, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding(spec={self.spec!r})"


def map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts, lists and tuples; a path holds
    the dict keys and list indices from the root."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (NamedShardings are leaves)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def sanitize_spec(mesh, spec: PartitionSpec, shape: Tuple[int, ...]) -> PartitionSpec:
    """Drop spec entries whose mesh-axis product does not divide the dim.

    Partial sharding of a non-dividing dim is never attempted: the whole
    entry (including grouped ``(a, b)`` tuples) falls back to ``None``.
    """
    sizes = _axis_sizes(mesh)
    out = []
    for i, entry in enumerate(tuple(spec)):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        if any(n not in sizes for n in names):
            out.append(None)                 # axis absent from this mesh
            continue
        prod = 1
        for n in names:
            prod *= int(sizes[n])
        if i < len(shape) and shape[i] % prod == 0:
            out.append(entry)
        else:
            out.append(None)
    return P(*out)


def _param_spec(name: str, ndim: int, fsdp: Axes) -> PartitionSpec:
    """Requested spec for a parameter leaf called ``name`` with ``ndim`` dims.

    The base rule is 2-d; higher ranks (stacked layers, MoE expert axes)
    left-pad with ``None`` so only the trailing matrix is sharded.
    """
    if name == "embed":
        base: Tuple[Axes, ...] = ("model", fsdp)        # (padded vocab, d)
    elif name in _COL:
        base = (fsdp, "model")
    elif name in _ROW:
        base = ("model", fsdp)
    elif name == "conv_w":
        base = (None, "model")                          # (K, channels)
    else:                                               # vectors / scalars
        return P(*([None] * ndim))
    if ndim < len(base):
        return P(*([None] * ndim))
    return P(*(((None,) * (ndim - len(base))) + base))


def _leaf_name(path) -> str:
    """The innermost dict key of ``path`` that is not a layer index (list
    indices, and the reference's digit keys, are skipped)."""
    for key in reversed(path):
        if isinstance(key, str) and not key.isdigit():
            return key
    return ""


def _zero3_spec(mesh, shape: Tuple[int, ...], axes: Tuple[str, ...]) -> PartitionSpec:
    """Pure ZeRO-3: flat-shard the first dim the full axis product divides."""
    sizes = _axis_sizes(mesh)
    prod = 1
    for a in axes:
        prod *= int(sizes[a])
    for i, dim in enumerate(shape):
        if dim % prod == 0 and dim >= prod:
            return P(*([None] * i + [axes] + [None] * (len(shape) - i - 1)))
    return P(*([None] * len(shape)))


def _fsdp_axes(mesh, include_pod: bool) -> Axes:
    if "pod" in _axis_names(mesh) and include_pod:
        return ("pod", "data")
    return "data"


def _data_axes(mesh, exclude: FrozenSet[str] = frozenset()) -> Tuple[str, ...]:
    return tuple(a for a in _axis_names(mesh) if a != "model" and a not in exclude)


def param_shardings(
    mesh,
    params: Any,
    *,
    mode: str = "2d",
    include_pod: bool = True,
    gather_safe: bool = False,
) -> Any:
    """Tree of NamedSharding for a parameter tree (see module docstring)."""
    fsdp = _fsdp_axes(mesh, include_pod)
    zero3_axes = tuple(a for a in _axis_names(mesh) if include_pod or a != "pod")

    def leaf(path, x):
        if mode == "zero3":
            spec = _zero3_spec(mesh, tuple(x.shape), zero3_axes)
        else:
            spec = _param_spec(_leaf_name(path), x.ndim, fsdp)
            if gather_safe:
                spec = P(*(None if e == "model" else e for e in tuple(spec)))
        return NamedSharding(mesh, sanitize_spec(mesh, spec, tuple(x.shape)))

    return map_with_path(leaf, params)


def opt_state_shardings(mesh, param_sh: Any, opt_state: Any) -> Any:
    """Optimizer-state shardings: m/v/master mirror the parameter layout;
    scalars like ``step`` replicate."""
    repl = NamedSharding(mesh, P())
    out = {}
    for key, sub in opt_state.items():
        if key in ("m", "v", "master"):
            out[key] = _map(lambda s: s, param_sh)
        else:
            out[key] = _map(lambda _: repl, sub)
    return out


def batch_shardings(mesh, batch: Any, mode: str = "2d") -> Any:
    """Batch-dim data parallelism: dim 0 over the data(+pod) axes — over
    *every* axis in zero3 mode (no tensor parallelism to reserve 'model')."""
    if mode == "zero3":
        data = _axis_names(mesh)
    else:
        data = _data_axes(mesh)

    def leaf(x):
        if x.ndim == 0:
            return NamedSharding(mesh, P())
        spec = P(*((data,) + (None,) * (x.ndim - 1)))
        return NamedSharding(mesh, sanitize_spec(mesh, spec, tuple(x.shape)))

    return _map(leaf, batch)


# cache leaf rules: name -> (batch-dim index, tp-dim index) with the leading
# stack axis (if any) stripped before indexing.
_CACHE_RULES = {
    "k": (0, 2),          # (B, T, H, D)
    "v": (0, 2),
    "k_scale": (0, 2),    # (B, T, H)
    "v_scale": (0, 2),
    "conv": (0, 2),       # (B, K, C)
    "h": (0, 1),          # (B, heads/width, ...)
    "slot_pos": (None, None),
}


def _stacked(path) -> bool:
    return bool(path) and path[0] == "stack"


def cache_shardings(mesh, cache: Any, *, serve_tp: bool = False) -> Any:
    """Decode/prefill cache layout: batch over data axes; with ``serve_tp``
    the KV-head / state-channel dim additionally shards over 'model'."""
    data = _data_axes(mesh)

    def leaf(path, x):
        name = _leaf_name(path)
        offset = 1 if _stacked(path) else 0
        b_dim, tp_dim = _CACHE_RULES.get(name, (0, None))
        entries: list = [None] * x.ndim
        if b_dim is not None and b_dim + offset < x.ndim:
            entries[b_dim + offset] = data
        if serve_tp and tp_dim is not None and tp_dim + offset < x.ndim:
            entries[tp_dim + offset] = "model"
        return NamedSharding(mesh, sanitize_spec(mesh, P(*entries), tuple(x.shape)))

    return map_with_path(leaf, cache)


# page-pool leaf rules: name -> KV-head dim index with the leading stack axis
# (if any) stripped.  Page arrays are (n_pages, page, Hkv, D) / scale pages
# (n_pages, page, Hkv); recurrent-state leaves fall through to _CACHE_RULES
# (per-slot batch dim over the data axes).
_PAGE_RULES = {
    "k_pages": 2,
    "v_pages": 2,
    "k_scale_pages": 2,
    "v_scale_pages": 2,
}


def page_pool_shardings(mesh, blocks: Any, *, serve_tp: bool = True) -> Any:
    """Paged serving-pool layout (see ``repro_torch.serve.kvcache``).

    Page arrays replicate over the data axes — any decode slot must reach
    any physical page, so the pool cannot shard over requests — and with
    ``serve_tp`` split the KV-head dim over ``'model'``, matching the
    tensor-parallel head split of ``serve_param_shardings``.  Recurrent
    per-slot state shards its slot (batch) dim over the data axes like the
    dense cache.
    """
    data = _data_axes(mesh)

    def leaf(path, x):
        name = _leaf_name(path)
        offset = 1 if _stacked(path) else 0
        entries: list = [None] * x.ndim
        if name in _PAGE_RULES:
            if serve_tp:
                entries[_PAGE_RULES[name] + offset] = "model"
        else:
            b_dim, tp_dim = _CACHE_RULES.get(name, (0, None))
            if b_dim is not None and b_dim + offset < x.ndim:
                entries[b_dim + offset] = data
            if serve_tp and tp_dim is not None and tp_dim + offset < x.ndim:
                entries[tp_dim + offset] = "model"
        return NamedSharding(mesh, sanitize_spec(mesh, P(*entries), tuple(x.shape)))

    return map_with_path(leaf, blocks)


def serve_param_shardings(mesh, params: Any) -> Any:
    """Pure tensor-parallel serving rules: weights replicated over 'data'
    (throughput replicas), matrices Megatron-split over 'model' only."""

    def leaf(path, x):
        name = _leaf_name(path)
        if name == "embed":
            base: Tuple[Axes, ...] = ("model", None)
        elif name in _COL:
            base = (None, "model")
        elif name in _ROW:
            base = ("model", None)
        else:
            base = ()
        if len(base) > x.ndim:
            base = ()
        spec = P(*(((None,) * (x.ndim - len(base))) + base))
        return NamedSharding(mesh, sanitize_spec(mesh, spec, tuple(x.shape)))

    return map_with_path(leaf, params)


def activation_constraint_fn(
    mesh,
    exclude: Optional[Iterable[str]] = None,
    mode: str = "2d",
):
    """Build the hook for ``repro_torch.models.hooks.install_constraint``.

    Maps the model's logical activation names onto specs under ``mesh``:

      residual  (B, S, d)    batch over data(+pod) axes
      logits    (B, C, V)    batch over data axes, vocab over 'model'
      heads:n   (B, S, n*D)  the port's own: a projection about to be split
                             into n heads keeps a mesh dim's split of its
                             last dim only where the split falls on whole
                             heads (n divisible), else replicates it there
      groups:n  (B, S, H, D) likewise for H heads about to be split into n
                             GQA groups (dim -2)
      flat:n    (B, S, n*D)  the port's own: n pieces just flattened into the
                             last dim; the forward keeps its layout, and
                             the backward gives its gradient whole pieces as
                             ``heads:n`` does (the flatten's backward views
                             the gradient as n pieces)
      tokens    (B, S)       the port's own: token ids replicate before the
                             embedding lookup (DTensor's vocab-parallel
                             lookup masks the ids it was handed before it
                             gathers a batch split of them, and then fails
                             on the gathered ids)
      lookup    (B, S, d)    the port's own: the looked-up rows that join a
                             frontend's prefix rows, laid out as
                             ``residual``; in the backward their gradient,
                             a partial sum where it meets the prefix rows',
                             is reduced before it reaches the lookup's
                             masked partial sum (DTensor converts no
                             partial sum into another)

    ``exclude`` removes axes from the specs, as the reference's does for
    axes that are manual in the calling context.  Specs are sanitized per
    call, so odd batch remainders after an elastic rebuild simply
    replicate.  A DTensor is redistributed to the spec's placements (a
    no-op when it has them); a plain tensor is returned as it is.
    """
    excluded = frozenset(exclude or ())
    names = _axis_names(mesh)
    data = _data_axes(mesh, excluded)
    if mode == "zero3":
        data = tuple(a for a in names if a not in excluded)
        tp = None
    else:
        tp = "model" if ("model" in names and "model" not in excluded) else None
    batch_axes: Axes = data if data else None

    def constrain(x, name: str):
        from torch.distributed.tensor import DTensor

        if x.ndim < 2 or not isinstance(x, DTensor):
            return x
        if name == "tokens":
            return _whole_pieces(x, None, 1)
        if name.startswith(("heads:", "groups:")):
            kind, n = name.split(":")
            return _whole_pieces(x, x.ndim - (1 if kind == "heads" else 2), int(n))
        if name.startswith("flat:"):
            n = int(name.split(":")[1])
            return _GradLayout.apply(x, lambda g: _whole_pieces(g, g.ndim - 1, n))
        if name == "lookup":
            return _GradLayout.apply(constrain(x, "residual"), _reduced)
        if name == "logits":
            entries = (batch_axes,) + (None,) * (x.ndim - 2) + (tp,)
        elif name == "residual":
            entries = (batch_axes,) + (None,) * (x.ndim - 1)
        else:
            return x
        spec = sanitize_spec(mesh, P(*entries), tuple(x.shape))
        placements = placements_of(mesh, spec)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(x.device_mesh, placements)

    return constrain


class _GradLayout(torch.autograd.Function):
    """``x`` itself in the forward; in the backward its gradient redistributed
    by ``layout`` (a function of the gradient DTensor)."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.layout(grad), None


def _reduced(x):
    """``x`` with every partial sum reduced (replicated on that mesh dim)."""
    from torch.distributed.tensor import Replicate

    placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _whole_pieces(x, dim: Optional[int], n: int):
    """``x`` with every mesh dim that splits tensor dim ``dim`` (about to be
    viewed as n pieces) into a fractional number of pieces replicated
    there; ``dim`` None replicates every split."""
    from torch.distributed.tensor import Replicate

    sizes = x.device_mesh.shape
    placements = tuple(
        Replicate() if p.is_shard() and (dim is None or p.dim == dim and n % sizes[i]) else p
        for i, p in enumerate(x.placements))
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


# --------------------------------------------------------------------------
# trees of tensors onto their shardings, and back
# --------------------------------------------------------------------------

def distribute(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` as a DTensor on its sharding's mesh and
    placements.  Every rank holds the same whole tensors (drawn from one
    seed, or read from one file) and keeps its own slice: no collective."""
    from torch.distributed.tensor import distribute_tensor

    def leaf(x, sh):
        return distribute_tensor(x.detach(), sh.mesh, sh.placements(), src_data_rank=None)

    return _map(leaf, tree, shardings)


def gather(tree: Any) -> Any:
    """Whole tensors of a tree of DTensors (a collective on every rank of
    each leaf's mesh); plain tensors pass through."""
    from torch.distributed.tensor import DTensor

    return _map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)



# --------------------------------------------------------------------------
# hand-written kernels on local shards
# --------------------------------------------------------------------------

def model_size(mesh) -> int:
    """The size of the mesh's ``'model'`` axis (1 without one)."""
    return _axis_sizes(mesh).get("model", 1)


def local_placements(t, *, model_dim: Optional[int] = None, keep: Tuple[int, ...] = ()):
    """Placements for a kernel's operand ``t`` (a DTensor) on local shards:
    the ``'model'`` mesh dim splits tensor dim ``model_dim`` (None: that
    mesh dim keeps what ``keep`` allows); every mesh dim keeps a ``Shard``
    of a tensor dim in ``keep`` and replicates anything else (a partial sum
    is reduced first).  A plain tensor has none (None)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return None
    out = []
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if name == "model" and model_dim is not None:
            out.append(Shard(model_dim))
        elif p.is_shard() and p.dim in keep:
            out.append(p)
        else:
            out.append(Replicate())
    return tuple(out)


def on_shards(fn: Callable, args: tuple, in_placements: tuple, out_placements: tuple,
              grad_placements: Optional[tuple] = None):
    """``fn(*args)`` with each DTensor of ``args`` redistributed to its
    placements and handed to ``fn`` as the local tensor (DTensor's
    ``local_map``); plain tensors and other values pass through (their
    placements are None).  ``fn``'s one tensor comes back as a DTensor on
    ``out_placements``, or, where that is a tuple of placements tuples, its
    tuple of tensors, each on its own.  Autograd passes through: the same
    code trains.  ``grad_placements`` gives the layout of each argument's
    local gradient where it is not that of the argument (a ``Partial`` on
    a mesh dim whose ranks each use their own part of a replicated
    argument); None: the arguments' own.  In-place writes to a local
    tensor land in its DTensor's storage only when no redistribution was
    needed."""
    from torch.distributed.tensor.experimental import local_map

    many = bool(out_placements) and all(isinstance(p, tuple) for p in out_placements)
    out = tuple(out_placements) if many else list(out_placements)
    return local_map(fn, out_placements=out, in_placements=in_placements,
                     in_grad_placements=grad_placements, redistribute_inputs=True)(*args)


def write_on_shards(fn: Callable, args: tuple, in_placements: tuple) -> None:
    """``fn(*args)`` for its in-place writes alone, on local tensors as
    :func:`on_shards` hands them over; ``fn`` returns nothing.  The caller
    gives a DTensor that ``fn`` writes its own placements, so that the local
    tensor is its storage and not a redistributed copy."""
    from torch.distributed.tensor.experimental import local_map

    local_map(fn, out_placements=(None,), in_placements=in_placements,
              redistribute_inputs=True)(*args)


# --------------------------------------------------------------------------
# running a model whose parameters are DTensors
# --------------------------------------------------------------------------

def replica_mesh(mesh):
    """The mesh of a serving engine's weights and pages: the ``'model'``
    axis of this rank's row of ``mesh``.  ``serve_param_shardings`` and
    ``page_pool_shardings`` replicate both over the data axes, so the
    DTensors live on the row's sub-mesh, where only the model split is
    theirs.  The data split of the batch is not DTensor's: an engine on
    ``mesh`` decodes its own span of the slots as plain local rows
    (:func:`slot_split`) and meets the other data ranks in explicit
    collectives.  On the whole mesh DTensor would split a step's
    replicated work over the data axis (a contraction, or a batch that the
    data size does not divide, which it then cannot reshape)."""
    return mesh["model"] if mesh.ndim > 1 else mesh


class SlotSplit:
    """A data rank's span of a batch of ``n`` slots: ``Shard(0)``'s
    ``torch.chunk`` piece over the data axes, ``[lo, hi)``, on the rank of
    index ``index`` among ``size`` ranks, whose process ``group`` is the
    ranks of this rank's ``'model'`` coordinate.  Where the data size does
    not divide ``n`` (as ``sanitize_spec`` does), or is 1, the batch
    replicates: the span is the whole batch, ``size`` 1 and no group, and
    :meth:`gather` is the identity."""

    __slots__ = ("n", "lo", "hi", "index", "size", "group")

    def __init__(self, n: int, index: int = 0, size: int = 1, group=None):
        self.n, self.index, self.size, self.group = n, index, size, group
        rows = n // size
        self.lo, self.hi = index * rows, (index + 1) * rows

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    @property
    def split(self) -> bool:
        return self.size > 1

    def owns(self, slot: int) -> bool:
        return self.lo <= slot < self.hi

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``t`` (its rows first), concatenated along dim
        0 in the ranks' order: the whole batch's rows in slot order (one
        all-gather over the data group; none when the batch replicates)."""
        if not self.split:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def __repr__(self) -> str:
        return f"SlotSplit(n={self.n}, slots=[{self.lo}, {self.hi}), {self.size} data ranks)"


def slot_split(mesh, n: int) -> SlotSplit:
    """This rank's :class:`SlotSplit` of ``n`` slots over ``mesh``'s data
    axes (every axis but ``'model'``; several are taken together, in the
    mesh's order).  No mesh, one data rank, or a data size that does not
    divide ``n``: the whole batch."""
    if mesh is None:
        return SlotSplit(n)
    names = [a for a in _axis_names(mesh) if a != "model"]
    size = 1
    for a in names:
        size *= _axis_sizes(mesh)[a]
    if size == 1 or n % size:
        return SlotSplit(n)
    import torch.distributed as dist

    sub = mesh[names[0]] if len(names) == 1 else mesh[tuple(names)]._flatten()
    group = sub.get_group()
    return SlotSplit(n, dist.get_group_rank(group, dist.get_rank()), size, group)


def mesh_of(tree: Any):
    """The mesh of the first DTensor leaf of ``tree``; None when no leaf is
    one (an unsharded model: nothing to wrap)."""
    from repro_torch.device import is_dtensor

    found = []
    _map(lambda x: found.append(x.device_mesh) if is_dtensor(x) else None, tree)
    return found[0] if found else None


def replicating(mesh):
    """The context a sharded model runs in: a plain tensor that meets a
    DTensor (positions, page tables, RoPE angles, masks) counts as
    replicated on ``mesh``.  A null context when ``mesh`` is None."""
    import contextlib

    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def whole(t):
    """A DTensor as the whole tensor (gathered where it is split); a plain
    tensor as it is."""
    from repro_torch.device import is_dtensor

    return t.full_tensor() if is_dtensor(t) else t


def agree(mesh, value: float, device) -> float:
    """``value`` as the first rank of ``mesh`` has it, on every rank of the
    mesh (one broadcast over each mesh dim's group, from the rank at
    coordinate 0 of that dim: after the last, every rank holds the value
    of the rank at coordinate 0 of every dim).  The ranks of one engine,
    or of one fleet, take every host decision from the same clock."""
    import torch.distributed as dist

    buf = torch.tensor([value], dtype=torch.float64, device=device)
    coord = mesh.get_coordinate()
    for dim in range(mesh.ndim):
        src = list(coord)
        src[dim] = 0
        dist.broadcast(buf, src=int(mesh.mesh[tuple(src)]), group=mesh.get_group(dim))
    return float(buf.item())
