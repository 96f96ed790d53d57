"""Multi-pod dry run: every (arch x shape x mesh) cell counted on ``meta``
tensors over a fake 256/512-rank world, ported from ``repro.launch.dryrun``.

For each cell this:
  1. initialises a fake process group of 256 or 512 ranks
     (``torch.testing._internal.distributed.fake_pg``: collectives return
     at once, nothing is sent) and builds the production mesh over it
     (:func:`repro_torch.launch.mesh.make_production_mesh`: 16x16 single
     pod, 2x16x16 multi-pod), in place of the reference's 512 emulated
     host devices;
  2. builds the model, optimizer state, caches and batches on ``meta``
     (no allocation) and distributes them onto the reference's shardings
     (:func:`build_cell`);
  3. runs the step once on those DTensors under a counting dispatch mode
     that sees each rank's *local* operations, below DTensor: this proves
     the distribution config is coherent (shardings divide, collectives
     are legal) and counts, per rank, what the reference reads from
     ``memory_analysis()``, ``cost_analysis()`` and its post-SPMD HLO;
  4. writes the record into ``artifacts/dryrun_torch/<cell>.json``.

Eager PyTorch has neither a scanned module that undercounts nor a buffer
assigner, so the reference's two compiles become one pass; its seconds
fill both ``compile_scan_s`` and ``compile_unroll_s``.  The record keys
are the reference's:

``memory`` (bytes a rank)
    ``argument_bytes``  the local shards of every argument the step reads.
                        An argument the step only overwrites whole before
                        reading it (the prefill cache) is output only, as
                        the reference's ``jit`` prunes an unread argument.
    ``output_bytes``    the local shards of every output, plus the 8-byte
                        pointer a leaf of the reference's output tuple
                        (its stacked layout: one leaf a period position)
                        that XLA's output buffer holds.
    ``alias_bytes``     the outputs that are arguments the step read and
                        wrote in place (where the reference donates: the
                        train state, the decode cache).
    ``temp_bytes``      the highest sum of live bytes of the storages the
                        step allocates, outputs left out.
    ``peak_args_plus_temp``  the reference's formula: arguments + temp +
                        max(0, output - alias).
``cost``
    ``flops``           ``torch.utils.flop_counter``'s formulas over the
                        local operations (their shard shapes: products,
                        convolutions, attention).  Elementwise work counts
                        nothing, where XLA's ``cost_analysis`` counts it.
    ``bytes_accessed``  the traffic below.
``traffic``             the plain path's traffic: the local bytes of every
                        operation's output (views and allocations without
                        a write excluded) plus the arguments.  The
                        analogue of the reference's ``parse_memory_traffic``
                        in an unfused program; the kernels move less,
                        so it bounds no kernel path (the FLOPs and the
                        arguments plus outputs do).
``collectives``         the reference's five kinds, each a count,
                        per-rank result bytes and wire bytes by its ring
                        model (:func:`wire_bytes`) from the operation's
                        group size, over functional collectives (DTensor's)
                        and ``c10d`` operations (``cd_psum``'s; its
                        artificial barrier is a 1-element all-reduce, as
                        the reference's).  On this CPU mesh DTensor moves a
                        shard from one dim to another by all-gather (the
                        CPU backend has no all-to-all), where XLA uses an
                        all-to-all.

Left out, having no counterpart here: ``hlo_bytes`` and
``cost.transcendentals``.  The step runs on the plain path: on ``meta``
:func:`~repro_torch.device.resolve_kernel` picks it, as the reference's
``make_serve_steps`` takes XLA attention.  A decode cell's position is a
0-d int32 host tensor (the port reads it on the host to pick the cache
slot; its 4 bytes count as the reference's scalar argument does).

Records are cached: finished cells are skipped on re-run, so the sweep is
resumable.  ``--instrument barrier`` on a multi-pod mesh runs the
pod-explicit step (:func:`repro_torch.train.loop.make_pod_train_step`),
its gradients reduced over ``pod`` through the instrumented ``cd_psum``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
  python -m repro_torch.launch.dryrun --list
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, cell_is_runnable, get_config
from repro_torch.core import instrument
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.hooks import constrain, install_constraint
from repro_torch.models.inputs import decode_inputs_specs, input_specs
from repro_torch.models.transformer import init_cache, init_params, stack_layout
from repro_torch.obs import log as obslog
from repro_torch.serve.engine import make_serve_steps
from repro_torch.train.loop import TrainConfig, make_pod_train_step, make_train_step
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.tree import leaves

log = obslog.get_logger("dryrun")

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                       "dryrun_torch")

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
)

# the reference's output is one tuple, whose buffer holds a pointer a leaf
_TUPLE_POINTER_BYTES = 8

_KIND_OF = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
# the operand that holds each kind's result (schema argument name)
_RESULT_ARG = {"allgather_": "output_tensors", "_allgather_base_": "output_tensor",
               "reduce_scatter_": "output_tensors", "_reduce_scatter_base_": "output_tensor",
               "alltoall_base_": "output", "allreduce_": "tensors", "send": "tensors"}
# operations that write their destination whole without reading it
_OVERWRITES = frozenset({"copy_", "zero_", "fill_"})
# operations that read only their operands' metadata, and allocations
# that write nothing
_NO_READ = frozenset({"empty_like", "zeros_like", "ones_like", "full_like", "new_empty",
                      "new_empty_strided", "new_zeros", "new_ones", "new_full",
                      "empty_strided", "empty", "sym_size", "sym_stride", "sym_numel",
                      "sym_storage_offset"})
_NO_WRITE = frozenset({"empty_like", "new_empty", "new_empty_strided", "empty_strided",
                       "empty"})


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """The reference's wire-bytes model (ring algorithms, per rank) for one
    collective over a group of ``g`` ranks:

      all-gather:        out*(g-1)/g      reduce-scatter: out*(g-1)
      all-reduce:        2*size*(g-1)/g   all-to-all:     size*(g-1)/g
      collective-permute: size
    """
    g = max(int(g), 1)
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return result_bytes


def _tensors(x):
    """The tensors in an operand (a tensor, or nested lists of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _local(t):
    from repro_torch.device import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def _group_size(args) -> int:
    """The size of the group an operation's arguments name (a group name
    or a ``ProcessGroup`` object)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
        if hasattr(a, "size") and hasattr(a, "rank") and not isinstance(a, torch.Tensor):
            return int(a.size())
    return 1


def _in_sharding_propagation() -> bool:
    """Whether the operation being dispatched was called by DTensor's
    sharding propagation (within a few tens of frames up the Python stack:
    the dispatch wrappers, then the propagator's tree maps over its fake
    arguments)."""
    f = sys._getframe(2)
    for _ in range(24):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _clear_propagation_caches() -> None:
    """Empty DTensor's sharding-propagation caches, so that a count that
    runs DTensor operations runs the propagator at least once (the check
    that :func:`_in_sharding_propagation` still recognises it)."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    clears = [getattr(getattr(prop, name, None), "cache_clear", None)
              for name in ("propagate_op_sharding", "_propagate_tensor_meta_cached")]
    # the C++ dispatch's own cache, where torch has one
    clears.append(getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None))
    for clear in clears:
        if clear is not None:
            clear()


class StepCounter(TorchDispatchMode):
    """Counts each rank's local operations: FLOPs by
    ``torch.utils.flop_counter``'s formulas, output bytes, collectives by
    kind, and the live bytes of the storages the step allocates.

    DTensor operations are let through (``NotImplemented``) so that DTensor
    runs and its local operations and collectives come back here, as
    ``CommDebugMode`` does.  ``args`` are the step's arguments (their
    local tensors): the counter records which of them the step reads."""

    def __init__(self, args):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.flops = 0
        self.tensor_bytes = 0
        self.collectives = {k: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0}
                            for k in COLLECTIVE_OPS}
        self.arg_keys = {}
        for t in args:
            self.arg_keys.setdefault(_key(t), t)
        self.read = set()            # argument storages the step read
        self.overwritten = set()     # ... overwritten whole before any read
        self.dtensor_ops = 0         # DTensor operations let through
        self.propagation_ops = 0     # operations of DTensor's propagator, skipped
        self.live = {}               # storage key -> (weak handle, allocation id)
        self.events = []             # (allocation id, +bytes at alloc / -bytes at free)

    # -- argument reads --------------------------------------------------------
    def _touch(self, t: torch.Tensor, write: bool, overwrite: bool) -> None:
        k = _key(t)
        arg = self.arg_keys.get(k)
        if arg is None or k in self.read or k in self.overwritten:
            return
        if write and overwrite and t.numel() == arg.numel():
            self.overwritten.add(k)
        else:
            # a read, or a write of part of it (the rest is kept: read)
            self.read.add(k)

    # -- storage lifetimes -----------------------------------------------------
    def _collect(self) -> None:
        dead = [k for k, (ref, _) in self.live.items()
                if torch.UntypedStorage._expired(ref)]
        for k in dead:
            ref, i = self.live.pop(k)
            torch.UntypedStorage._free_weak_ref(ref)
            self.events.append((i, -self.events[i][1]))

    def _allocated(self, t: torch.Tensor) -> None:
        k = _key(t)
        if k in self.live or k in self.arg_keys:
            return
        s = t.untyped_storage()
        # a storage's address may be taken again once it is freed: an
        # allocation is known by its place in the event list
        self.live[k] = (s._weak_ref(), len(self.events))
        self.events.append((len(self.events), s.nbytes()))

    def release(self) -> None:
        for ref, _ in self.live.values():
            torch.UntypedStorage._free_weak_ref(ref)
        self.live.clear()

    def temp_bytes(self, outputs) -> int:
        """The highest sum of live allocated bytes over the step, the
        storages of ``outputs`` (live at its end) left out."""
        exclude = {self.live[_key(t)][1] for t in outputs if _key(t) in self.live}
        cur = peak = 0
        for i, delta in self.events:
            if i not in exclude:
                cur += delta
                peak = max(peak, cur)
        return peak

    # -- the dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            self.dtensor_ops += 1
            return NotImplemented
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if func is torch.ops.aten.equal.default and any(
                t.is_meta for t in _tensors(args)):
            # meta tensors hold no values: DTensor's check that two mesh
            # dims share one lookup mask (a vocab split over both) holds
            return True
        if _in_sharding_propagation():
            # DTensor runs an operation once on global-shape meta tensors to
            # learn its output's shape: no rank runs that
            self.propagation_ops += 1
            return func(*args, **kwargs)
        short = func._overloadpacket.__name__
        schema = func._schema
        # arguments read or written, by the schema's alias annotations
        if short not in _NO_READ:
            for i, a in enumerate(schema.arguments):
                v = args[i] if i < len(args) else kwargs.get(a.name)
                write = a.alias_info is not None and a.alias_info.is_write
                for t in _tensors(v):
                    self._touch(t, write, short in _OVERWRITES)
        out = func(*args, **kwargs)
        if short in _KIND_OF:
            self._collective(_KIND_OF[short], short, schema, args, kwargs, out)
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        views = bool(schema.returns) and all(
            r.alias_info is not None and not r.alias_info.is_write for r in schema.returns)
        if outs and not views and short not in _NO_WRITE:
            self.tensor_bytes += sum(_nbytes(t) for t in outs)
        if outs:
            self._collect()
            for t in outs:
                self._allocated(t)
        return out

    def _collective(self, kind, short, schema, args, kwargs, out) -> None:
        g = _group_size(list(args) + list(kwargs.values()))
        arg_name = _RESULT_ARG.get(short)
        if arg_name is None:
            result = _tensors(out)
        else:
            names = [a.name for a in schema.arguments]
            i = names.index(arg_name)
            result = _tensors(args[i] if i < len(args) else kwargs[arg_name])
        b = sum(_nbytes(t) for t in result)
        rec = self.collectives[kind]
        rec["count"] += 1
        rec["result_bytes"] += b
        rec["wire_bytes"] += wire_bytes(kind, b, g)


def _reference_leaf_count(cfg, tree) -> int:
    """The leaves of ``tree`` in the reference's stacked layout: a
    ``"layers"`` list counts one leaf a leaf of a period of the pattern
    (stacked over the periods) and the remainder's blocks leaf by leaf."""
    if isinstance(tree, dict):
        n = 0
        for k, v in tree.items():
            if k == "layers" and isinstance(v, list) and cfg is not None:
                n_full, rem = stack_layout(cfg)
                plen = len(cfg.pattern)
                n += len(leaves(v[:plen])) if n_full else 0
                n += len(leaves(v[n_full * plen:]))
            else:
                n += _reference_leaf_count(cfg, v)
        return n
    if isinstance(tree, (list, tuple)):
        return sum(_reference_leaf_count(cfg, v) for v in tree)
    return 0 if tree is None else 1


def count_step(fn, args, cfg=None) -> dict:
    """Run ``fn(*args)`` once under :class:`StepCounter`; returns the
    record's ``memory``, ``cost``, ``collectives`` and ``traffic`` (per
    rank) and the pass's ``seconds``.  ``cfg`` lays out the outputs as the
    reference's stacked tree for the tuple's pointers (None: as they are)."""
    arg_locals = [_local(t) for t in leaves(args) if isinstance(t, torch.Tensor)]
    counter = StepCounter(arg_locals)
    _clear_propagation_caches()
    t0 = time.perf_counter()
    try:
        with counter:
            out = fn(*args)
        seconds = time.perf_counter() - t0
        out_locals = [_local(t) for t in leaves(out) if isinstance(t, torch.Tensor)]
        counter._collect()
        temp = counter.temp_bytes(out_locals)
    finally:
        counter.release()
    if counter.dtensor_ops and not counter.propagation_ops:
        # torch moved its propagator: its global-shape runs would be
        # counted as the rank's own
        raise RuntimeError(f"{counter.dtensor_ops} DTensor operations ran, and none of "
                           "DTensor's sharding-propagation runs was recognised: "
                           "_in_sharding_propagation no longer finds the propagator")
    read = counter.read
    argument = sum(_nbytes(t) for k, t in counter.arg_keys.items() if k in read)
    alias = sum(_nbytes(t) for t in out_locals if _key(t) in read)
    output = (sum(_nbytes(t) for t in out_locals)
              + _TUPLE_POINTER_BYTES * _reference_leaf_count(cfg, out))
    del out
    return {
        "seconds": seconds,
        "memory": {
            "argument_bytes": argument,
            "output_bytes": output,
            "temp_bytes": temp,
            "alias_bytes": alias,
            # arguments include the donated buffers; outputs alias into
            # them, so only the non-aliased remainder adds to the peak
            "peak_args_plus_temp": argument + temp + max(0, output - alias),
        },
        "cost": {"flops": float(counter.flops),
                 "bytes_accessed": float(counter.tensor_bytes + argument)},
        "collectives": counter.collectives,
        "traffic": {"tensor_bytes": counter.tensor_bytes, "param_bytes": argument,
                    "traffic_bytes": counter.tensor_bytes + argument},
    }


# --------------------------------------------------------------------------
# the cells
# --------------------------------------------------------------------------

def production_config(arch: str, *, unroll: bool = False):
    """Production dtypes (bf16 parameters and compute) and the vocab padded
    to a multiple of 256, so that it shards over ``'model'``.  ``unroll``
    is the reference's (it picks the chunked attention's key chunk in the
    port); the dry run uses the scanned, production setting."""
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, param_dtype="bfloat16", compute_dtype="bfloat16",
        scan_layers=not unroll, pad_vocab_to=256,
    )


def _shape(shape):
    return SHAPES[shape] if isinstance(shape, str) else shape


def _on_mesh(step, mesh, serving: bool):
    """``step`` with plain tensors meeting DTensors taken as replicated on
    ``mesh``; a serving step's logits leave in the "logits" activation
    layout (batch over the data axes, vocab over 'model'), where the
    reference's compiler places its unconstrained output."""

    def run(*args):
        with SH.replicating(mesh):
            out = step(*args)
            if serving:
                logits, cache = out
                out = constrain(logits, "logits"), cache
        return out

    return run


def build_cell(arch: str, shape, mesh, *, microbatch: int = 0, unroll: bool = False,
               serve_tp: bool = False, kv_int8: bool = False, grad_bf16: bool = False,
               zero3: bool = False):
    """Returns ``(fn, args)``: the cell's step and its arguments, built on
    ``meta`` and distributed onto the reference's shardings over ``mesh``.

    ``shape`` is a name of :data:`SHAPES` or a ``ShapeConfig``.  The step
    updates the train state and the caches in place, where the reference
    donates them.  ``serve_tp`` takes the tensor-parallel serving rules for
    prefill/decode cells, ``zero3`` pure ZeRO-3; a mesh with a ``pod`` axis
    in an instrument mode other than off gets the pod-explicit step, its
    parameters in the ``include_pod=False, gather_safe=True`` specs."""
    cfg = production_config(arch, unroll=unroll)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    shape = _shape(shape)
    opt_cfg = OptConfig()
    params = init_params(cfg, torch.Generator(), "meta")
    if serve_tp and shape.kind != "train":
        psh = SH.serve_param_shardings(mesh, params)
    elif zero3:
        psh = SH.param_shardings(mesh, params, mode="zero3")
    else:
        psh = SH.param_shardings(mesh, params)
    names = tuple(mesh.mesh_dim_names)

    if shape.kind == "train":
        opt = init_opt_state(params, opt_cfg)
        batch = input_specs(cfg, shape)
        bsh = SH.batch_shardings(mesh, batch, mode="zero3" if zero3 else "2d")
        if "pod" in names and instrument.get_mode() != "off":
            # paper-faithful multi-pod step: explicit cross-pod reduce
            psh = SH.param_shardings(mesh, params, include_pod=False, gather_safe=True)
            step = make_pod_train_step(cfg, opt_cfg, mesh, TrainConfig(pod_reduce="manual"))
        else:
            step = make_train_step(cfg, opt_cfg, TrainConfig(
                microbatch=microbatch,
                grad_reduce_dtype="bfloat16" if grad_bf16 else "",
            ))
        state = SH.distribute({"params": params, "opt": opt},
                              {"params": psh, "opt": SH.opt_state_shardings(mesh, psh, opt)})
        return _on_mesh(step, mesh, False), (state, SH.distribute(batch, bsh))

    prefill_step, decode_step = make_serve_steps(cfg)
    params = SH.distribute(params, psh)
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, "meta")
    cache = SH.distribute(cache, SH.cache_shardings(mesh, cache, serve_tp=serve_tp))
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        batch = SH.distribute(batch, SH.batch_shardings(mesh, batch))
        return _on_mesh(prefill_step, mesh, True), (params, batch, cache)
    token, pos = decode_inputs_specs(cfg, shape)
    token = SH.distribute(token, SH.batch_shardings(mesh, token))
    # the port reads the position on the host: a host scalar, the last slot
    pos = torch.tensor(shape.seq_len - 1, dtype=pos.dtype)
    return _on_mesh(decode_step, mesh, True), (params, token, pos, cache)


# --------------------------------------------------------------------------
# the fake world
# --------------------------------------------------------------------------

_MESHES = {}


def fake_world(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks (this
    process is rank 0), replacing a fake one of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a fake process group; this process "
                               "already has a real one")
        _MESHES.clear()
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def production_mesh(mesh_kind: str):
    """The production mesh of ``mesh_kind`` over a fake world of its size."""
    multi = mesh_kind == "multipod"
    fake_world(512 if multi else 256)
    if mesh_kind not in _MESHES:
        _MESHES[mesh_kind] = make_production_mesh(multi_pod=multi)
    return _MESHES[mesh_kind]


def run_cell(arch: str, shape, mesh_kind: str, *, force=False,
             instrument_mode: str = "off", tag: str = "", microbatch: int = 0,
             serve_tp: bool = False, kv_int8: bool = False,
             skip_unroll: bool = False, grad_bf16: bool = False,
             zero3: bool = False, out_dir: str = ART_DIR) -> dict:
    shape = _shape(shape)
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"-{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}__{shape.name}__{mesh_kind}{suffix}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    record = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind, "tag": tag,
        "instrument": instrument_mode, "status": "started",
    }
    if not cell_is_runnable(arch, shape.name):
        record["status"] = "skipped"
        record["reason"] = "long_500k requires sub-quadratic attention (see DESIGN.md)"
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
        return record

    instrument.set_mode(instrument_mode)
    try:
        mesh = production_mesh(mesh_kind)
        install_constraint(SH.activation_constraint_fn(
            mesh, mode="zero3" if zero3 else "2d"))
        cfg = production_config(arch)
        t0 = time.time()
        fn, args = build_cell(arch, shape, mesh, microbatch=microbatch,
                              serve_tp=serve_tp, kv_int8=kv_int8, grad_bf16=grad_bf16,
                              zero3=zero3)
        counts = count_step(fn, args, cfg)
        del fn, args
        seconds = round(time.time() - t0, 2)
        log.debug("memory", cell=f"{arch}/{shape.name}/{mesh_kind}", **counts["memory"])
        record.update(status="ok", compile_scan_s=seconds, n_devices=mesh.size(),
                      memory=counts["memory"])
        if skip_unroll:
            record["cost_phase"] = "skipped"
        else:
            record.update(compile_unroll_s=seconds, cost=counts["cost"],
                          collectives=counts["collectives"], traffic=counts["traffic"])
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-4000:])
    finally:
        instrument.set_mode("off")
        install_constraint(None)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def cells(arch=None, shape=None, mesh="pod", all_cells=False):
    """The (arch, shape, mesh) cells the flags select, in the reference's
    order."""
    archs = list(ARCHS[:10]) if (all_cells or not arch) else [arch]
    shapes = list(SHAPES) if (all_cells or not shape) else [shape]
    meshes = ["pod", "multipod"] if mesh == "both" else [mesh]
    return [(a, s, m) for a in archs for s in shapes for m in meshes]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--instrument", choices=["off", "barrier"], default="off")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--serve-tp", action="store_true",
                    help="TP serving shardings for prefill/decode (hillclimb)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV cache (hillclimb)")
    ap.add_argument("--skip-unroll", action="store_true",
                    help="record memory only (the reference's phase 1)")
    ap.add_argument("--grad-bf16", action="store_true",
                    help="bf16 gradient reduction (hillclimb)")
    ap.add_argument("--zero3", action="store_true",
                    help="pure ZeRO-3 sharding, no TP (hillclimb)")
    ap.add_argument("--out-dir", default=ART_DIR,
                    help="where the records go (default artifacts/dryrun_torch)")
    obslog.add_flags(ap)
    args = ap.parse_args(argv)
    obslog.configure_from_args(args)

    todo = cells(args.arch, args.shape, args.mesh, args.all)
    if args.list:
        for c in todo:
            print(*c)
        return
    ok = err = skip = 0
    for a, s, m in todo:
        rec = run_cell(a, s, m, force=args.force, instrument_mode=args.instrument,
                       tag=args.tag, microbatch=args.microbatch,
                       serve_tp=args.serve_tp, kv_int8=args.kv_int8,
                       skip_unroll=args.skip_unroll, grad_bf16=args.grad_bf16,
                       zero3=args.zero3, out_dir=args.out_dir)
        status = rec["status"]
        ok += status == "ok"
        err += status == "error"
        skip += status == "skipped"
        fields = {"cell": f"{a} {s} {m}", "status": status}
        if status == "ok":
            fields["peak_gib"] = rec["memory"]["peak_args_plus_temp"] / 2**30
            fields["compile_s"] = (f"{rec.get('compile_scan_s')}+"
                                   f"{rec.get('compile_unroll_s')}")
            log.info("cell", **fields)
        elif status == "error":
            fields["error"] = rec["error"][:120]
            log.error("cell", **fields)
        else:
            log.info("cell", **fields)
    log.info("done", ok=ok, skipped=skip, errors=err)
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
    sys.exit(1 if err else 0)


if __name__ == "__main__":
    main()
