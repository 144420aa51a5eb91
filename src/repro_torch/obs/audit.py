"""Plan audit: measured peak bytes of one step, next to the estimate
(counterpart of ``repro.obs.audit``).

The Planner prices every plan (Eqs. 7-16: activations + boundary caches +
optimiser state); this module *measures* a step so that a pricing
regression cannot ship silently.  Two measurement sources, recorded side
by side with the plan's per-device estimate:

``cuda_max_allocated``  :func:`measure_step` runs the step once on the
                        card between ``reset_peak_memory_stats`` and
                        ``max_memory_allocated``: the absolute peak of the
                        caching allocator's live tensors, arguments
                        (parameters, optimizer state, the batch) included —
                        the counterpart of the reference's XLA temp +
                        argument + output bytes of the compiled step.
``live_buffers``        the sum of ``.nbytes`` over a live tree of tensors
                        (:func:`live_bytes`).
``meta_trace``          :func:`trace_step` runs the step once, as a rule on
                        ``meta`` tensors (shapes, no memory, no card), under
                        one dispatch mode that follows every tensor storage
                        from its making to its freeing and counts each op's
                        FLOPs by ``torch.utils.flop_counter``'s formulas:
                        the dry run's source, the counterpart of the
                        reference's XLA ``memory_analysis`` of a step
                        compiled for a mesh it does not have.

Eager PyTorch compiles nothing to analyse, so the port runs the call
instead; :func:`trace_step`'s record keeps the reference's
``memory_metrics`` keys.

The record is keyed by the plan axes the estimate formulae branch on —
``(engine, n_rows, residency, cache_kind)`` — so
:mod:`repro_torch.analysis.audit` can aggregate estimate error per formula
and flag drift.
"""

from __future__ import annotations

import time
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.exec.plan import ExecutionPlan
from repro_torch.optim.adamw import tree_leaves

#: the ``method`` a card measurement records
CUDA_METHOD = "cuda_max_allocated"
#: the ``method`` a traced step records
TRACE_METHOD = "meta_trace"


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _device_of(args, device) -> torch.device:
    """``device`` when given, else the first tensor argument's, else the
    card when there is one."""
    if device is not None:
        return torch.device(device)
    tensors = _tensors(args)
    if tensors:
        return tensors[0].device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def measure_step(fn, *args, time_iters: int = 0,
                 device=None) -> Optional[dict]:
    """Run ``fn(*args)`` once and return its memory metrics.

    On a CUDA device the card is synchronised, its peak statistics reset,
    the call run and synchronised again: ``peak_bytes`` is
    ``torch.cuda.max_memory_allocated()`` (``method``
    ``"cuda_max_allocated"``).  The device is ``device``, else the first
    tensor argument's, else the card when there is one — a closure that
    takes no arguments and keeps its own results is how a caller measures
    a step it also uses.  On the CPU nothing reports memory: the call runs
    and the result is None, as in the reference where the backend has no
    memory analysis.

    ``time_iters > 0`` then calls ``fn(*args)`` ``time_iters`` more times
    (the measured call was the warmup) and records the median under
    ``wall_us``: CUDA events on the card, the host clock on the CPU.  With
    timing asked for the dict is returned on the CPU too, with
    ``peak_bytes`` 0."""
    dev = _device_of(args, device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    fn(*args)
    if cuda:
        torch.cuda.synchronize(dev)
        out = {"peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
               "method": CUDA_METHOD}
    elif time_iters:
        out = {"peak_bytes": 0}
    else:
        return None
    if time_iters:
        times = []
        for _ in range(time_iters):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e3)
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append((time.perf_counter() - t0) * 1e6)
        times.sort()
        out["wall_us"] = times[len(times) // 2]
    return out


def _nbytes(values) -> int:
    """Bytes of the tensors among ``values``, one level of lists in them
    included (an op's arguments)."""
    n = 0
    for v in values:
        if isinstance(v, torch.Tensor):
            n += v.nbytes
        elif isinstance(v, (tuple, list)):
            n += sum(t.nbytes for t in v if isinstance(t, torch.Tensor))
    return n


_IMMUTABLE = (bool, int, float, str, torch.dtype, torch.device,
              torch.layout, torch.memory_format)


def _meta_sig(v):
    """A hashable key of an op argument's metadata (a ``meta`` tensor's
    shape, strides, offset and dtype; a value's type and value), or None
    where there is none (a tensor that holds data, an unhashable value)."""
    if isinstance(v, torch.Tensor):
        if v.device.type != "meta":
            return None
        return (v.shape, v.stride(), v.storage_offset(), v.dtype)
    if isinstance(v, (list, tuple)):
        sigs = tuple(_meta_sig(x) for x in v)
        return None if None in sigs else (type(v), sigs)
    if v is None or isinstance(v, _IMMUTABLE):
        return (type(v), v)
    return None


class _StepTracer(TorchDispatchMode):
    """Storages, FLOPs and bytes accessed of every op a call runs, in one
    mode.

    A storage is counted from the op that first returns a tensor on it to
    the freeing of that storage (a finalizer on its Python object, which
    lives as long as the storage), once however many views share it; the
    running sum's maximum is the peak.  FLOPs are counted as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them: the op's
    formula where the registry has one, else the op's decomposition, when
    it has one, run through this mode.  Bytes accessed are an eager op's
    traffic: every op that is not a view and not a collective reads its
    tensor arguments and writes its results once (no fusion, no cache).

    On ``meta`` tensors an op computes only its results' metadata, and
    many ops do so in Python (``torch._refs``): a per-token loop pays that
    for every token alike.  So an op that neither mutates nor aliases its
    arguments is run once per distinct metadata of its arguments
    (``memo``), and later calls make fresh results of the metadata it
    gave.  Only ``meta`` results are memoized, so a call on tensors that
    hold data never is: the tests hold a ``meta`` trace to the same call
    on CPU tensors."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.memo = {}
        self.kinds = {}
        self.live = {}
        self.now = self.peak = 0
        self.flops = self.bytes = 0
        self.by_op = {}

    def track(self, t) -> None:
        """Count ``t``'s storage if it is new."""
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        weakref.finalize(st, self._free, key)
        self.now += n
        self.peak = max(self.peak, self.now)

    def _free(self, key) -> None:
        self.now -= self.live.pop(key, 0)

    def _kind(self, func):
        """``(decomposes, pure, counted)`` of ``func``, once per op: it
        has a CompositeImplicitAutograd kernel (FlopCounterMode runs such
        an op's decomposition); no argument or result aliases; it is not a
        collective (its bytes are the collective term's)."""
        kind = self.kinds.get(func)
        if kind is None:
            from torch._C import DispatchKey
            dk = DispatchKey.CompositeImplicitAutograd
            schema = func._schema
            kind = self.kinds[func] = (
                func is not torch.ops.prim.device.default
                and self.registry.get(func._overloadpacket) is None
                and (dk in func.py_kernels
                     or torch._C._dispatch_has_kernel_for_dispatch_key(
                         func.name(), dk)),
                all(a.alias_info is None for a in schema.arguments)
                and all(r.alias_info is None for r in schema.returns),
                func.namespace != "c10d")
        return kind

    def _run(self, func, pure, args, kwargs):
        if not pure:
            return func(*args, **kwargs)
        key = _meta_sig(args)
        kw = _meta_sig(tuple(sorted(kwargs.items()))) if kwargs else ()
        if key is None or kw is None:
            return func(*args, **kwargs)
        key = (func, key, kw)
        made = self.memo.get(key)
        if made is None:
            out = func(*args, **kwargs)
            self._remember(func, key, out, args, kwargs)
            return out
        seq, metas = made
        outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                    device="meta")
                for shape, stride, dtype in metas]
        return outs[0] if seq is None else seq(outs)

    def _remember(self, func, key, out, args, kwargs) -> None:
        """Memoize the metadata of ``out`` under ``key`` when its results
        are fresh storages, each its own and spanned exactly; an op whose
        result shares an argument's storage though its schema declares no
        alias (``aten._unsafe_view``) is never memoized again."""
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                   for t in outs):
            return
        ins = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
        sts = [id(t.untyped_storage()) for t in outs]
        if ins.intersection(sts) or len(set(sts)) != len(sts):
            decomposes, _, counted = self.kinds[func]
            self.kinds[func] = (decomposes, False, counted)
            return
        if all(t.storage_offset() == 0 and t.untyped_storage().nbytes()
               == t.dtype.itemsize * _span(t) for t in outs):
            self.memo[key] = (
                type(out) if isinstance(out, (tuple, list)) else None,
                tuple((t.shape, t.stride(), t.dtype) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        decomposes, pure, counted = self._kind(func)
        if decomposes:
            out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._run(func, pure, args, kwargs)
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            name = str(func._overloadpacket)
            self.by_op[name] = self.by_op.get(name, 0) + n
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor):
                self.track(t)
        if counted and not func.is_view:
            self.bytes += _nbytes(args) + _nbytes(kwargs.values()) \
                + _nbytes(outs)
        return out


def _span(t) -> int:
    """Elements of the storage a tensor of ``t``'s shape and strides
    spans."""
    if t.numel() == 0:
        return 0
    return 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))


def trace_step(fn, *args) -> dict:
    """Run ``fn(*args)`` once under :class:`_StepTracer` and
    :func:`~repro_torch.exec.collectives.tally`; returns the reference's
    ``memory_metrics`` keys over the call and what the trace adds.

    ``argument_size_in_bytes`` is the storages of ``args`` live at entry
    (the caller holds them throughout), ``output_size_in_bytes`` the
    storages of the result that no argument holds and
    ``alias_size_in_bytes`` those an argument does (an in-place update);
    ``peak_bytes`` is the most bytes live at once, arguments included, and
    ``temp_size_in_bytes`` the rest of it: the temporaries at the peak.
    ``flops`` and ``flops_by_op`` count every op the call ran (a loop's
    body as often as it ran), ``bytes_accessed`` the eager ops' traffic
    (:class:`_StepTracer`), ``collective_bytes`` the result bytes of its
    collectives by kind.  On ``meta`` tensors nothing is computed and no
    memory is taken, so a step of a production mesh traces on a host
    without the card; on real tensors the counts are the same."""
    from repro_torch.exec.collectives import tally
    mode = _StepTracer()
    arg_keys = set()
    for t in _tensors(args):
        mode.track(t)
        arg_keys.add(id(t.untyped_storage()))
    args_bytes = mode.now
    with tally() as coll, mode:
        out = fn(*args)
    out_bytes = alias = 0
    seen = set()
    for t in _tensors(out):
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        if id(st) in arg_keys:
            alias += st.nbytes()
        else:
            out_bytes += st.nbytes()
    return {"peak_bytes": mode.peak,
            "argument_size_in_bytes": args_bytes,
            "temp_size_in_bytes": mode.peak - args_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias,
            "flops": mode.flops,
            "bytes_accessed": mode.bytes,
            "flops_by_op": dict(sorted(mode.by_op.items())),
            "collective_bytes": dict(sorted(coll.items())),
            "method": TRACE_METHOD}


def live_bytes(tree) -> int:
    """Bytes actually resident in a tree (dicts, lists, tuples) of
    tensors."""
    return sum(int(t.nbytes) for t in _tensors(tree))


def plan_audit(plan: ExecutionPlan, measured: dict, source: str,
               extra: Optional[dict] = None,
               est_bytes: Optional[int] = None) -> dict:
    """Build (and emit, when a session is active) one audit record.

    ``measured`` must contain ``peak_bytes``; ``source`` names the
    measurement path (``train_step`` / ``train_step_lm`` / ``dryrun``) so the analysis
    side can apply a per-source tolerance.  ``est_bytes`` overrides the
    default per-device estimate when the measurement targets a different
    term (the LM step adds the paper's ξ)."""
    est = int(est_bytes) if est_bytes is not None \
        else int(plan.est_bytes_per_device or plan.est_bytes or 0)
    peak = int(measured.get("peak_bytes", 0))
    rec = {
        "source": source,
        "engine": plan.engine,
        "n_rows": plan.n_rows,
        "residency": (plan.residency.describe()
                      if plan.residency is not None else "device"),
        "cache_kind": plan.get("cache_kind", ""),
        "est_bytes_per_device": est,
        "measured": measured,
        "ratio": (peak / est) if est else None,
    }
    if extra:
        rec.update(extra)

    obs.emit("plan_audit", source, **rec)
    obs.gauge(f"audit.{source}.est_bytes").set(est)
    obs.gauge(f"audit.{source}.measured_peak_bytes").set(peak)
    if rec["ratio"] is not None:
        obs.gauge(f"audit.{source}.ratio").set(rec["ratio"])
    return rec
