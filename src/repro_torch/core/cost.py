"""The work of a ``meta`` run: FLOPs, bytes, kernel launches, collective
bytes and live memory, counted while :func:`counting` is open.

The dry-run (:mod:`repro_torch.launch.dryrun`) runs one rank's step on the
``meta`` device, where nothing is computed and nothing is allocated; this
module counts what the step would do on the card:

* **aten ops**, from a ``TorchDispatchMode`` (below autograd, so the
  backward's ops are seen as they run).  A product (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``mv``, ``dot``, and the einsums and matmuls that
  decompose into them) costs 2 M N K FLOPs; every other op one FLOP an
  output element, counted apart (:attr:`Cost.other_flops`).  An op reads
  each distinct view of its inputs once (a broadcast dim once, and no more
  than the storage holds) and writes its outputs once.  Views and
  metadata-only ops (``view``, ``expand``, ``as_strided``, ``empty``,
  ``detach``, ...) move nothing: this is what eager PyTorch moves.  An
  ``empty``-style buffer moves nothing but is live from its creation: on
  ``meta`` it is each kernel's output and each collective's result.
* **the three kernels**, which on ``meta`` return a shape-only output and
  call :func:`record_kernel` with their ``cost(...)`` (one formula a
  kernel, the one ``chip_smoke.py``'s bound column uses).
* **collectives**, which on an
  :class:`~repro_torch.core.collectives.AxisSpan` call
  :func:`record_collective` with their kind (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``collective-permute``) and output
  bytes, as the reference reads them from the HLO.
* **memory**: the storages of the step's arguments (:meth:`Cost.arguments`)
  and every ``meta`` storage an op creates, each keyed by
  ``StorageWeakRef(...).cdata`` and freed when the weak reference expires;
  the peak of the live bytes above the arguments is the step's temp.

Counts are Python ints.  Outside :func:`counting` the two ``record_*``
calls do nothing.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Iterator

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten

#: ops that allocate an uninitialised buffer: they move no data, but the
#: buffer is live memory
_EMPTY = {_aten.empty.memory_format, _aten.empty_strided.default,
          _aten.empty_like.default, _aten.new_empty.default,
          _aten.new_empty_strided.default}
#: a view that aten does not flag as one (``is_view``)
_ALIAS = {_aten._unsafe_view.default}

#: the collective kinds, as the reference's HLO names them
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute")


def _mm(a, b) -> int:
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b) -> int:
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


#: FLOPs of each product op from its operands (2 M N K)
_PRODUCTS = {
    _aten.mm.default: lambda a, b, *_: _mm(a, b),
    _aten.addmm.default: lambda c, a, b, *_: _mm(a, b),
    _aten.bmm.default: lambda a, b, *_: _bmm(a, b),
    _aten.baddbmm.default: lambda c, a, b, *_: _bmm(a, b),
    _aten.mv.default: lambda a, v, *_: 2 * a.shape[0] * a.shape[1],
    _aten.dot.default: lambda a, b, *_: 2 * a.shape[0],
}


@dataclasses.dataclass
class Cost:
    """What one counted run did (see the module docstring)."""
    product_flops: int = 0
    other_flops: int = 0
    op_bytes: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    collectives: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_live: int = 0
    # storage cdata -> (weak reference, bytes); the arguments' apart
    _live: dict = dataclasses.field(default_factory=dict, repr=False)
    _args: dict = dataclasses.field(default_factory=dict, repr=False)
    _total: int = 0

    # ---- totals -------------------------------------------------------- #
    @property
    def kernel_flops(self) -> int:
        return sum(k["flops"] for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> int:
        return sum(k["bytes"] for k in self.kernels.values())

    @property
    def products(self) -> int:
        """The products' and the kernels' FLOPs: the arithmetic a compiler
        counts in its dots (and in the kernels' bodies), without the
        elementwise ops."""
        return self.product_flops + self.kernel_flops

    @property
    def flops(self) -> int:
        return self.products + self.other_flops

    @property
    def bytes(self) -> int:
        return self.op_bytes + self.kernel_bytes

    @property
    def launches(self) -> dict:
        return {name: k["launches"] for name, k in self.kernels.items()}

    def collective_bytes(self) -> dict:
        """Bytes by kind, with ``total``: the reference's
        ``collective_bytes`` dict."""
        out = {k: v for k, v in self.collectives.items()}
        out["total"] = sum(out.values())
        return out

    @property
    def temp_bytes(self) -> int:
        return max(self.peak_live - self.argument_bytes, 0)

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.temp_bytes

    def memory(self) -> dict:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "peak_bytes": self.peak_bytes}

    # ---- memory -------------------------------------------------------- #
    def arguments(self, *trees) -> None:
        """Register the step's arguments (nested dicts, lists and tuples
        of tensors): their distinct storages are live from the start."""
        for t in _tensors(trees):
            ref = StorageWeakRef(t.untyped_storage())
            if ref.cdata not in self._args:
                n = t.untyped_storage().nbytes()
                self._args[ref.cdata] = (ref, n)
                self.argument_bytes += n
        self.peak_live = max(self.peak_live, self.argument_bytes)

    def outputs(self, *trees) -> None:
        """Register the step's outputs: the bytes of their distinct
        storages."""
        seen = set()
        for t in _tensors(trees):
            ref = StorageWeakRef(t.untyped_storage())
            if ref.cdata not in seen:
                seen.add(ref.cdata)
                self.output_bytes += t.untyped_storage().nbytes()

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        key = ref.cdata
        if key in self._args or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (ref, n)
        self._total += n
        # the running total never falls short of the live bytes, so only
        # a total past the peak can be a new peak: sweep the dead then
        if self.argument_bytes + self._total > self.peak_live:
            for k in [k for k, (r, _) in self._live.items() if r.expired()]:
                self._total -= self._live.pop(k)[1]
            self.peak_live = max(self.peak_live,
                                 self.argument_bytes + self._total)


def _tensors(trees) -> Iterator[torch.Tensor]:
    return (t for t in tree_leaves(list(trees)) if isinstance(t, torch.Tensor))


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements a view reaches: a broadcast dim (stride
    0) reads its source once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride or size == 0:
            n *= size
    return n * t.element_size()


def _input_bytes(args) -> int:
    """Each distinct view of an input storage once, a broadcast dim once,
    and no more than the storage holds."""
    views: dict = {}
    for t in args:
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        key = StorageWeakRef(st).cdata
        seen = views.setdefault(key, [st.nbytes(), {}])
        seen[1][(t.storage_offset(), tuple(t.shape), t.stride())] = \
            _distinct_bytes(t)
    return sum(min(cap, sum(v.values())) for cap, v in views.values())


class _Counter(TorchDispatchMode):
    """Counts every aten op into ``cost`` (see the module docstring)."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _ALIAS or func.is_view:
            return out
        cost = self.cost
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func in _EMPTY:
            for t in outs:
                if t.device.type == "meta":
                    cost._allocated(t)
            return out
        flat_in = tree_leaves((args, kwargs))
        product = _PRODUCTS.get(func)
        if product is not None:
            cost.product_flops += product(*args)
        else:
            cost.other_flops += sum(t.numel() for t in outs)
        written = {}
        for t in outs:
            written[StorageWeakRef(t.untyped_storage()).cdata] = \
                t.numel() * t.element_size()
            if t.device.type == "meta":
                cost._allocated(t)
        cost.op_bytes += _input_bytes(flat_in) + sum(written.values())
        return out


_ACTIVE: list = []


@contextlib.contextmanager
def counting() -> Iterator[Cost]:
    """Count the work of everything run inside into the yielded
    :class:`Cost`.  Not reentrant: a run counts into one record."""
    if _ACTIVE:
        raise RuntimeError("a counted run is already open")
    cost = Cost()
    _ACTIVE.append(cost)
    try:
        with _Counter(cost):
            yield cost
    finally:
        _ACTIVE.pop()


def record_kernel(name: str, flops: int, nbytes: int) -> None:
    """One launch of kernel ``name`` doing ``flops`` and moving
    ``nbytes`` (the kernel's ``cost(...)``)."""
    if not _ACTIVE:
        return
    k = _ACTIVE[-1].kernels.setdefault(name, {"launches": 0, "flops": 0,
                                              "bytes": 0})
    k["launches"] += 1
    k["flops"] += int(flops)
    k["bytes"] += int(nbytes)


def record_collective(kind: str, nbytes: int) -> None:
    """One collective of ``kind`` (:data:`KINDS`) whose output is
    ``nbytes``."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    if not _ACTIVE:
        return
    _ACTIVE[-1].collectives[kind] += int(nbytes)
