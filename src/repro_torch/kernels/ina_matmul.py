"""INA matmul: ``[M, K] @ [K, N]`` with every partial sum kept on chip.

Counterpart of ``repro.kernels.ina_matmul`` (the Pallas kernel whose
accumulator stays in VMEM across the K grid axis).  The CUDA kernels are in
``csrc/ina_matmul.cu``; its header says what bounds each regime and how the
design answers it.

:func:`plan_matmul` is a pure function of the shape and layout: it picks
the bf16 regime (``wide`` for M > 16, ``narrow`` for M <= 16 with A and B
swapped, ``generic`` where TMA cannot describe the operands), the output
tile and the cluster size ``c``.  When the output tiles are fewer than the
SMs, the c CTAs of a thread block cluster share one tile, each summing one
contiguous slice of whole K tiles in registers; the slices are then summed
in rank order over distributed shared memory, SM to SM, and each output
element is stored once.  That is the reduce-scatter of the INA ring inside
one cluster: no partial sum goes to device memory, there are no atomics
and no second pass, and every run gives the same bits.

:func:`ina_matmul_plain` is the same blocked function in plain PyTorch:
per K slice an f32 sum over K tiles in order, then the slices in rank
order, cast once.  :func:`ina_matmul` launches a kernel for a CUDA tensor
and runs the plain version only for a CPU tensor; a ``meta`` tensor gets a
shape-only output and :func:`cost` recorded
(:func:`repro_torch.core.cost.record_kernel`).  ``w`` may be a strided
view whose rows or columns are contiguous, so the tied head reads
``embed.T`` in place.

:class:`InaMatmul` gives the product its gradient, on both devices through
:func:`ina_matmul` itself: ``dX = dY @ w^T`` and ``dW = x^T @ dY``.  The
Pallas kernel has no backward of its own (JAX differentiates the plain
product around it); both backward products are the K-reducing product
the kernel computes in its body, and ``dW``'s K is the batch's tokens, the
longest reduction of a training step.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.cost import record_kernel
from repro_torch.kernels import _build

BK = 64            # K tile of the TMA regimes (64 bf16: one 128-byte row)
GENERIC_BK = 128   # K tile of the generic bf16 kernel
SMS = 132          # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8    # the portable thread block cluster size

_REGIME_CODE = {"generic": 0, "wide": 1, "narrow": 2, "f32": 3}
# x, w, y, M, N, K, ldx, w_sk, w_sn, the packed plan, the stream
_SIGNATURES = {"ina_matmul": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
               + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]}

launches = 0   # kernel launches since the last reset (read by chip_smoke.py)
# the same launches by kernel path; "generic" must stay 0 on the main paths
launches_by_regime = {"wide": 0, "narrow": 0, "generic": 0, "f32": 0}
# Products run under an ExecutionPlan since the last reset (read by
# chip_smoke.py): "hit", the plan holds the launch that ran; "miss", it
# holds no tile for the shape, or the operands' layout keeps them off the
# planned regime.
plan_tiles = {"hit": 0, "miss": 0}

_DTYPE_NAME = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


class MatmulPlan(NamedTuple):
    """One launch: the regime, the output tile (``tile_m`` x ``tile_n``),
    the cluster size (CTAs sharing one output tile) and the K tile."""
    regime: str
    tile_m: int
    tile_n: int
    cluster: int
    bk: int

    def code(self, w_kmajor: bool) -> int:
        """The plan as the C entry's one int argument (a decode step makes
        hundreds of calls, and each ctypes argument costs host time): bits
        0-1 regime, 2-9 tile_m, 10-19 tile_n, 20-23 cluster, 24 w k-major."""
        return (_REGIME_CODE[self.regime] | self.tile_m << 2
                | self.tile_n << 10 | self.cluster << 20 | int(w_kmajor) << 24)


# the float32 kernel sums one fused multiply-add per k, in ascending order
F32_PLAN = MatmulPlan("f32", 64, 64, 1, 1)

# The TMA instantiations ``launch_planned`` in csrc/ina_matmul.cu has, by
# (regime, tile_m, tile_n): (consumer warpgroups NWG, wgmma's N (WN), ring
# stages).  The plan verifier (``repro_torch.analysis.verify_plan``) reckons
# a launch's shared memory from them as the kernel's ``Ring<NWG, WN,
# STAGES>::SMEM`` does.
TMA_TILES = {("narrow", 8, 64): (1, 8, 8), ("narrow", 16, 64): (1, 16, 8),
             ("wide", 128, 256): (2, 256, 4), ("wide", 128, 128): (2, 128, 6),
             ("wide", 64, 128): (1, 128, 8)}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan_matmul(m: int, n: int, k: int, aligned: bool) -> MatmulPlan:
    """The bf16 launch for ``[m, k] @ [k, n]``.

    ``aligned``: both bases are 16-byte aligned and every row stride that
    is stepped is a multiple of 8 elements, so TMA can describe x and w.
    Both layouts of w take the same plan; a k-major w (the tied head's
    ``embed.T``) changes only the kernel's operand layout, which the
    wrapper passes beside the plan (:meth:`MatmulPlan.code`).

    - generic (not aligned): 64 x 64 tiles, K tiles of 128, no split.
    - narrow (m <= 16): 64 output columns a CTA, x padded to 8 or 16 rows.
    - wide (m > 16): 64 x 128 tiles up to m = 64; above, 128 x 256 where
      that still gives a tile to every SM, else 128 x 128.

    Cluster: the largest power of two c <= 8 that keeps one CTA per SM
    (tiles x c <= SMS) and leaves every CTA two or more K tiles.  Splitting
    further, to two CTAs on an SM or a second wave, measured slower on the
    H100 (``python -m repro_torch.launch.kernel_times``).
    """
    if not aligned:
        return MatmulPlan("generic", 64, 64, 1, GENERIC_BK)
    if m <= 16:
        regime, tile_m, tile_n = "narrow", (8 if m <= 8 else 16), 64
    elif m <= 64:
        regime, tile_m, tile_n = "wide", 64, 128
    else:
        regime, tile_m = "wide", 128
        tile_n = 256 if _cdiv(m, 128) * _cdiv(n, 256) >= SMS else 128
    tiles = _cdiv(m, tile_m) * _cdiv(n, tile_n)
    k_tiles = _cdiv(k, BK)
    c = 1
    while c < MAX_CLUSTER and tiles * 2 * c <= SMS and k_tiles >= 4 * c:
        c *= 2
    return MatmulPlan(regime, tile_m, tile_n, c, BK)


def k_slices(plan: MatmulPlan, k: int) -> list[tuple[int, int]]:
    """``[k0, k1)`` of each cluster rank: whole K tiles, rank r taking
    tiles ``[r T / c, (r + 1) T / c)`` of the T tiles, as the kernel does."""
    tiles, c = _cdiv(k, plan.bk), plan.cluster
    return [(r * tiles // c * plan.bk, min(k, (r + 1) * tiles // c * plan.bk))
            for r in range(c)]


def _operands(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """Checks what the kernels take; returns (m, k, n, x's row stride,
    w's two strides), read once."""
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"ina_matmul takes float32 or bfloat16 of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    (m, k), n = x.shape, w.shape[1]
    if min(m, k, n) == 0:
        raise ValueError(f"empty product {tuple(x.shape)} @ {tuple(w.shape)}")
    xs0, xs1 = x.stride()
    ws0, ws1 = w.stride()
    if xs1 != 1:
        raise ValueError("x needs contiguous rows")
    if ws0 != 1 and ws1 != 1:
        raise ValueError(f"w needs contiguous rows or columns, strides "
                         f"{w.stride()}")
    return m, k, n, xs0, ws0, ws1


def _plan(x, w, m, k, n, xs0, ws0, ws1) -> MatmulPlan:
    if x.dtype == torch.float32:
        return F32_PLAN
    kmajor = ws1 != 1
    w_rows, w_step = (n, ws1) if kmajor else (k, ws0)
    # what TMA needs: 16-byte aligned bases, and row strides of a multiple
    # of 8 elements wherever there is more than one row to step over
    aligned = (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
               and (m == 1 or xs0 % 8 == 0) and (w_rows == 1 or w_step % 8 == 0))
    return plan_matmul(m, n, k, aligned)


def plan_for(x: torch.Tensor, w: torch.Tensor) -> MatmulPlan:
    """The plan :func:`ina_matmul` uses for these operands."""
    return _plan(x, w, *_operands(x, w))


def ina_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                     plan: MatmulPlan | None = None) -> torch.Tensor:
    """Blocked like the kernel: for each cluster rank an f32 sum over its
    K slice's tiles in order, then the slices summed in rank order, cast to
    ``x.dtype`` once.  float32 repeats the f32 kernel's arithmetic exactly:
    one fused multiply-add per k, k ascending (at K = 14336 two f32 sum
    orders part by up to ~3e-5, more than the checks' 1e-5)."""
    plan = plan or plan_for(x, w)
    if plan.regime == "f32":
        acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                          device=x.device)
        for t in range(x.shape[1]):
            acc.addcmul_(x[:, t, None], w[t])
        return acc
    total = None
    for k0, k1 in k_slices(plan, x.shape[1]):
        acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32,
                          device=x.device)
        for t in range(k0, k1, plan.bk):
            acc += x[:, t:min(t + plan.bk, k1)].float() \
                @ w[t:min(t + plan.bk, k1)].float()
        total = acc if total is None else total + acc
    return total.to(x.dtype)


def cost(m: int, n: int, k: int, elt: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one ``[m, k] @ [k, n]``: 2 m n k, and x and w
    read once and y written once, ``elt`` bytes an element: the work the
    bound and the dry-run count."""
    return 2 * m * n * k, (m * k + k * n + m * n) * elt


def ina_matmul(x: torch.Tensor, w: torch.Tensor,
               plan: MatmulPlan | None = None, tiles=None) -> torch.Tensor:
    """``x @ w`` with ``x``: [M, K], ``w``: [K, N], output in ``x.dtype``.

    ``plan`` replaces :func:`plan_for`'s choice: the checks force a
    cluster size on small shapes with it.  ``tiles`` is the
    :class:`~repro_torch.plan.ExecutionPlan` a model runs under: its
    ``tile_for`` is asked once whether it holds this product's launch, and
    :data:`plan_tiles` counts the answer.  Its tile policy is
    :func:`plan_matmul` itself, so a tile it holds is the launch reckoned
    here for TMA-aligned operands, and operands TMA cannot describe keep
    the ``generic`` launch: a planned product costs the host one dict
    probe more than a planless one, and gives the same bits."""
    m, k, n, xs0, ws0, ws1 = _operands(x, w)
    plan = plan or _plan(x, w, m, k, n, xs0, ws0, ws1)
    if tiles is not None:
        held = tiles.tile_for(m, k, n, _DTYPE_NAME[x.dtype])
        plan_tiles["hit" if held == plan else "miss"] += 1
    if (plan.regime == "f32") != (x.dtype == torch.float32):
        raise ValueError(f"plan {plan} does not fit {x.dtype}")
    if x.device.type == "cpu":
        return ina_matmul_plain(x, w, plan)
    if x.device.type == "meta":
        record_kernel("ina_matmul", *cost(m, n, k, x.element_size()))
        return torch.empty(m, n, dtype=x.dtype, device="meta")
    if x.device.type != "cuda":
        raise ValueError(f"ina_matmul runs on cuda, cpu or meta, not "
                         f"{x.device}")
    global launches
    lib = _build.load("ina_matmul", _SIGNATURES)
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    err = lib.ina_matmul(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k,
                         xs0, ws0, ws1, plan.code(ws1 != 1),
                         torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ina_matmul launch failed: cudaError_t {err} "
                           f"({plan})")
    launches += 1
    launches_by_regime[plan.regime] += 1
    return y


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [R, C] with contiguous rows whose stride is a multiple of 8
    elements, so that TMA can step over them: a contiguous copy where C
    is such a multiple (``t`` itself where it is contiguous), else a view
    of the first C columns of a buffer whose rows are padded to one (the
    gradient of whisper's head over its vocabulary of 51865, the media's
    3202 rows transposed for the vlm's ``dW``)."""
    c = t.shape[1]
    if c % 8 == 0:
        return t.contiguous()
    buf = t.new_empty(t.shape[0], -(-c // 8) * 8)
    piece = buf.narrow(1, 0, c)
    piece.copy_(t)
    return piece


class InaMatmul(torch.autograd.Function):
    """``x @ w`` (x: [M, K], w: [K, N], and optionally the forward's
    ``plan`` and ``tiles``, as :func:`ina_matmul` takes them) with a
    gradient through the INA
    matmul: ``dX = ina_matmul(dY, w^T)``, with ``w^T`` read in place (a
    row-major w gives a k-major ``w^T`` and the tied head's k-major
    ``embed.T`` a row-major one), and ``dW = ina_matmul(x^T, dY)``, with
    ``x^T`` copied to row-major (a layout of x the kernel reads in place
    is ROADMAP.md work); ``dY`` and ``x^T`` take rows on TMA's grid
    (:func:`_aligned_rows`), so no backward product runs ``generic``.  On
    CUDA tensors every product launches the kernel and is counted; on CPU
    tensors each runs the plain version, so the CPU tests exercise this
    backward and not PyTorch's.  ``kept`` (a 1-tuple) is the output a
    checkpointed layer's first forward recorded: the recompute returns it
    and launches nothing (:func:`repro_torch.core.remat.kernel`)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor,
                plan: MatmulPlan | None = None, tiles=None,
                kept: tuple | None = None) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        if kept is not None:
            return kept[0].detach()
        return ina_matmul(x, w, plan) if tiles is None \
            else ina_matmul(x, w, plan, tiles)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        dy = _aligned_rows(dy)
        dx = ina_matmul(dy, w.T) if ctx.needs_input_grad[0] else None
        dw = ina_matmul(_aligned_rows(x.T), dy) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None
