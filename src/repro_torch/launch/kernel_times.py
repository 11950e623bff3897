"""Device times of the port's kernels on one GPU.

    python -m repro_torch.launch.kernel_times [sweep | shapes | wkv6]

:class:`Timer` is the timer ``chip_smoke.py`` uses;
:func:`matmul_projections`, :func:`moe_projections`,
:func:`family_projections` / :func:`matmul_operands` are the products it
checks, :func:`attention_cases` / :func:`attention_operands` its flash
attention cases in the model's layout, and :func:`wkv_cases` /
:func:`wkv_operands` its wkv6 cases.  :func:`rank_projections`,
:func:`attention_cases` and :func:`wkv_cases` also hold the rank-local
shapes of worlds 2 and 4 (:data:`TP_WORLDS`): what one rank of every
tensor-parallel non-dense model launches; :func:`uneven_projections` and
:func:`attention_cases` those of the uneven head cut at a model span of 16
(:data:`UNEVEN_WORLD`).  ``sweep`` (the default) times
``ina_matmul`` at every cluster size the kernel takes, at the decode (M =
1, 2, 4) and prefill-chunk (M = 64) shapes of every served model's products,
beside the size ``plan_matmul`` picks and ``torch.matmul``'s time.
:func:`train_products` lists the train step's products, which
``chip_smoke.py`` checks and times.
``shapes`` times ``ina_matmul`` as the model calls it, and
``torch.matmul``, at the main-path bf16 shapes, the rank-local ones
among them; it calls nothing but
``ina_matmul(x, w)``, so it also times an older tree's kernel with this
timer when the module is copied into that tree.  ``wkv6`` times
``wkv6_heads`` at the wkv6 cases, likewise through that front alone.
Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import math
import statistics
import subprocess

import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import ina_matmul as im
from repro_torch.kernels.wkv6 import wkv6_heads

L2_FLUSH_BYTES = 128 << 20
HOST_HEAD_START_CYCLES = 200_000   # ~0.1 ms of the card's clock
# M of the main paths' bf16 products: qwen2 serving's prefill chunk and its
# 2 decode slots; the rwkv forward's B 2 x S 2048 and rwkv serving's decode;
# the deepseek and llama4 forwards' B 1 x S 2048 and their 2 decode slots;
# the zamba2 and llama-3.2-vision forwards' B 1 x S 2048, whisper's encoder
# over 1500 frames, and the three families' 2 decode rows
MAIN_PATH_M = {"qwen2-1.5b": (64, 2), "rwkv6-7b": (4096, 2),
               "deepseek-v2-lite-16b": (2048, 2),
               "llama4-scout-17b-16e": (2048, 2),
               "zamba2-2.7b": (2048, 2), "llama-3.2-vision-11b": (2048, 2),
               "whisper-medium": (1500, 2)}


# the tensor-parallel worlds whose rank-local launch shapes are checked and
# timed on one card (one H100 runs no world above 1)
TP_WORLDS = (2, 4)
# the model span of the uneven head cut's rank-local shapes: the dry-run's
# 16 x 16 cells, which 12 (qwen2-1.5b) and 40 (qwen3-14b) query heads do
# not divide (``parallel/sharding.head_split``)
UNEVEN_WORLD = 16
# (arch, rank) of the uneven head cut's ranks whose shapes are checked:
# qwen2-1.5b's rank 0 (one query head, one KV head), qwen3-14b's rank 0
# (3:1) and rank 1 (heads 3-5 straddle KV heads 0 and 1: K/V expanded 3:3)
UNEVEN_RANKS = (("qwen2-1.5b", 0), ("qwen3-14b", 0), ("qwen3-14b", 1))


class Timer:
    """Median time of ``fn`` over launches that each find the L2 cold,
    as a decode step finds the weights.  Before each, the card sleeps
    ~0.1 ms, so the host has queued ``fn``'s launch before the start event
    runs: the time is the card's, not the host's cost of launching (a
    step's wall time carries that)."""

    def __init__(self):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(HOST_HEAD_START_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def matmul_projections() -> list[tuple[str, str, int, int, str]]:
    """(model, name, K, N, w layout) of every ``ina_matmul`` product of the
    dense and ssm models served; layout "row" is a [K, N] weight, "tied"
    the tied head's ``embed.T`` view (contiguous along K)."""
    q, r = ARCHS["qwen2-1.5b"], ARCHS["rwkv6-7b"]
    kv = q.n_kv_heads * q.resolved_head_dim
    return [("qwen2-1.5b", "wq/wo", q.d_model, q.d_model, "row"),
            ("qwen2-1.5b", "wk/wv", q.d_model, kv, "row"),
            ("qwen2-1.5b", "w_up/w_gate", q.d_model, q.d_ff, "row"),
            ("qwen2-1.5b", "w_down", q.d_ff, q.d_model, "row"),
            ("qwen2-1.5b", "tied head", q.d_model, q.vocab, "tied"),
            ("rwkv6-7b", "r/k/v/g/o", r.d_model, r.d_model, "row"),
            ("rwkv6-7b", "cmix wk", r.d_model, r.d_ff, "row"),
            ("rwkv6-7b", "cmix wv", r.d_ff, r.d_model, "row"),
            ("rwkv6-7b", "head", r.d_model, r.vocab, "row")]


def moe_projections() -> list[tuple[str, str, int, int, str]]:
    """The same for the MoE families' models (deepseek-v2-lite-16b,
    llama4-scout-17b-16e): attention, the shared experts, the dense
    layer, the head.  Their routed experts and router are torch.bmm and
    torch.matmul, not the INA matmul."""
    ds, ll = ARCHS["deepseek-v2-lite-16b"], ARCHS["llama4-scout-17b-16e"]
    a, h = ds.mla, ds.n_heads
    shared = ds.moe.d_ff_expert * ds.moe.num_shared
    dsn, lln = ds.name, ll.name
    llkv = ll.n_kv_heads * ll.resolved_head_dim
    llsh = ll.moe.d_ff_expert * ll.moe.num_shared
    return [(dsn, "wq", ds.d_model,
             h * (a.qk_nope_head_dim + a.qk_rope_head_dim), "row"),
            (dsn, "w_dkv", ds.d_model, a.kv_lora_rank + a.qk_rope_head_dim,
             "row"),
            (dsn, "w_uk/w_uv", a.kv_lora_rank, h * a.v_head_dim, "row"),
            (dsn, "wo", h * a.v_head_dim, ds.d_model, "row"),
            (dsn, "shared w_up/w_gate", ds.d_model, shared, "row"),
            (dsn, "shared w_down", shared, ds.d_model, "row"),
            (dsn, "dense w_up/w_gate", ds.d_model, ds.d_ff, "row"),
            (dsn, "dense w_down", ds.d_ff, ds.d_model, "row"),
            (dsn, "head", ds.d_model, ds.vocab, "row"),
            (lln, "wq/wo", ll.d_model, ll.d_model, "row"),
            (lln, "wk/wv", ll.d_model, llkv, "row"),
            (lln, "shared w_up/w_gate", ll.d_model, llsh, "row"),
            (lln, "shared w_down", llsh, ll.d_model, "row"),
            (lln, "head", ll.d_model, ll.vocab, "row")]


def matmul_layout(w: torch.Tensor) -> str:
    """The layout of an ``ina_matmul`` weight [K, N]: "tied" read k-major
    (the tied head's ``embed.T``), "padded" row-major with rows longer
    than N (a rank's Mamba2 ``w_in``, padded to a multiple of 8 elements:
    ``parallel/sharding.py``), else "row"."""
    if w.stride(1) != 1:
        return "tied"
    return "padded" if w.stride(0) != w.shape[1] else "row"


def rank_projections(world: int) -> list[tuple[str, str, int, int, str]]:
    """(model, name, K, N, w layout) of each ``ina_matmul`` product one rank
    of ``world`` launches that the sharding cuts (``parallel/sharding.py``)
    for rwkv6-7b, deepseek-v2-lite-16b, llama4-scout-17b-16e, zamba2-2.7b,
    llama-3.2-vision-11b and whisper-medium: column-parallel on N (heads,
    d_ff, the vocabulary), row-parallel on K; zamba2's ``w_in`` takes z,
    x and dt of the rank's heads and B and C whole, stored with rows
    padded to a multiple of 8 (:func:`matmul_layout`).  The products every
    rank holds whole (RWKV6's channel-mix ``wr``, MLA's ``w_dkv``,
    zamba2's ``wo_down``/``mlp_down``, whisper's head over its odd
    vocabulary) keep their one-rank shapes (:func:`matmul_projections`,
    :func:`moe_projections`, :func:`family_projections`)."""
    r, ds, ll = (ARCHS[n] for n in ("rwkv6-7b", "deepseek-v2-lite-16b",
                                    "llama4-scout-17b-16e"))
    z, v, w = (ARCHS[n] for n in ("zamba2-2.7b", "llama-3.2-vision-11b",
                                  "whisper-medium"))
    a, p = ds.mla, world
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    dsh = ds.moe.d_ff_expert * ds.moe.num_shared // p
    llh = ll.n_heads * ll.resolved_head_dim // p
    llkv = ll.n_kv_heads * ll.resolved_head_dim // p
    llsh = ll.moe.d_ff_expert * ll.moe.num_shared // p
    out = [(r.name, "r/k/v/g", r.d_model, r.d_model // p, "row"),
           (r.name, "o", r.d_model // p, r.d_model, "row"),
           (r.name, "cmix wk", r.d_model, r.d_ff // p, "row"),
           (r.name, "cmix wv", r.d_ff // p, r.d_model, "row"),
           (r.name, "head", r.d_model, r.vocab // p, "row"),
           (ds.name, "wq", ds.d_model, ds.n_heads * qk // p, "row"),
           (ds.name, "w_uk/w_uv", a.kv_lora_rank,
            ds.n_heads * a.v_head_dim // p, "row"),
           (ds.name, "wo", ds.n_heads * a.v_head_dim // p, ds.d_model, "row"),
           (ds.name, "shared w_up/w_gate", ds.d_model, dsh, "row"),
           (ds.name, "shared w_down", dsh, ds.d_model, "row"),
           (ds.name, "dense w_up/w_gate", ds.d_model, ds.d_ff // p, "row"),
           (ds.name, "dense w_down", ds.d_ff // p, ds.d_model, "row"),
           (ds.name, "head", ds.d_model, ds.vocab // p, "row"),
           (ll.name, "wq", ll.d_model, llh, "row"),
           (ll.name, "wo", llh, ll.d_model, "row"),
           (ll.name, "wk/wv", ll.d_model, llkv, "row"),
           (ll.name, "shared w_up/w_gate", ll.d_model, llsh, "row"),
           (ll.name, "shared w_down", llsh, ll.d_model, "row"),
           (ll.name, "head", ll.d_model, ll.vocab // p, "row")]
    di = z.ssm.expand * z.d_model
    n_in = 2 * di // p + 2 * z.ssm.d_state + di // z.ssm.head_dim // p
    d2, zf = 2 * z.d_model, z.shared_attn_d_ff // p
    out += [(z.name, "w_in", z.d_model, n_in, "padded" if n_in % 8 else "row"),
            (z.name, "w_out", di // p, z.d_model, "row"),
            (z.name, "shared wq/wk/wv", d2, d2 // p, "row"),
            (z.name, "shared wo", d2 // p, d2, "row"),
            (z.name, "shared w_up/w_gate", d2, zf, "row"),
            (z.name, "shared w_down", zf, d2, "row"),
            (z.name, "tied head", z.d_model, z.vocab // p, "tied")]
    vq = v.n_heads * v.resolved_head_dim // p
    vkv = v.n_kv_heads * v.resolved_head_dim // p
    out += [(v.name, "wq", v.d_model, vq, "row"),
            (v.name, "wo", vq, v.d_model, "row"),
            (v.name, "wk/wv", v.d_model, vkv, "row"),
            (v.name, "w_up/w_gate", v.d_model, v.d_ff // p, "row"),
            (v.name, "w_down", v.d_ff // p, v.d_model, "row"),
            (v.name, "head", v.d_model, v.vocab // p, "row")]
    out += [(w.name, "wq/wk/wv", w.d_model, w.d_model // p, "row"),
            (w.name, "wo", w.d_model // p, w.d_model, "row"),
            (w.name, "w_up", w.d_model, w.d_ff // p, "row"),
            (w.name, "w_down", w.d_ff // p, w.d_model, "row")]
    return [(model, f"{name} P={p}", k, n, kind)
            for model, name, k, n, kind in out]


def uneven_projections() -> list[tuple[str, str, int, int, str]]:
    """(model, name, K, N, w layout) of each distinct ``ina_matmul``
    product of the :data:`UNEVEN_RANKS` at a model span of
    :data:`UNEVEN_WORLD`, read from the rank's shard
    (``sharding.shard_params`` on ``meta``): the attention of its real
    heads (a straddling rank's ``wk``/``wv`` its two KV heads), the MLP
    at d_ff / 16, the head at V / 16 (tied: ``embed.T``)."""
    from repro_torch.models.api import get_model
    from repro_torch.parallel.sharding import shard_params
    out, seen = [], set()
    for arch, rank in UNEVEN_RANKS:
        cfg = ARCHS[arch]
        shard = shard_params(get_model(cfg).init(device="meta"), cfg, rank,
                             UNEVEN_WORLD)
        layer = {**shard["layers"]["attn"], **shard["layers"]["mlp"]}
        rows = [(name, *layer[name].shape[-2:], "row")
                for name in ("wq", "wk", "wo", "w_up", "w_down")]
        head = shard.get("lm_head")
        rows.append(("head", *head.shape, "row") if head is not None else
                    ("tied head", *shard["embed"].shape[::-1], "tied"))
        for name, k, n, kind in rows:
            if (arch, k, n, kind) not in seen:
                seen.add((arch, k, n, kind))
                out.append((arch, f"{name} P={UNEVEN_WORLD} r{rank}", k, n,
                            kind))
    return out


def family_projections() -> list[tuple[str, str, int, int, str]]:
    """The same for the hybrid, vlm and encdec families' models
    (zamba2-2.7b: Mamba2's ``w_in``/``w_out``, the shared block over 2 x
    d_model and its ``wo_down``/``mlp_down``; llama-3.2-vision-11b: the
    self and cross-attention layers' products, the cross layers' ``wk``/
    ``wv`` over the media; whisper-medium: the encoder's and the decoder's,
    ungated MLPs, the tied head over its odd vocabulary)."""
    z, v, w = (ARCHS[n] for n in ("zamba2-2.7b", "llama-3.2-vision-11b",
                                  "whisper-medium"))
    d_inner = z.ssm.expand * z.d_model
    n_in = 2 * d_inner + 2 * z.ssm.d_state + d_inner // z.ssm.head_dim
    d2 = 2 * z.d_model
    vkv = v.n_kv_heads * v.resolved_head_dim
    return [(z.name, "w_in", z.d_model, n_in, "row"),
            (z.name, "w_out", d_inner, z.d_model, "row"),
            (z.name, "shared wq/wk/wv/wo", d2, d2, "row"),
            (z.name, "shared w_up/w_gate", d2, z.shared_attn_d_ff, "row"),
            (z.name, "shared w_down", z.shared_attn_d_ff, d2, "row"),
            (z.name, "wo_down/mlp_down", d2, z.d_model, "row"),
            (z.name, "tied head", z.d_model, z.vocab, "tied"),
            (v.name, "wq/wo", v.d_model, v.d_model, "row"),
            (v.name, "wk/wv", v.d_model, vkv, "row"),
            (v.name, "w_up/w_gate", v.d_model, v.d_ff, "row"),
            (v.name, "w_down", v.d_ff, v.d_model, "row"),
            (v.name, "head", v.d_model, v.vocab, "row"),
            (w.name, "wq/wk/wv/wo", w.d_model, w.d_model, "row"),
            (w.name, "w_up", w.d_model, w.d_ff, "row"),
            (w.name, "w_down", w.d_ff, w.d_model, "row"),
            (w.name, "tied head", w.d_model, w.vocab, "tied")]


def matmul_operands(gen, m, k, n, kind, dt):
    """x ~ N(0, 1) [m, k], its rows padded to a multiple of 8 elements where
    k is not one (as the train step's backward pads ``dY`` and ``x^T``:
    ``kernels.ina_matmul._aligned_rows``); w ~ N(0, 1/k) [k, n],
    row-major, the first n columns of a [k, n rounded up to 8] buffer
    ("padded", a rank's ``w_in``, a gradient over an odd vocabulary), or
    the transposed view of an [n, k] table (the tied head's embed.T)."""
    x = torch.randn(m, -(-k // 8) * 8, generator=gen,
                    device="cuda").to(dt)[:, :k]
    if kind == "tied":                             # embed.T, in place
        return x, (torch.randn(n, k, generator=gen, device="cuda")
                   / math.sqrt(k)).to(dt).T
    cols = -(-n // 8) * 8 if kind == "padded" else n
    w = (torch.randn(k, cols, generator=gen, device="cuda")
         / math.sqrt(k)).to(dt)
    return x, w[:, :n]


# the train step's tokens: chip_smoke.py's [train] phase, B 4 x S 1024;
# [train-families]' B 2 x S 1024, and whisper's B 4 x S 448 over 4 x 1500
# frames
TRAIN_TOKENS = 4 * 1024
FAMILY_TRAIN_B, FAMILY_TRAIN_S = 2, 1024
FAMILY_TRAIN_TOKENS = FAMILY_TRAIN_B * FAMILY_TRAIN_S
WHISPER_TRAIN_B, WHISPER_TRAIN_S = 4, 448


def _train_triple(name: str, m: int, k: int, n: int, kind: str,
                  dx: bool = True) -> list[tuple[str, int, int, int, str]]:
    """A product's forward ``x @ w``, its ``dX = dY @ w^T`` with ``w^T``
    read in place (k-major for a row-major w; row-major for the tied
    head's k-major ``embed.T``; none where x takes no gradient), and its
    ``dW = x^T @ dY``, whose K is x's rows."""
    out = [(f"{name} fwd", m, k, n, kind)]
    if dx:
        out.append((f"{name} dX", m, n, k, "row" if kind == "tied"
                    else "tied"))
    # dW reads dY in place: rows padded to 8 elements where N is odd
    # (``kernels.ina_matmul._aligned_rows``: whisper's head)
    return out + [(f"{name} dW", k, m, n, "padded" if n % 8 else "row")]


def train_products(tokens: int = TRAIN_TOKENS, model: str = "qwen2-1.5b"
                   ) -> list[tuple[str, int, int, int, str]]:
    """(name, M, K, N, w layout) of each distinct ``ina_matmul`` product of
    ``model``'s train step over ``tokens`` token rows
    (:func:`_train_triple` of every projection).  qwen2-1.5b (B 4 x S
    1024), and rwkv6-7b, deepseek-v2-lite-16b, zamba2-2.7b and
    llama-3.2-vision-11b (B 2 x S 1024, :data:`FAMILY_TRAIN_TOKENS`);
    whisper-medium's decoder (B 4 x S 448).  The rows past the tokens are
    :func:`media_train_products`'."""
    out = []
    for mod, name, k, n, kind in (matmul_projections() + moe_projections()
                                  + family_projections()):
        if mod == model:
            out += _train_triple(name, tokens, k, n, kind)
    return out


def media_train_products() -> list[tuple[str, str, int, int, int, str]]:
    """(model, name, M, K, N, w layout) of the train steps' products over
    the media rather than the tokens: llama-3.2-vision-11b's
    cross-attention ``wk``/``wv`` over B 2 x 1601 media rows (no dX: the
    media take no gradient), and whisper-medium's encoder over B 4 x 1500
    frames (its decoder's cross-attention ``wk``/``wv`` over the
    encoder's output are the same products as its encoder's
    ``wq/wk/wv/wo``)."""
    v, w = ARCHS["llama-3.2-vision-11b"], ARCHS["whisper-medium"]
    vm = FAMILY_TRAIN_B * v.num_media_tokens
    wf = WHISPER_TRAIN_B * w.num_media_tokens
    out = [(v.name, *row) for row in _train_triple(
        "media wk/wv", vm, v.d_model, v.n_kv_heads * v.resolved_head_dim,
        "row", dx=False)]
    for mod, name, k, n, kind in family_projections():
        if mod == w.name and kind == "row":
            out += [(w.name, *row) for row in _train_triple(
                f"encoder {name}", wf, k, n, kind)]
    return out


def sweep_clusters(ms=(1, 2, 4, 64), seed: int = 0) -> list[dict]:
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for _, name, k, n, kind in (matmul_projections() + moe_projections()
                                + family_projections()):
        for m in ms:
            x, w = matmul_operands(gen, m, k, n, kind, torch.bfloat16)
            plan = im.plan_for(x, w)
            times = {}
            for c in (1, 2, 4, 8):
                if -(-k // im.BK) >= 2 * c or c == 1:
                    forced = plan._replace(cluster=c)
                    times[c] = timer(lambda: im.ina_matmul(x, w, forced))
            row = {"case": name, "m": m, "k": k, "n": n,
                   "regime": plan.regime, "tile": f"{plan.tile_m}x{plan.tile_n}",
                   "planned_c": plan.cluster, "ms_by_c": times,
                   "torch_ms": timer(lambda: torch.matmul(x, w))}
            print(f"[sweep] {name:18s} [{m},{k}]x[{k},{n}] {row['regime']} "
                  f"{row['tile']} planned c={plan.cluster}: "
                  + ", ".join(f"c={c} {t * 1e3:.1f} us" for c, t in times.items())
                  + f"; torch.matmul {row['torch_ms'] * 1e3:.1f} us", flush=True)
            rows.append(row)
    return rows


def time_main_shapes(seed: int = 0) -> list[dict]:
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    ranks = [row for p in TP_WORLDS for row in rank_projections(p)]
    for model, name, k, n, kind in (matmul_projections() + moe_projections()
                                    + family_projections() + ranks):
        for m in MAIN_PATH_M[model]:
            x, w = matmul_operands(gen, m, k, n, kind, torch.bfloat16)
            row = {"case": f"{model} {name} M={m}",
                   "ms": timer(lambda: im.ina_matmul(x, w)),
                   "torch_ms": timer(lambda: torch.matmul(x, w))}
            print(f"[shapes] {row['case']:30s} [{m},{k}]x[{k},{n}] "
                  f"ina_matmul {row['ms']:.4f} ms, torch.matmul "
                  f"{row['torch_ms']:.4f} ms", flush=True)
            rows.append(row)
    return rows


def attention_cases() -> list[tuple]:
    """(name, B, Sq, Sk, H, KVH, D, dtype, cache rows, causal) of the
    flash attention cases in the model's layout: q [B, Sq, H, D], k/v the
    [:, :Sk] slice of a cache of that many rows.  Causal cases sit at
    q_offset Sk - Sq, non-causal ones at 0.  The dense prefill's chunks
    (the profiled prefill step's cache); llama4-scout's forward at GQA 40:8
    (5 query heads a KV head, not a power of two); zamba2's shared
    attention at head dim 160 (bf16 forward, 2 groups in float32);
    llama-3.2-vision's self layers and its cross-attention over 1601 media
    rows (non-causal, GQA 32:8, a ragged Sk); whisper's encoder over 1500
    frames (non-causal, ragged), its decoder at its context of 448 and the
    cross-attention over the frames; each forward the vlm and encdec
    phases hold against their legacy loops (2 prompts); and at one rank's
    heads of worlds 2 and 4: llama4-scout's forward (20:4, 10:2),
    zamba2's shared attention (16 and 8 heads of 160), llama-3.2-vision's
    self layers and cross-attention (16:4, 8:2) and whisper's encoder,
    decoder and cross-attention (8 and 4 heads); and the dense prefill's
    chunk at the uneven head cut's ranks (:data:`UNEVEN_RANKS`): qwen2's
    1:1, qwen3-14b's 3:1 (rank 0) and 3:3 (rank 1, its K/V expanded)."""
    bf16, f32 = torch.bfloat16, torch.float32
    q, ll, l4 = (ARCHS[n] for n in ("qwen2-1.5b", "llama3-8b",
                                    "llama4-scout-17b-16e"))
    z, v, w = (ARCHS[n] for n in ("zamba2-2.7b", "llama-3.2-vision-11b",
                                  "whisper-medium"))

    def gqa(c):
        return c.n_heads, c.n_kv_heads, c.resolved_head_dim
    zs = (z.shared_attn_heads, z.shared_attn_heads,
          2 * z.d_model // z.shared_attn_heads)
    vm, wf = v.num_media_tokens, w.num_media_tokens
    cases = [("qwen2 chunk 1", 1, 64, 64, *gqa(q), bf16, 192, True),
            ("qwen2 chunk 2", 1, 64, 128, *gqa(q), bf16, 192, True),
            ("qwen2 chunk 1 f32", 1, 64, 64, *gqa(q), f32, 192, True),
            ("qwen2 chunk 2 f32", 1, 64, 128, *gqa(q), f32, 192, True),
            ("llama3-8b chunk 2", 1, 64, 128, *gqa(ll), bf16, 192, True),
            ("llama4 forward", 1, 2048, 2048, *gqa(l4), bf16, 2048, True),
            ("zamba2 D=160", 1, 2048, 2048, *zs, bf16, 2048, True),
            ("zamba2 D=160 f32", 1, 300, 300, *zs, f32, 300, True),
            ("vlm self", 1, 2048, 2048, *gqa(v), bf16, 2048, True),
            ("vlm cross", 1, 2048, vm, *gqa(v), bf16, vm, False),
            ("vlm prompt self", 2, 16, 16, *gqa(v), bf16, 16, True),
            ("vlm prompt cross", 2, 16, vm, *gqa(v), bf16, vm, False),
            ("whisper encoder", 1, wf, wf, *gqa(w), bf16, wf, False),
            ("whisper encoder B=2", 2, wf, wf, *gqa(w), bf16, wf, False),
            ("whisper decoder", 1, 448, 448, *gqa(w), bf16, 448, True),
            ("whisper cross", 1, 448, wf, *gqa(w), bf16, wf, False),
            ("whisper prompt self", 2, 8, 8, *gqa(w), bf16, 8, True),
            ("whisper prompt cross", 2, 8, wf, *gqa(w), bf16, wf, False)]
    for p in TP_WORLDS:
        def cut(c):
            return c.n_heads // p, c.n_kv_heads // p, c.resolved_head_dim
        cases += [
            (f"llama4 forward P={p}", 1, 2048, 2048, *cut(l4), bf16, 2048,
             True),
            (f"zamba2 D=160 P={p}", 1, 2048, 2048, zs[0] // p, zs[1] // p,
             zs[2], bf16, 2048, True),
            (f"vlm self P={p}", 1, 2048, 2048, *cut(v), bf16, 2048, True),
            (f"vlm cross P={p}", 1, 2048, vm, *cut(v), bf16, vm, False),
            (f"whisper encoder P={p}", 1, wf, wf, *cut(w), bf16, wf, False),
            (f"whisper decoder P={p}", 1, 448, 448, *cut(w), bf16, 448, True),
            (f"whisper cross P={p}", 1, 448, wf, *cut(w), bf16, wf, False)]
    from repro_torch.parallel.sharding import head_split, kv_index
    for arch, rank in UNEVEN_RANKS:
        c = ARCHS[arch]
        h, kvh = (len(r) for r in head_split(c, rank, UNEVEN_WORLD))
        if kv_index(c, rank, UNEVEN_WORLD) is not None:
            kvh = h                      # expanded to one a query head
        cases.append((f"{arch} chunk 2 P={UNEVEN_WORLD} r{rank}", 1, 64, 128,
                      h, kvh, c.resolved_head_dim, bf16, 192, True))
    return cases


def attention_operands(gen, b, sq, sk, h, kvh, d, dt, cache,
                       causal: bool = True):
    """q ~ N [b, sq, h, d]; k, v ~ N, the [:, :sk] slice of a [b, cache,
    kvh, d] cache (so the batch stride is cache * kvh * d); q_offset sk -
    sq where ``causal``, else 0."""
    def normal(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)
    q = normal(b, sq, h, d)
    ck, cv = normal(b, cache, kvh, d), normal(b, cache, kvh, d)
    return q, ck[:, :sk], cv[:, :sk], sk - sq if causal else 0


def wkv_cases() -> list[tuple[str, int, int, int, str, torch.dtype]]:
    """(name, B, S, H, decay, dtype) of the wkv6 cases, at rwkv6-7b's hd 64
    in the model's layout: at its H 64 the forward's B 2 x S 2048, the
    train step's B 2 x S 1024, the decode check's 300-token prefix, a
    ragged S, the exact-f32 phase's B 1, and decays at and past the
    model's clip floor (where the TPU kernel's 80-nat clamp is wrong: -20
    a step is 160 nats over 8 positions); then the forward at one rank's
    heads of worlds 2 and 4 (H 32, 16)."""
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = ARCHS["rwkv6-7b"]
    h = cfg.d_model // cfg.ssm.head_dim
    return [("forward", 2, 2048, h, "init", bf16),
            ("train B=2 S=1024", 2, 1024, h, "init", bf16),
            ("prefix 300", 2, 300, h, "test", bf16),
            ("ragged S=1000", 2, 1000, h, "test", bf16),
            ("clip-floor decay", 2, 2048, h, "floor", bf16),
            ("steep decay -20", 2, 2048, h, "steep", bf16),
            ("mixed decay", 2, 2048, h, "mixed", bf16),
            ("exact-f32 forward", 1, 300, h, "test", f32)] + [
        (f"forward P={p}", 2, 2048, h // p, "init", bf16) for p in TP_WORLDS]


def wkv_operands(gen, b, s, h, hd, decay, dt):
    """r, k ~ 0.5 N and v ~ N in ``dt``, logw in f32, [B, S, H, hd]; u ~
    0.3 N [H, hd] (nonzero, so the bonus term runs).  logw: "init" the
    model's initial decay (w0 = -6: ~0.0025 nats a step, so the state
    keeps ~400 steps), "test" tests/test_kernels.py's -exp(0.5 N - 1),
    "floor" the model's clip floor -e^2 every step, "steep" -20 every
    step, "mixed" channels alternating -1e-3 and -8."""
    def normal(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    r, k = (0.5 * normal(b, s, h, hd)).to(dt), (0.5 * normal(b, s, h, hd)).to(dt)
    v = normal(b, s, h, hd).to(dt)
    shape = (b, s, h, hd)
    if decay == "init":
        logw = -torch.exp(-6.0 + 0.1 * normal(*shape))
    elif decay == "floor":
        logw = torch.full(shape, -math.exp(2.0), device="cuda")
    elif decay == "steep":
        logw = torch.full(shape, -20.0, device="cuda")
    elif decay == "mixed":
        slow = torch.arange(hd, device="cuda") % 2 == 0
        logw = torch.where(slow, -1e-3, -8.0).expand(shape).contiguous()
    else:
        logw = -torch.exp(0.5 * normal(*shape) - 1.0)
    return r, k, v, logw, 0.3 * normal(h, hd)


def time_wkv(seed: int = 0) -> list[dict]:
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hd = ARCHS["rwkv6-7b"].ssm.head_dim
    rows = []
    for name, b, s, h, decay, dt in wkv_cases():
        r, k, v, logw, u = wkv_operands(gen, b, s, h, hd, decay, dt)
        row = {"case": name, "ms": timer(lambda: wkv6_heads(r, k, v, logw, u))}
        print(f"[wkv6] {name:18s} B={b} S={s} H={h} hd={hd} "
              f"{str(dt).removeprefix('torch.'):8s} {row['ms']:.4f} ms",
              flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", choices=("sweep", "shapes", "wkv6"),
                    default="sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    {"sweep": sweep_clusters, "shapes": time_main_shapes,
     "wkv6": time_wkv}[args.mode]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
