"""Shared layer library (counterpart of ``repro.models.layers``).

Plain functions on tensors and nested-dict parameters, with the JAX
package's layouts at every public function.  Projections go through
:mod:`repro_torch.parallel.tp`, and so through the INA matmul kernel.
Attention over more than one query goes through the flash kernel, causal
or not; single-query attention (:func:`attn_full`: decode, and a decode
step's cross-attention) stays plain PyTorch, as it is plain JAX in the
reference.  MLA, whose q/k and v head dims differ, runs
the reference's own rule (:func:`attention_by_chunk`: :func:`attn_chunked`
or :func:`attn_full`), in plain PyTorch as it is plain JAX there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.core.remat import product
from repro_torch.parallel import tp
from repro_torch.parallel.tp import ParallelCtx, col_linear, row_linear

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #
def dense_init(generator: torch.Generator, shape, in_dim: Optional[int] = None,
               device=None) -> torch.Tensor:
    """Normal(0, 1/in_dim) in float32, as ``repro.models.layers.dense_init``."""
    in_dim = in_dim if in_dim is not None else shape[0]
    scale = 1.0 / math.sqrt(max(in_dim, 1))
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * scale


# Leaves kept in float32 whatever their rank: the reference reads them as
# float32 at every call (the RWKV6 bonus ``u``, ``repro.models.ssm``:231), so
# storing them in the compute dtype would round them.
FLOAT32_LEAVES = ("u",)
# Every stacked key of every family, by the leading axes it adds: a layer
# axis, or for ``groups`` (zamba2's [G, per, ...] Mamba2 layers, the vlm's
# [G, per - 1, ...] self layers) a group axis and a layer axis.  The train
# step splits each into per-layer leaves on all of them.
STACK_AXES = {"layers": 1, "dense_layers": 1, "enc_layers": 1,
              "dec_layers": 1, "xlayers": 1, "inv_norms": 1, "groups": 2}


def to_storage(tree: dict, dtype: torch.dtype) -> dict:
    """The port's storage rule: each matrix (rank >= 2 per layer) in the
    compute ``dtype``, vectors, scalars and :data:`FLOAT32_LEAVES` in
    float32.  The reference keeps float32 masters and casts each matrix to
    the compute dtype at every call, which gives the same numbers, so the
    port casts once.  Leaves under a :data:`STACK_AXES` key carry its
    leading axes, which are not counted."""
    def cast(name, node, lead):
        if isinstance(node, dict):
            return {k: cast(k, v, lead + STACK_AXES.get(k, 0))
                    for k, v in node.items()}
        keep = node.dim() - lead < 2 or name in FLOAT32_LEAVES
        return node.float() if keep else node.to(dtype)
    return cast("", tree, 0)


def to_masters(tree: dict, param_dtype: str) -> dict:
    """The reference's ``Model.init`` rule for training masters: a leaf of
    rank >= 2, counted on the leaf as stored (a stacked leaf's layer axis
    included), in ``param_dtype``; every other leaf in float32."""
    pd = getattr(torch, param_dtype)

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return node.to(pd) if node.dim() >= 2 else node.float()
    return cast(tree)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [S] -> (cos, sin) each [S, head_dim/2], float32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [S, D/2], or [B, S, D/2] for a position
    per row (llama-style rotate-half pairs)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    c = cos[None, :, None, :] if cos.dim() == 2 else cos[:, :, None, :]
    s = sin[None, :, None, :] if sin.dim() == 2 else sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# attention cores
# --------------------------------------------------------------------------- #
def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A plain attention product (MLA's scores or PV), batched over B and
    the heads (:func:`repro_torch.core.remat.product`)."""
    return product("mla_attn", "batched", torch.einsum, eq, a, b)


def attn_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset=0) -> torch.Tensor:
    """Exact attention. q: [B,Sq,H,D], k/v: [B,Sk,K,D] -> [B,Sq,H,D].

    GQA is grouped: query head ``h`` reads KV head ``h // (H/K)`` without
    the cache being repeated.  ``q_offset`` is an int or a per-row [B]
    tensor (the paged decode step, where every slot has its own position).
    Scores and the PV product are sums of f32 products, rounded to q's
    dtype where the reference's einsum rounds.  Outside autograd each sum
    runs over an explicit product, so a row's bits do not depend on the
    batch it sits in; where autograd records (training: MLA's attention
    at a sequence its chunk does not split), each is an f32 matmul
    instead, the same sums in another order, since the product's [.., S,
    D] intermediate and its gradient would not fit the card at S 1024.
    """
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, kv, g, d).permute(0, 2, 3, 1, 4).float()  # b,k,g,q,d
    kt = k.permute(0, 2, 1, 3).float()                              # b,k,s,d
    train = ops.needs_grad(q, k, v)
    if train:
        scores = _einsum("bkgqd,bksd->bkgqs", qg, kt)
    else:
        scores = (qg[:, :, :, :, None, :]
                  * kt[:, :, None, None, :, :]).sum(-1)
    scores = scores.to(q.dtype).float() * scale                     # b,k,g,q,s
    if causal:
        qp = torch.arange(sq, device=q.device)
        if torch.is_tensor(q_offset) and q_offset.dim() == 1:
            qp = qp[None, :] + q_offset.to(q.device)[:, None]           # [B, Sq]
        else:
            qp = qp[None, :] + int(q_offset)                             # [1, Sq]
        mask = qp[:, :, None] >= torch.arange(sk, device=q.device)[None, None, :]
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    vt = v.permute(0, 2, 1, 3).float()                              # b,k,s,dv
    if train:
        out = _einsum("bkgqs,bksd->bkgqd", p.float(), vt)
    else:
        out = (p.float()[..., None] * vt[:, :, None, None, :, :]).sum(-2)
    out = out.to(q.dtype)                                           # b,k,g,q,dv
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, v.shape[-1])


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: repeat KV heads to match query heads. k: [B, S, K, D]."""
    if k.shape[2] == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def attn_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 chunk: int, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Online softmax over KV chunks of ``chunk`` (the reference's
    ``attn_chunked``); q, k: [B, S, ., D], v: [B, Sk, K, Dv] with Dv free
    (MLA: 128 against a q/k head dim of 192).  Each chunk's scores and PV
    product are einsums in q's dtype, as the reference's; m, l and acc are
    f32.  A KV length that ``chunk`` does not divide runs
    :func:`attn_full`, as in the reference."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sk % chunk != 0:
        return attn_full(q, k, v, causal=causal, q_offset=q_offset)
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qp = torch.arange(sq, device=q.device) + int(q_offset)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, chunk):
        kb, vb = k[:, k0:k0 + chunk], v[:, k0:k0 + chunk]
        s = _einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        if causal:
            kp = torch.arange(k0, k0 + chunk, device=q.device)
            s = torch.where((qp[:, None] >= kp[None, :])[None, None], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vb).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention_by_chunk(q, k, v, *, causal: bool, chunk: int = 0,
                       q_offset: int = 0) -> torch.Tensor:
    """The reference's ``attention`` rule: :func:`attn_chunked` where the KV
    length passes ``chunk`` and there is more than one query, else
    :func:`attn_full`.  MLA's path: the flash kernel takes one head dim for
    q, k and v."""
    if chunk and k.shape[1] > chunk and q.shape[1] > 1:
        return attn_chunked(q, k, v, chunk=chunk, causal=causal,
                            q_offset=q_offset)
    return attn_full(q, k, v, causal=causal, q_offset=q_offset)


def attention(q, k, v, *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Attention over several queries, causal or not, runs the flash kernel
    on the model's layout: q [B, Sq, H, D] and k/v [B, Sk, KVH, D] with GQA
    unexpanded, each read in place (k/v may be a slice of the KV cache);
    the output is a contiguous [B, Sq, H, D].  One query runs
    :func:`attn_full`."""
    if q.shape[1] == 1:
        return attn_full(q, k, v, causal=causal, q_offset=q_offset)
    return ops.attention_heads(q, k, v, causal=causal, q_offset=int(q_offset))


# --------------------------------------------------------------------------- #
# GQA attention block
# --------------------------------------------------------------------------- #
def init_attn(generator, d_model: int, n_heads: int, n_kv: int, head_dim: int,
              qk_norm: bool = False, qkv_bias: bool = False,
              device=None) -> dict:
    p = {
        "wq": dense_init(generator, (d_model, n_heads * head_dim), device=device),
        "wk": dense_init(generator, (d_model, n_kv * head_dim), device=device),
        "wv": dense_init(generator, (d_model, n_kv * head_dim), device=device),
        "wo": dense_init(generator, (n_heads * head_dim, d_model), device=device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros(n_heads * head_dim, device=device)
        p["bk"] = torch.zeros(n_kv * head_dim, device=device)
        p["bv"] = torch.zeros(n_kv * head_dim, device=device)
    if qk_norm:
        p["q_norm"] = torch.ones(head_dim, device=device)
        p["k_norm"] = torch.ones(head_dim, device=device)
    return p


def attn_qkv(p: dict, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int,
             cos, sin, eps: float, pctx: Optional[ParallelCtx] = None,
             kv_index: Optional[tuple] = None):
    """Project to q/k/v heads (+qk-norm, +rope). Returns q,k,v [B,S,H,D].

    ``kv_index`` (:func:`~repro_torch.parallel.sharding.kv_index`: a rank
    of the uneven head cut whose query heads straddle its KV heads) gives
    the KV head of each query head: k and v come out expanded to one head
    a query head, as the rank's cache holds them."""
    b, s, _ = x.shape
    q = col_linear(x, p["wq"], pctx, p.get("bq")).reshape(b, s, n_heads, head_dim)
    k = col_linear(x, p["wk"], pctx, p.get("bk")).reshape(b, s, n_kv, head_dim)
    v = col_linear(x, p["wv"], pctx, p.get("bv")).reshape(b, s, n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if kv_index is not None:
        sel = torch.tensor(kv_index, device=k.device)
        k, v = k.index_select(2, sel), v.index_select(2, sel)
    return q, k, v


def no_heads(x: torch.Tensor, p: dict,
             pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """The attention output of a rank of the uneven head cut that holds no
    query head: no projection and no attention, a zero partial into the
    row psum (:func:`~repro_torch.parallel.tp.row_linear` of no rows)."""
    return row_linear(x[..., :0], p["wo"], pctx)


def attn_block(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
               head_dim: int, cos, sin, causal: bool = True, eps: float = 1e-5,
               pctx: Optional[ParallelCtx] = None,
               kv_index: Optional[tuple] = None) -> torch.Tensor:
    b, s, _ = x.shape
    if n_heads == 0:
        return no_heads(x, p, pctx)
    q, k, v = attn_qkv(p, x, n_heads, n_kv, head_dim, cos, sin, eps, pctx,
                       kv_index)
    o = attention(q, k, v, causal=causal)
    return row_linear(o.reshape(b, s, n_heads * head_dim), p["wo"], pctx)


def decode_positions(pos, device, head_dim: int, theta: float):
    """A decode step's positions and RoPE tables: ``pos`` an int, with
    (cos, sin) [1, head_dim/2], or a [B] tensor, one position a row, with
    (cos, sin) [B, 1, head_dim/2] (what :func:`apply_rope` takes)."""
    if torch.is_tensor(pos) and pos.dim() == 1:
        pos = pos.to(device)
        cos, sin = rope_cos_sin(pos, head_dim, theta)
        return pos, cos[:, None, :], sin[:, None, :]
    pos = int(pos)
    cos, sin = rope_cos_sin(torch.tensor([pos], device=device), head_dim,
                            theta)
    return pos, cos, sin


def write_at(cache: torch.Tensor, pos, value: torch.Tensor) -> None:
    """``cache`` [B, S, ...] at position ``pos`` (an int, or a [B] tensor,
    one a row) := ``value`` [B, ...], in place."""
    if torch.is_tensor(pos) and pos.dim() == 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos] = value.to(cache.dtype)
    else:
        cache[:, int(pos)] = value.to(cache.dtype)


def attn_block_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, pos, *, n_heads: int, n_kv: int,
                      head_dim: int, cos, sin, eps: float = 1e-5,
                      pctx: Optional[ParallelCtx] = None,
                      kv_index: Optional[tuple] = None):
    """Single-token decode with a KV cache [B, S, K, D]; returns (y, k, v).

    The new K/V column is written into ``cache_k``/``cache_v`` in place (at
    ``pos``, an int or a per-row [B] tensor), and attention is masked to
    cache positions ``<= pos``.
    """
    b = x.shape[0]
    if n_heads == 0:
        return no_heads(x, p, pctx), cache_k, cache_v
    q, k, v = attn_qkv(p, x, n_heads, n_kv, head_dim, cos, sin, eps, pctx,
                       kv_index)
    write_at(cache_k, pos, k[:, 0])
    write_at(cache_v, pos, v[:, 0])
    o = attn_full(q, cache_k.to(q.dtype), cache_v.to(q.dtype), causal=True,
                  q_offset=pos)
    y = row_linear(o.reshape(b, 1, n_heads * head_dim), p["wo"], pctx)
    return y, cache_k, cache_v


# --------------------------------------------------------------------------- #
# SwiGLU / GeLU MLP
# --------------------------------------------------------------------------- #
def init_mlp(generator, d_model: int, d_ff: int, gated: bool = True,
             device=None) -> dict:
    p = {"w_up": dense_init(generator, (d_model, d_ff), device=device),
         "w_down": dense_init(generator, (d_ff, d_model), device=device)}
    if gated:
        p["w_gate"] = dense_init(generator, (d_model, d_ff), device=device)
    return p


def mlp_block(p: dict, x: torch.Tensor,
              pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    up = col_linear(x, p["w_up"], pctx)
    if "w_gate" in p:
        h = F.silu(col_linear(x, p["w_gate"], pctx)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return row_linear(h, p["w_down"], pctx)


# --------------------------------------------------------------------------- #
# embedding / logits / loss
# --------------------------------------------------------------------------- #
def embed(table: torch.Tensor, tokens: torch.Tensor, dtype,
          pctx: Optional[ParallelCtx] = None,
          vocab: Optional[int] = None) -> torch.Tensor:
    """Row lookup; with ``vocab``, a table of fewer rows is this rank's
    vocab-parallel slice (:func:`repro_torch.parallel.tp.vocab_embed`)."""
    if vocab is None:
        return table.to(dtype)[tokens]
    return tp.vocab_embed(table.to(dtype), tokens, vocab, pctx)


def logits_head(x: torch.Tensor, w: torch.Tensor,
                pctx: Optional[ParallelCtx] = None,
                vocab: Optional[int] = None) -> torch.Tensor:
    """Vocab-sharded logits; with ``vocab``, gathered whole on every rank."""
    out = col_linear(x, w, pctx)
    return out if vocab is None else tp.vocab_gather(out, vocab, pctx)


def xent_loss(logits: torch.Tensor, labels: torch.Tensor,
              z_coef: float = 0.0) -> torch.Tensor:
    """Mean next-token cross-entropy; logits [B,S,V], labels [B,S]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = (lse - gold).mean()
    if z_coef:
        loss = loss + z_coef * lse.square().mean()
    return loss
