"""Mixture-of-Experts decoder (counterpart of ``repro.models.moe``: the
llama4-scout family; the MLA variant in :mod:`repro_torch.models.mla`
shares its FFN).

Routing is the reference's Switch-style top-k with a fixed capacity a
group: an f32 softmax over the router logits, the top k in descending
order (ties to the lower expert index, as ``jax.lax.top_k``), renormalised;
a group of T tokens gives each expert ``min(max(8, int(T k cf / E)), T)``
slots; an assignment's slot is its rank among its expert's assignments
counted over (token, k) flattened token-major, and an assignment past the
capacity is dropped.  Dispatch and combine are gathers.  The experts'
three products are ``torch.bmm`` over ``[E, slots, .]`` and the router is
``torch.matmul``: the reference computes both as einsums outside any Pallas
kernel.  The shared experts and every attention projection run the INA
matmul.

A forward routes its B x S tokens as one group, as the reference does.  A
decode step at a per-row position (a [B] ``pos``, the paged serve step)
routes each row as its own group (capacity 1): row ``i`` computes what a
B=1 decode would, since the reference ``vmap``s a B=1 ``decode_step`` over
the cache slots.  A decode step at one scalar position routes its B rows as
one group, as the reference's ``decode_step`` does.  Every group's slots sit
side by side in one batched expert product, so the experts' weights are
read once a layer.

The weights follow the reference's names and layouts (``dense_layers`` for
the leading dense layers, ``layers`` for the MoE stack, stacked ``[L,
...]``), stored by :func:`repro_torch.models.layers.to_storage`.  There is
no ``prefill``, as in the reference: the serving engine seats prompts
through the per-token decode loop.  ``decode_step`` writes the cache in
place and returns it.

Under tensor parallelism the parameters are a rank's shards
(:mod:`repro_torch.parallel.sharding`): every rank routes every token over
all E experts with the whole router (the same capacity, slots, aux loss
and :class:`Routing` record on each), runs its own E/P experts on the
assignments that reach them (the rest weighted 0), and the ranks' [T, D]
partial combines are summed under ``psum_mode``
(:func:`repro_torch.parallel.tp.psum_partial`): the MoE INA site, one a
layer, the paper's WS partial sum with experts in place of weight slices.
The shared experts keep their own row-parallel psum, as in the reference.
Attention runs the rank's heads, the cache holds its KV heads, and the
embedding and the head are vocab-parallel.  Under ``rs_seq`` the stream
between the blocks is this rank's slice of the sequence: each block's
normed input is gathered whole (:func:`repro_torch.parallel.tp.
gather_seq`), so the router, the capacity and the slots cover the whole
sequence as in the reference; ``wo``, a dense layer's ``w_down`` and the
shared experts' ``w_down`` reduce-scatter over S, the experts' combine
psums whole and is then sliced (:func:`repro_torch.parallel.tp.
scatter_seq`), and the aux loss stays whole and equal on every rank.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers as L
from repro_torch.core.remat import product
from repro_torch.models.transformer import (_dtype, block_input,
                                            embed_stream, head_layout,
                                            head_logits, layer, remat)
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import local_heads
from repro_torch.parallel.tp import ParallelCtx

# Decode-cache layout (read by ``models.api``), by leaf: ``dk``/``dv`` exist
# where the config has leading dense layers.
CACHE_BATCH_AXES = {"k": 1, "v": 1, "dk": 1, "dv": 1}
# as ``transformer.STREAM_LEAVES``: the block norms and ``ln_f``
STREAM_LEAVES = {"layers/ln1": "tokens", "layers/ln2": "tokens",
                 "ln_f": "tokens"}
PAGED_CACHE_LEAVES = ("k", "v", "dk", "dv")

_ROUTING: Optional[list] = None


class Routing(NamedTuple):
    """One :func:`moe_mlp` call's routing, on the device."""
    dropped: torch.Tensor       # () assignments past their expert's capacity
    assignments: int            # tokens x top_k
    experts: torch.Tensor       # [tokens, top_k] the chosen experts


@contextmanager
def record_routing():
    """Collect a :class:`Routing` for each :func:`moe_mlp` call inside the
    context (no host sync in the step).  Reentrant."""
    global _ROUTING
    prev, calls = _ROUTING, []
    _ROUTING = calls
    try:
        yield calls
    finally:
        _ROUTING = prev


def dropped_share(calls: list) -> float:
    """The dropped share of (token, expert) assignments over ``calls``."""
    dropped = sum(int(c.dropped) for c in calls)
    return dropped / max(sum(c.assignments for c in calls), 1)


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def init_moe_mlp(generator, cfg: ModelConfig, device) -> dict:
    m = cfg.moe
    e, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
    p = {
        "router": L.dense_init(generator, (d, e), device=device),
        "w_gate": L.dense_init(generator, (e, d, f), in_dim=d, device=device),
        "w_up": L.dense_init(generator, (e, d, f), in_dim=d, device=device),
        "w_down": L.dense_init(generator, (e, f, d), in_dim=f, device=device),
    }
    if m.num_shared:
        p["shared"] = L.init_mlp(generator, d, f * m.num_shared, device=device)
    return p


def init_layer(generator, cfg: ModelConfig, device, dense: bool = False
               ) -> dict:
    """One layer's weights in float32."""
    return {
        "ln1": torch.ones(cfg.d_model, device=device),
        "attn": L.init_attn(generator, cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.resolved_head_dim,
                            cfg.qk_norm, cfg.qkv_bias, device=device),
        "ln2": torch.ones(cfg.d_model, device=device),
        "mlp": (L.init_mlp(generator, cfg.d_model, cfg.d_ff, device=device)
                if dense else init_moe_mlp(generator, cfg, device)),
    }


def stack_drawn(draw: Callable[[], dict], n: int) -> dict:
    """``n`` per-layer trees from ``draw`` stacked into ``[n, ...]`` leaves,
    each copied into the stack as it is drawn: the peak is the stack and one
    layer (stacking a list at the end holds every layer twice, 57 GB for
    deepseek-v2-lite's experts)."""
    def alloc(t):
        return {k: alloc(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.new_empty((n,) + tuple(t.shape))

    def put(out, t, i):
        for k, v in t.items():
            put(out[k], v, i) if isinstance(v, dict) else out[k][i].copy_(v)
    first = draw()
    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, draw(), i)
    return out


def init_stacks(cfg: ModelConfig, generator, device, masters: bool,
                draw_layer: Callable) -> dict:
    """The family's weights (``draw_layer(generator, cfg, device, dense)``
    gives one layer), stored as :func:`repro_torch.models.transformer.init`
    stores them."""
    dt = _dtype(cfg)
    per_layer = (lambda t: t) if masters else (lambda t: L.to_storage(t, dt))
    nd = cfg.moe.first_dense_layers

    def stack(dense, n):
        return stack_drawn(lambda: per_layer(draw_layer(generator, cfg, device,
                                                        dense)), n)
    params = {}
    if nd:
        params["dense_layers"] = stack(True, nd)
    params["layers"] = stack(False, cfg.n_layers - nd)
    params["embed"] = L.dense_init(generator, (cfg.vocab, cfg.d_model),
                                   device=device)
    params["ln_f"] = torch.ones(cfg.d_model, device=device)
    params["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                     in_dim=cfg.d_model, device=device)
    return L.to_masters(params, cfg.param_dtype) if masters \
        else L.to_storage(params, dt)


def init(cfg: ModelConfig, generator: torch.Generator, device,
         masters: bool = False) -> dict:
    """Random weights with the distributions of ``repro.models.moe.init``
    (the draws themselves differ: torch and JAX generators differ)."""
    return init_stacks(cfg, generator, device, masters, init_layer)


def stacks(params: dict, cfg: ModelConfig) -> list:
    """(dense, stacked weights, depth) of the leading dense stack, if any,
    then of the MoE stack: the order the layers run in."""
    nd = cfg.moe.first_dense_layers
    out = [(True, params["dense_layers"], nd)] if nd else []
    return out + [(False, params["layers"], cfg.n_layers - nd)]


# --------------------------------------------------------------------------- #
# MoE forward
# --------------------------------------------------------------------------- #
def capacity(n_tok: int, m: MoEConfig) -> int:
    """Slots an expert has for a group of ``n_tok`` tokens (``moe.py:116``
    of the reference)."""
    return min(max(8, int(n_tok * m.top_k * m.capacity_factor
                          / m.num_experts)), n_tok)


def top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest of the last axis in descending order, ties to the
    lower index (``jax.lax.top_k``'s order, on which the slots depend)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_partial(xt, expert, slot, mine, gate_vals, wg, wu, wd,
                    slots: int) -> torch.Tensor:
    """Dispatch -> the experts' SwiGLU -> combine: [T, D], the partial sum
    of the E experts ``wg`` holds.

    ``expert`` [T, k] is each assignment's expert among them and ``slot``
    its column of the ``[E, slots]`` dispatch; an assignment that is not
    ``mine`` (dropped, or routed to another rank's expert) writes the spare
    row E, which no expert reads, and is weighted 0 in the combine."""
    t, d = xt.shape
    e, k = wg.shape[0], expert.shape[1]
    # slot_token[e, c]: the token in slot c of expert e (t: none, a zero row)
    slot_token = torch.full((e + 1, slots), t, dtype=torch.long,
                            device=xt.device)
    tids = torch.arange(t, device=xt.device)[:, None].expand(t, k)
    slot_token[torch.where(mine, expert, e), slot] = tids
    xe = torch.cat([xt, xt.new_zeros(1, d)])[slot_token[:e]]   # [E, C, D]
    with torch.profiler.record_function("moe_experts"):
        h = F.silu(product("experts", "batched", torch.bmm, xe,
                                 wg.to(xt.dtype))) \
            * product("experts", "batched", torch.bmm, xe,
                            wu.to(xt.dtype))
        ye = product("experts", "batched", torch.bmm, h,
                           wd.to(xt.dtype))                     # [E, C, D]
    contrib = ye[torch.where(mine, expert, e - 1), slot]       # [T, k, D]
    w = (gate_vals * mine).to(xt.dtype)
    return product("combine", "batched", _combine, contrib, w,
                         reduction=True).to(xt.dtype)


def _combine(contrib: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's ``tkd,tk->td``: each token's k expert outputs
    weighted by their gates and summed, in float32."""
    return (contrib.float() * w.float()[..., None]).sum(1)


def moe_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig,
            pctx: Optional[ParallelCtx] = None, groups: int = 1):
    """Returns (output [B, S, D], aux loss).  The B x S tokens, flattened
    row-major, are routed as ``groups`` equal runs, each with its own
    capacity (the module docstring says which callers pass what).  With
    a rank's shard of the experts, the output is the ranks' partial
    combines summed (the module docstring).  On the rank mesh's data axis
    (a train step whose hosts hold rows of one global batch), the global
    batch is the one group, as in the reference: the capacity is the
    global batch's, an assignment's slot counts the hosts' before it
    (:func:`~repro_torch.parallel.tp.host_offsets`), and the aux loss
    takes the hosts' mean load and importance
    (:func:`~repro_torch.parallel.tp.host_mean`).  Under rs_seq ``x`` is
    the whole sequence and the output this rank's slice of it: the
    combine's whole sum sliced, plus the shared experts' reduce-scatter.
    In training ``x`` enters this rank's experts and the shared experts'
    columns through one ``f``: its entry takes none
    (:func:`~repro_torch.parallel.tp.gather_seq`'s ``cut=False``)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    n_tok = b * s
    per_group = n_tok // groups
    # data-parallel hosts route the global batch's rows as one group
    hosts = tp.hosts(pctx).count
    cap = capacity(per_group * hosts, m)

    logits32 = product("router", "nb", torch.matmul, x,
                             p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits32, dim=-1)                     # [B, S, E]
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    gate_idx = gate_idx.reshape(n_tok, k)
    gate_vals = gate_vals.reshape(n_tok, k)
    onehot = F.one_hot(gate_idx, e)                             # [T, k, E]
    # each assignment's rank in its expert over its group's (token, k),
    # token-major: a scan along the last axis of [G, E, per_group k] (an
    # H100 scans a leading axis serially: 60 ms of deepseek-v2-lite's
    # S 2048 forward)
    rank = onehot.reshape(groups, per_group * k, e).transpose(1, 2) \
        .contiguous().cumsum(-1).transpose(1, 2).reshape(n_tok, k, e) - 1
    pos = (rank * onehot).sum(-1)                               # [T, k]
    if hosts > 1:
        # after the assignments of the hosts before this one
        pos = pos + tp.host_offsets(onehot.sum((0, 1)), pctx)[gate_idx]
    keep = (pos < cap) & (gate_vals > 0)
    group0 = torch.arange(n_tok, device=x.device) // per_group * cap
    slot = torch.where(keep, pos, 0) + group0[:, None]
    # this rank's experts [e0, e0 + held): all E where the weights are
    # whole (one rank, or the plan builder's meta trace)
    expert, mine, held = gate_idx, keep, p["w_gate"].shape[0]
    if held < e:
        e0 = pctx.rank * held
        expert = gate_idx - e0
        mine = keep & (expert >= 0) & (expert < held)
    # in training, the whole x and gate values enter this rank's experts
    # (and x the shared experts' cut columns) through Megatron's f: the
    # router, its softmax and the aux loss stay outside, whole
    xc = tp.enter_cut(x, pctx)
    out = _expert_partial(xc.reshape(n_tok, d), expert, slot, mine,
                          tp.enter_cut(gate_vals, pctx), p["w_gate"],
                          p["w_up"], p["w_down"], groups * cap)
    out = tp.scatter_seq(tp.psum_partial(out, pctx).reshape(b, s, d), pctx)
    if "shared" in p:
        out = out + L.mlp_block(p["shared"], xc, pctx)

    # Switch aux losses: load balance + router z-loss
    me = probs.reshape(n_tok, e).mean(0)
    ce = (onehot.float() * keep[..., None].float()).sum(1).mean(0)
    if hosts > 1:
        me, ce = tp.host_mean(me, pctx), tp.host_mean(ce, pctx)
    aux = m.aux_loss_coef * e * (me * ce).sum() + m.router_z_coef \
        * torch.logsumexp(logits32, dim=-1).square().mean()
    if _ROUTING is not None:
        _ROUTING.append(Routing((~keep).sum(), keep.numel(), gate_idx))
    return out, aux


def ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig,
        pctx: Optional[ParallelCtx], dense: bool, seq: int, groups: int = 1):
    """``x`` plus the layer's MLP (dense) or MoE on its normed ``x``, the
    whole ``seq`` positions gathered at the entry (``x`` this rank's slice
    of them under rs_seq); returns (x, aux loss)."""
    # the MoE keeps its own ``f``s (the router's whole work): no ``f`` at
    # its gather
    h = block_input(x, lp["ln2"], cfg, seq, pctx, cut=dense)
    if dense:
        return (x + L.mlp_block(lp["mlp"], h, pctx),
                torch.zeros((), device=x.device))
    y, aux = moe_mlp(lp["mlp"], h, cfg, pctx, groups)
    return x + y, aux


def layer_fwd(lp: dict, x: torch.Tensor, cfg: ModelConfig, cos, sin,
              pctx: Optional[ParallelCtx], seq: int, dense: bool = False):
    """One layer over the whole sequence of ``seq`` positions (``x`` this
    rank's slice of them under rs_seq); returns (x, aux loss).  Causal
    attention runs the flash kernel (the reference's ``attn_chunked`` /
    ``attn_full``: the same function)."""
    hd = cfg.resolved_head_dim
    nh, nkv, idx = head_layout(lp["attn"], cfg, pctx)
    h = block_input(x, lp["ln1"], cfg, seq, pctx)
    x = x + L.attn_block(lp["attn"], h, n_heads=nh, n_kv=nkv, head_dim=hd,
                         cos=cos, sin=sin, causal=True, eps=cfg.norm_eps,
                         pctx=pctx, kv_index=idx)
    return ffn(lp, x, cfg, pctx, dense, seq)


def run_layers(params: dict, cfg: ModelConfig, x: torch.Tensor,
               layer_fwd: Callable):
    """Every layer, the dense stack first, on the residual stream ``x``
    (``layer_fwd(layer weights, x, dense) -> (x, aux)``), each checkpointed
    where autograd records it (:func:`~repro_torch.models.transformer.
    remat`: the aux loss comes out of the checkpointed layer, as the
    reference carries it in its scan); returns (the final x, before
    ``ln_f``, and the summed aux loss)."""
    aux = torch.zeros((), device=x.device)
    for dense, stack, n in stacks(params, cfg):
        for i in range(n):
            x, a = remat(layer_fwd, cfg, layer(stack, i), x, dense)
            aux = aux + a
    return x, aux


def hidden_states(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  pctx: Optional[ParallelCtx] = None):
    """(the final stream, before ``ln_f``: this rank's slice of the
    sequence under rs_seq; aux loss)."""
    seq = tokens.shape[1]
    x = embed_stream(params, cfg, tokens, pctx)
    pos = torch.arange(seq, device=tokens.device)
    cos, sin = L.rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
    return run_layers(params, cfg, x, lambda lp, x, dense: layer_fwd(
        lp, x, cfg, cos, sin, pctx, seq, dense))


def forward(params: dict, cfg: ModelConfig, batch: dict,
            pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    tokens = batch["tokens"]
    x, _ = hidden_states(params, cfg, tokens, pctx)
    return head_logits(params, cfg, x, tokens.shape[1], pctx)


def loss(params: dict, cfg: ModelConfig, batch: dict,
         pctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    tokens = batch["tokens"]
    x, aux = hidden_states(params, cfg, tokens, pctx)
    return L.xent_loss(head_logits(params, cfg, x, tokens.shape[1], pctx),
                       batch["labels"]) + aux


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
               world: int = 1, rank: int = 0) -> dict:
    """K/V of the KV heads rank ``rank`` of ``world`` holds."""
    nd = cfg.moe.first_dense_layers
    kvh = local_heads(cfg, world, rank=rank)[1]

    def kv(n):
        return torch.zeros((n, batch, max_seq, kvh, cfg.resolved_head_dim),
                           dtype=_dtype(cfg), device=device)
    cache = {"k": kv(cfg.n_layers - nd), "v": kv(cfg.n_layers - nd)}
    if nd:
        cache["dk"], cache["dv"] = kv(nd), kv(nd)
    return cache


def decode_groups(tokens: torch.Tensor, pos) -> int:
    """Routing groups of a decode step: one a row at per-row positions
    (the paged step), one for the batch at a scalar position."""
    return tokens.shape[0] if torch.is_tensor(pos) and pos.dim() == 1 else 1


def decode_step(params: dict, cfg: ModelConfig, batch: dict, cache: dict,
                pctx: Optional[ParallelCtx] = None):
    """One-token decode.  batch: {tokens: [B, 1], pos: int or [B] tensor};
    returns (logits [B, 1, V], cache), the cache written in place."""
    tokens = batch["tokens"]
    hd = cfg.resolved_head_dim
    groups = decode_groups(tokens, batch["pos"])
    pos, cos, sin = L.decode_positions(batch["pos"], tokens.device, hd,
                                       cfg.rope_theta)
    x = L.embed(params["embed"], tokens, _dtype(cfg), pctx, cfg.vocab)
    caches = {True: ("dk", "dv"), False: ("k", "v")}
    for dense, stack, n in stacks(params, cfg):
        ck, cv = (cache[name] for name in caches[dense])
        for i in range(n):
            lp = layer(stack, i)
            nh, nkv, idx = head_layout(lp["attn"], cfg, pctx)
            y, _, _ = L.attn_block_decode(
                lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), ck[i],
                cv[i], pos, n_heads=nh, n_kv=nkv, head_dim=hd, cos=cos,
                sin=sin, eps=cfg.norm_eps, pctx=pctx, kv_index=idx)
            x, _ = ffn(lp, x + y, cfg, pctx, dense, 1, groups)
    return head_logits(params, cfg, x, 1, pctx), cache
