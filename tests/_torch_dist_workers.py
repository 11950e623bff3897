"""Rank functions for the port's multi-rank tests (gloo on the CPU).

``repro_torch.launch.mesh.spawn`` starts each rank in a fresh interpreter
that imports this module by name, so it imports torch and the port only
(no JAX: a rank needs none, and it would only slow the start).  Every
function returns numpy arrays and lists, never tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import collectives as C
from repro_torch.models import encdec, hybrid, moe, rwkv, transformer, vision
from repro_torch.models.api import get_model
from repro_torch.parallel.sharding import shard_params
from repro_torch.parallel.tp import ParallelCtx, combine_experts
from repro_torch.serve.batching import Request
from repro_torch.serve.engine import ServingEngine

MODES = ("ina", "ina_ring", "eject_inject", "xla", "auto")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def collective_fns(group) -> dict:
    """Name -> function of this rank's [16, 32] input, the same table the
    reference's side runs (``tests/test_torch_collectives.py``)."""
    fns = {"eject_inject": lambda x: C.ring_psum_eject_inject(x, group)}
    for a in (0, 1):
        fns[f"rs_ina_ax{a}"] = \
            lambda x, a=a: C.ring_reduce_scatter_ina(x, group, a)
        fns[f"all_gather_ax{a}"] = \
            lambda x, a=a: C.ring_all_gather(x, group, a)
        fns[f"psum_ina_ax{a}"] = lambda x, a=a: C.psum_ina(x, group, a)
        for m in MODES:
            fns[f"psum_with_mode_{m}_ax{a}"] = \
                lambda x, a=a, m=m: C.psum_with_mode(x, group, m, a)
            fns[f"rs_with_mode_{m}_ax{a}"] = \
                lambda x, a=a, m=m: C.reduce_scatter_with_mode(x, group, m, a)
    return fns


def collectives_rank(rank, world, group, device, x_all):
    """Every function of :func:`collective_fns` on ``x_all[rank]`` in each
    dtype (outputs as float32 numpy), and the ``auto`` sites the reduced
    qwen2's forward and decode step record."""
    out = {}
    for dname, dt in DTYPES.items():
        x = torch.from_numpy(x_all[rank]).to(dt)
        for name, fn in collective_fns(group).items():
            y = fn(x)
            assert y.dtype == dt, (name, y.dtype)
            out[f"{dname}/{name}"] = y.float().numpy()
        assert torch.equal(x, torch.from_numpy(x_all[rank]).to(dt)), \
            "a collective wrote into its input"
    if ARCHS["qwen2-1.5b"].reduced().n_heads % world == 0:
        out["sites"] = model_sites(group, world, rank)
    return out


def model_sites(group, world, rank) -> dict:
    """(op, p, nbytes) of each auto site, by (phase, rs_seq)."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = shard_params(model.init(gen, device="cpu"), cfg, rank, world)
    sites = {}
    for rs in (False, True):
        pctx = ParallelCtx(group=group, psum_mode="auto", rs_seq=rs)
        with C.record_psum_sites() as fwd:
            model.forward(params, {"tokens": torch.zeros(2, 8, dtype=torch.long)},
                          pctx)
        cache = model.init_cache(2, 16, device="cpu", world=world)
        with C.record_psum_sites() as dec:
            model.decode_step(params, {"tokens": torch.zeros(2, 1,
                                                             dtype=torch.long),
                                       "pos": 3}, cache, pctx)
        sites[f"forward/{rs}"] = [(s.op, s.p, s.nbytes) for s in fwd]
        sites[f"decode/{rs}"] = [(s.op, s.p, s.nbytes) for s in dec]
    return sites


def tp_rank(rank, world, group, device, spec):
    """The reduced model on this rank's shard, for each case of ``spec``:
    the forward logits, each prefill chunk's logits and each decode step's,
    then the engine's greedy tokens under each mode, and ``combine_experts``
    on this rank's experts."""
    cfg = ARCHS[spec["arch"]].reduced()
    model = get_model(cfg)
    full = params_from_jax(spec["params"], cfg, device="cpu")
    params = shard_params(full, cfg, rank, world)
    toks = torch.from_numpy(spec["tokens"]).long()
    b, s = toks.shape
    out = {}
    for name, kw in spec["cases"].items():
        pctx = ParallelCtx(group=group, **kw)
        res = {"forward": model.forward(params, {"tokens": toks}, pctx).numpy()}
        cache = model.init_cache(b, spec["max_seq"], device="cpu", world=world)
        chunks = []
        for p0, p1 in spec["chunks"]:
            logits, cache = model.prefill(params, {"tokens": toks[:, p0:p1]},
                                          cache, pctx, pos_offset=p0)
            chunks.append(logits.numpy())
        res["prefill"] = chunks
        steps = []
        for pos, tok in enumerate(spec["decode_tokens"], start=s):
            logits, cache = model.decode_step(
                params, {"tokens": torch.from_numpy(tok[:, None]).long(),
                         "pos": pos}, cache, pctx)
            steps.append(logits.numpy())
        res["decode"] = steps
        out[name] = res
    out["engine"] = {}
    for mode in spec["engine_modes"]:
        engine = ServingEngine(cfg, params=full, device="cpu", slots=2,
                               max_seq=spec["max_seq"], block_size=4,
                               prefill_chunk=4, psum_mode=mode, check=True,
                               group=group)
        report = engine.run([Request(rid=f"r{i}", prompt_len=len(p),
                                     max_new=spec["gen"], prompt=tuple(p))
                             for i, p in enumerate(spec["prompts"])])
        out["engine"][mode] = report.tokens()
    if "uneven" in spec:
        out["uneven"] = uneven_rank(spec["uneven"], rank, world, group)
    if "combine" in spec:
        comb, experts = (torch.from_numpy(a) for a in spec["combine"])
        e = experts.shape[0] // world
        out["combine"] = {
            mode: combine_experts(
                comb[:, :, rank * e:(rank + 1) * e],
                experts[rank * e:(rank + 1) * e],
                ParallelCtx(group=group, psum_mode=mode)).numpy()
            for mode in C.CLI_PSUM_MODES}
    return out


@contextlib.contextmanager
def stream_shapes():
    """The shape of the residual stream each checkpointed unit (a layer,
    or a zamba2 or vlm group) of a family's forward receives, in order:
    every family module's ``remat`` (MLA's layers run through
    ``models.moe``'s) wrapped for the duration."""
    shapes, mods = [], (transformer, rwkv, moe, hybrid, vision, encdec)
    orig = transformer.remat

    def remat(fn, cfg, lp, x, *args):
        shapes.append(tuple(x.shape))
        return orig(fn, cfg, lp, x, *args)
    for mod in mods:
        mod.remat = remat
    try:
        yield shapes
    finally:
        for mod in mods:
            mod.remat = orig


def uneven_rank(cases: dict, rank, world, group) -> dict:
    """The uneven head cut (``tests/_torch_uneven_cases.py``): for each
    case (label -> the arch, its reduced config's replaced fields, the
    reference's params, tokens and labels, decode tokens), on this rank's
    shard under ``ina``: the forward logits, each decode step's logits
    from an empty cache of this rank's size, the loss and this rank's
    gradient shards, this rank's params and AdamW moments after one
    train step, and the engine's greedy tokens on ``u["prompts"]``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.parallel.steps import build_train_step, loss_and_grads
    out = {}
    for label, u in cases.items():
        cfg = dataclasses.replace(ARCHS[u["arch"]].reduced(), **u["config"])
        model = get_model(cfg)
        pctx = ParallelCtx(group=group, psum_mode="ina")
        full = params_from_jax(u["params"], cfg, device="cpu", masters=True)
        params = tree_map(torch.clone, shard_params(full, cfg, rank, world))
        toks = torch.from_numpy(u["tokens"]).long()
        res = {"forward": model.forward(params, {"tokens": toks},
                                        pctx).detach().numpy(),
               "decode": []}
        cache = model.init_cache(toks.shape[0], u["max_seq"], device="cpu",
                                 world=world, rank=rank)
        res["cache_heads"] = int(cache["k"].shape[3])
        for pos, tok in enumerate(u["decode_tokens"]):
            logits, cache = model.decode_step(
                params, {"tokens": torch.from_numpy(tok[:, None]).long(),
                         "pos": pos}, cache, pctx)
            res["decode"].append(logits.detach().numpy())
        batch = {"tokens": toks,
                 "labels": torch.from_numpy(u["labels"]).long()}
        loss, grads = loss_and_grads(model, params, batch, pctx)
        res["loss"], res["grads"] = float(loss), _numpy(grads)
        shape = ShapeConfig("t", toks.shape[1], toks.shape[0], "train")
        ts = build_train_step(model, shape, pctx, **u["schedule"])
        params, opt, _ = ts.fn(params, adamw_init(params), batch)
        res["params"], res["m"], res["v"] = (_numpy(t) for t in
                                             (params, opt.m, opt.v))
        engine = ServingEngine(cfg, params=params_from_jax(
            u["params"], cfg, device="cpu"), device="cpu", slots=2,
            max_seq=u["max_seq"], block_size=4, prefill_chunk=4,
            psum_mode="ina", check=True, group=group)
        report = engine.run([Request(rid=f"r{i}", prompt_len=len(p),
                                     max_new=u["gen"], prompt=tuple(p))
                             for i, p in enumerate(u["prompts"])])
        res["engine"] = report.tokens()
        out[label] = res
    return out


def tp_family_rank(rank, world, group, device, spec):
    """The reduced non-dense families (``spec["archs"]``: each arch's
    params, forward tokens, decode tokens and, for vlm and encdec, media
    [B, M, D]) on this rank's shard under each case of ``spec["cases"]``
    (``ParallelCtx`` keywords): the forward logits, each decode step's
    logits from an empty cache (vlm's media K/V written first by
    ``prefill_media_kv``, whisper's media in every step's batch), and, for
    the families the engine serves (no media), its greedy tokens on
    ``spec["prompts"]`` under each psum mode of ``spec["engine"]``; under
    ``rs_seq`` also the forward's collective
    calls by kind, the stream's shape at each checkpointed unit
    (:func:`stream_shapes`), and the same of a forward of the first
    ``spec["short"]`` tokens; then the ``auto`` sites (op, p, nbytes) a
    forward and the decode steps record."""
    out = {}
    for arch, a in spec["archs"].items():
        cfg = ARCHS[arch].reduced()
        model = get_model(cfg)
        full = params_from_jax(a["params"], cfg, device="cpu")
        params = shard_params(full, cfg, rank, world)
        toks = torch.from_numpy(a["tokens"]).long()
        b = toks.shape[0]
        media = {} if a.get("media") is None else \
            {"media": torch.from_numpy(a["media"])}

        def run(pctx):
            res = {}
            with stream_shapes() as shapes:
                C.CALLS.clear()
                res["forward"] = model.forward(
                    params, {"tokens": toks, **media}, pctx).numpy()
                res["calls"] = dict(C.CALLS)
                if pctx.rs_seq:
                    res["stream"] = list(shapes)
                    shapes.clear()
                    res["forward_short"] = model.forward(
                        params, {"tokens": toks[:, :spec["short"]], **media},
                        pctx).numpy()
                    res["stream_short"] = list(shapes)
            cache = model.init_cache(b, spec["max_seq"], device="cpu",
                                     world=world)
            if cfg.family == "vlm":
                cache = vision.prefill_media_kv(params, cfg, media["media"],
                                                cache, pctx)
            step_media = media if cfg.family == "encdec" else {}
            res["decode"] = []
            for pos, tok in enumerate(a["decode_tokens"]):
                logits, cache = model.decode_step(
                    params, {"tokens": torch.from_numpy(tok[:, None]).long(),
                             "pos": pos, **step_media}, cache, pctx)
                res["decode"].append(logits.numpy())
            return res
        res = {name: run(ParallelCtx(group=group, **kw))
               for name, kw in spec["cases"].items()}
        with C.record_psum_sites() as sites:
            run(ParallelCtx(group=group, psum_mode="auto"))
        res["sites"] = [(s.op, s.p, s.nbytes) for s in sites]
        res["engine"] = {}
        for mode in spec["engine"] if not media else ():
            engine = ServingEngine(cfg, params=full, device="cpu", slots=2,
                                   max_seq=spec["max_seq"], block_size=4,
                                   psum_mode=mode, check=True, group=group)
            report = engine.run([Request(rid=f"r{i}", prompt_len=len(p),
                                         max_new=spec["gen"], prompt=tuple(p))
                                 for i, p in enumerate(spec["prompts"])])
            res["engine"][mode] = report.tokens()
        out[arch] = res
    if "uneven" in spec:
        out["uneven"] = uneven_rank(spec["uneven"], rank, world, group)
    return out


# --------------------------------------------------------------------------- #
# tensor-parallel training (tests/test_torch_tp_train.py)
# --------------------------------------------------------------------------- #
def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().numpy().copy()
            for k, v in tree.items()}


def _batch(pair):
    """A train batch from (tokens, labels), or (tokens, labels, media) for
    the encdec and vlm families."""
    out = {"tokens": torch.from_numpy(pair[0]).long(),
           "labels": torch.from_numpy(pair[1]).long()}
    if len(pair) > 2:
        out["media"] = torch.from_numpy(pair[2])
    return out


def tp_train_rank(rank, world, group, device, spec):
    """The reduced model's train step on this rank's shard, for each case
    of ``spec``: the loss and this rank's gradient shards on
    ``spec["grad_batch"]``, then two AdamW steps from the same weights,
    each step's loss, grad_norm, lr and collective calls by kind, and the
    params and AdamW moments after them.  At world 1 the case
    ``"groupless"`` runs with no group at all.  ``spec["config"]``
    replaces fields of the reduced config."""
    cfg = dataclasses.replace(ARCHS[spec["arch"]].reduced(),
                              **spec.get("config", {}))
    return _train_cases(cfg, spec, rank, world, group)


def _train_cases(cfg, spec, rank, world, group) -> dict:
    """:func:`tp_train_rank`'s cases for the config ``cfg`` and the
    reference's weights ``spec["params"]``; and, for each case of
    ``spec["grad_cases"]``, the loss, this rank's gradient shards and the
    gradient's collective calls alone."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.parallel.steps import (build_train_step, grad_sync,
                                            loss_and_grads)
    model = get_model(cfg)
    full = params_from_jax(spec["params"], cfg, device="cpu", masters=True)
    grad_batch = _batch(spec["grad_batch"])
    b, s = grad_batch["tokens"].shape
    shape = ShapeConfig("t", s, b, "train")
    sync = grad_sync(cfg, ParallelCtx(group=group))
    cases = dict(spec["cases"])
    if world == 1:
        cases["groupless"] = None
    out = {}
    for name, kw in cases.items():
        pctx = None if kw is None else ParallelCtx(group=group, **kw)
        # AdamW updates in place, and a whole leaf is ``full``'s own
        params = tree_map(torch.clone, shard_params(full, cfg, rank, world))
        C.CALLS.clear()
        loss, grads = loss_and_grads(model, params, grad_batch, pctx, sync)
        res = {"loss": float(loss), "grads": _numpy(grads),
               "grad_calls": dict(C.CALLS), "steps": []}
        ts = build_train_step(model, shape, pctx, **spec["schedule"])
        opt = adamw_init(params)
        for pair in spec["step_batches"]:
            C.CALLS.clear()
            params, opt, st = ts.fn(params, opt, _batch(pair))
            res["steps"].append({"loss": float(st["loss"]),
                                 "grad_norm": float(st["grad_norm"]),
                                 "lr": float(st["lr"]),
                                 "calls": dict(C.CALLS)})
        res["params"] = _numpy(params)
        res["m"], res["v"] = _numpy(opt.m), _numpy(opt.v)
        out[name] = res
    for name, kw in spec.get("grad_cases", {}).items():
        C.CALLS.clear()
        loss, grads = loss_and_grads(model, shard_params(full, cfg, rank,
                                                         world), grad_batch,
                                     ParallelCtx(group=group, **kw), sync)
        out[name] = {"loss": float(loss), "grads": _numpy(grads),
                     "grad_calls": dict(C.CALLS)}
    return out


def tp_train_families_rank(rank, world, group, device, spec):
    """:func:`tp_train_rank`'s cases for each arch of ``spec["archs"]``
    (its params and batches), and, where ``spec["norm"]`` holds an input
    ``y`` [B, S, D], weights ``w`` [D] and an output gradient ``dy``, the
    gradients of ``models.ssm.group_rms_norm`` on this rank's channels of
    them (its heads' cut)."""
    from repro_torch.models.ssm import group_rms_norm
    out = {arch: _train_cases(ARCHS[arch].reduced(), {**spec, **a}, rank,
                              world, group)
           for arch, a in spec["archs"].items()}
    if spec.get("norm") is not None:
        n = spec["norm"]
        width = n["y"].shape[-1]
        piece = slice(rank * width // world, (rank + 1) * width // world)
        y, w = (torch.from_numpy(np.ascontiguousarray(n[k][..., piece]))
                .requires_grad_() for k in ("y", "w"))
        C.CALLS.clear()
        z = group_rms_norm(y, w, width, ARCHS["rwkv6-7b"].reduced(),
                           ParallelCtx(group=group))
        dy = torch.from_numpy(np.ascontiguousarray(n["dy"][..., piece]))
        gy, gw = torch.autograd.grad(z, (y, w), dy)
        out["norm"] = {"z": z.detach().numpy(), "dy": gy.numpy(),
                       "dw": gw.numpy(), "calls": dict(C.CALLS)}
    return out


def elastic_rank(rank, world, group, device, spec):
    """``spec["steps"]`` steps of the launcher's loop under ``ina`` on this
    rank's shard of the seeded masters, with the ranks' logical
    checkpoints every 2 steps in ``spec["ckpt_dir"]``: a run into an
    empty directory, or one that resumes from what another world wrote.
    Returns the steps run, their losses, and this rank's params (numpy)
    after each step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import initial_state
    from repro_torch.parallel.steps import build_train_step
    from repro_torch.runtime.fault_tolerance import (
        FTConfig, ShardedCheckpointManager, run_training)
    cfg = ARCHS[spec["arch"]].reduced()
    model = get_model(cfg)
    b, s = spec["shape"]
    ts = build_train_step(model, ShapeConfig("t", s, b, "train"),
                          ParallelCtx(group=group), **spec["schedule"])
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=s,
                                    global_batch=b))
    ft = FTConfig(ckpt_dir=spec["ckpt_dir"], ckpt_every=2, max_step_retries=0)
    mgr = ShardedCheckpointManager(ft.ckpt_dir, cfg, group, device,
                                   every=ft.ckpt_every)
    out = {"steps": [], "losses": [], "params": []}

    def step_fn(state, batch):
        params, opt, st = ts.fn(*state, batch)
        out["params"].append(_numpy(params))
        return (params, opt), st

    def on_metrics(step, metrics, dt):
        out["steps"].append(step)
        out["losses"].append(float(metrics["loss"]))
    run_training(step_fn, initial_state(model, device, rank, world),
                 pipe.batch, ft=ft, num_steps=spec["steps"],
                 on_metrics=on_metrics, mgr=mgr)
    return out


# --------------------------------------------------------------------------- #
# the compressed psum (tests/test_torch_compression.py)
# --------------------------------------------------------------------------- #
def compression_rank(rank, world, group, device, spec):
    """``compressed_psum`` of this rank's leaves (``spec["leaves"][name]
    [rank]``, float32 arrays cast to ``spec["dtypes"][name]``) under each
    codec, ``spec["steps"]`` steps with the residuals carried: each step's
    reduced leaves (as float32) with their dtypes, and its residuals."""
    from repro_torch.runtime.compression import (CompressionState,
                                                 compressed_psum)
    grads = {name: torch.from_numpy(np.array(a[rank])).to(
                 DTYPES[spec["dtypes"][name]])
             for name, a in spec["leaves"].items()}
    out = {}
    for codec in spec["codecs"]:
        state, steps = CompressionState.init(grads), []
        for _ in range(spec["steps"]):
            reduced, state = compressed_psum(grads, state, group, codec)
            steps.append({
                "reduced": {k: v.float().numpy() for k, v in reduced.items()},
                "dtypes": {k: str(v.dtype) for k, v in reduced.items()},
                "err": {k: v.numpy() for k, v in state.err.items()},
                "err_dtypes": {k: str(v.dtype) for k, v in state.err.items()}})
        out[codec] = steps
    return out


# --------------------------------------------------------------------------- #
# data-parallel and FSDP training (tests/test_torch_dp_train.py)
# --------------------------------------------------------------------------- #
def dp_train_rank(rank, world, group, device, spec):
    """The reduced model's train step on this rank of the mesh
    ``spec["mesh"]`` (shape, axes), for each case of ``spec``: the global
    batch's loss and this rank's gradient pieces on ``spec["grad_batch"]``
    (the step fed this rank's rows), then two AdamW steps from the same
    weights, each step's loss, grad_norm, lr and collective calls by kind,
    and the params and AdamW moments after them (this rank's pieces); and
    the rank's mesh coordinates.  With ``spec["archs"]`` (each arch's
    params and batches) it runs the cases of each arch, keyed by arch."""
    from repro_torch.launch.mesh import RankMesh
    ranks = RankMesh(*spec["mesh"])
    if "archs" in spec:
        return {arch: _dp_cases(ranks, rank, {**spec, **a, "arch": arch})
                for arch, a in spec["archs"].items()}
    return _dp_cases(ranks, rank, spec)


@contextlib.contextmanager
def _gathers():
    """``{"calls": [bytes each FSDP all-gather made whole, in order],
    "peak": the most gathered bytes alive at once}`` over the block."""
    from repro_torch.parallel import fsdp
    out, real = {"calls": []}, fsdp._all_gather

    def logged(pieces, dims, group):
        whole = real(pieces, dims, group)
        out["calls"].append(sum(t.numel() * t.element_size() for t in whole))
        return whole
    gc.collect()
    fsdp.reset_gathered()
    base = fsdp.GATHERED["live"]
    fsdp._all_gather = logged
    try:
        yield out
    finally:
        fsdp._all_gather = real
        out["peak"] = fsdp.GATHERED["peak"] - base


def _dp_cases(ranks, rank, spec) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.parallel.steps import (build_train_step, data_sync,
                                            loss_and_grads)
    groups, at = ranks.groups(rank), ranks.coords(rank)
    shards = (ranks.span("data"), ranks.span("model"))
    cfg = ARCHS[spec["arch"]].reduced()
    model = get_model(cfg)
    full = params_from_jax(spec["params"], cfg, device="cpu", masters=True)
    grad_batch = _batch(spec["grad_batch"])
    b, s = grad_batch["tokens"].shape
    shape = ShapeConfig("t", s, b, "train")
    out = {"coords": at}
    for name, kw in spec["cases"].items():
        pctx = ParallelCtx(group=groups["model"], data_group=groups["data"],
                           pod_group=groups["pod"], **kw)
        # AdamW updates in place, and a whole leaf is ``full``'s own
        params = tree_map(torch.clone, shard_params(
            full, cfg, (at["data"], at["model"]), shards))
        ts = build_train_step(model, shape, pctx, **spec["schedule"])
        C.CALLS.clear()
        with _gathers() as gathered:
            loss, grads = loss_and_grads(model, params, ts.rows(grad_batch),
                                         pctx, data=data_sync(cfg, pctx))
        res = {"loss": float(loss), "grads": _numpy(grads),
               "grad_calls": dict(C.CALLS), "steps": [],
               "host": (ts.host, ts.hosts), "gathered": gathered}
        opt = adamw_init(params)
        for pair in spec["step_batches"]:
            C.CALLS.clear()
            params, opt, st = ts.fn(params, opt, ts.rows(_batch(pair)))
            res["steps"].append({"loss": float(st["loss"]),
                                 "grad_norm": float(st["grad_norm"]),
                                 "lr": float(st["lr"]),
                                 "calls": dict(C.CALLS)})
        res["params"] = _numpy(params)
        res["m"], res["v"] = _numpy(opt.m), _numpy(opt.v)
        out[name] = res
    return out


# --------------------------------------------------------------------------- #
# serving on the data axis (tests/test_torch_serve_data_*.py)
# --------------------------------------------------------------------------- #
def serve_data_rank(rank, world, group, device, spec):
    """Each arch of ``spec["archs"]`` served through
    ``launch.serve.serve_rank`` on this rank of the mesh ``spec["mesh"]``
    (shape, axes), with ``serve_replicated_params`` off and on: the
    tokens, one row a request, keyed by ``(arch, replicated)``.  An arch's
    ``"params"`` (the reference's, numpy) are its weights, else the
    launcher's seeded ones.  Each ``spec["bound"]`` run (key -> argv) is
    served once more on the seeded weights, keyed by its key."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import RankMesh
    groups = RankMesh(*spec["mesh"]).groups(rank)
    out = {}
    for arch, a in spec["archs"].items():
        params = a.get("params")
        if params is not None:
            params = params_from_jax(params, ARCHS[arch].reduced(),
                                     device="cpu")
        for replicated in (False, True):
            argv = a["argv"] + (["--serve-replicated-params"]
                                if replicated else [])
            out[arch, replicated] = launch_serve.serve_rank(
                rank, world, group, device, argv, params=params,
                groups=groups)
    for key, argv in spec.get("bound", {}).items():
        out[key] = launch_serve.serve_rank(rank, world, group, device, argv,
                                           groups=groups)
    return out


#: The three functions ``core.collectives.psum_with_mode`` runs a psum
#: through, by the mode each runs.
PSUM_BY_MODE = {"ring_psum_eject_inject": "eject_inject",
                "psum_ina": "ina_ring", "psum_xla": "ina"}


def plans_across(across: dict):
    """``plan.plan_for_launch`` as a launcher calls it, but building over
    chips where its ``plan_dir`` is a key of ``across`` (directory ->
    ``build_plan`` keywords, ``{"chips", "package"}``)."""
    from repro_torch.plan import plan_for_launch

    def planned(*args, plan_dir=None, **kw):
        return plan_for_launch(*args, plan_dir=plan_dir, **kw,
                               **across.get(str(plan_dir), {}))
    return planned


def planned_serve_rank(rank, world, group, device, spec):
    """Each case of ``spec["cases"]`` (label -> argv) served through
    ``launch.serve.serve_rank`` on this rank, with the plans of
    ``spec["across"]``'s directories built over chips
    (:func:`plans_across`): its tokens, ``core.collectives.CALLS``, and its
    psums counted by ``(phase, nbytes, resolved, ran)``: the phase of the
    plan the ``auto`` site resolved through (None: no plan), the payload,
    the mode ``resolve_auto_mode`` gave (None: no ``auto`` resolution) and
    the mode the psum ran (:data:`PSUM_BY_MODE`)."""
    from repro_torch.launch import serve as launch_serve
    out = {}
    saved = {name: getattr(C, name)
             for name in (*PSUM_BY_MODE, "resolve_auto_mode")}
    launch_serve.plan_for_launch = plans_across(spec["across"])
    for label, argv in spec["cases"].items():
        pending, ran = [], {}

        def resolving(op, p, nbytes, plan=None):
            mode = saved["resolve_auto_mode"](op, p, nbytes, plan)
            if op == "psum":
                phase = plan.phase.split("-")[0] if plan is not None \
                    else None
                pending.append((phase, int(nbytes), mode))
            return mode

        def counted(name):
            def fn(x, *args, **kw):
                site = pending.pop() if pending else (None, C.nbytes(x),
                                                      None)
                key = (*site, PSUM_BY_MODE[name])
                ran[key] = ran.get(key, 0) + 1
                return saved[name](x, *args, **kw)
            return fn
        C.CALLS.clear()
        try:
            C.resolve_auto_mode = resolving
            for name in PSUM_BY_MODE:
                setattr(C, name, counted(name))
            tokens = launch_serve.serve_rank(rank, world, group, device,
                                             argv)
        finally:
            for name, fn in saved.items():
                setattr(C, name, fn)
        out[label] = {"tokens": tokens, "psums": ran,
                      "calls": dict(C.CALLS)}
    return out
