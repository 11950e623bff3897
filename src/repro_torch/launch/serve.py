"""Serving driver (counterpart of ``repro.launch.serve``).

The default path seats every prompt through the engine
(:mod:`repro_torch.serve.engine`): chunked batched prefill, then per-slot
paged decode.  ``--legacy-loop`` keeps the pre-engine behaviour (one batch,
one decode step per prompt token) as the reference the engine's tokens are
held against.  Both run on the GPU unless ``--device cpu`` is given.

Examples (one H100, at the published widths):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --slots 2 --prompt-len 128 --gen 32 --prefill-chunk 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --batch 4 --slots 2 --prompt-len 64 --gen 16
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import _device
from repro_torch.configs import ARCHS
from repro_torch.models.api import get_model
from repro_torch.parallel.steps import build_serve_step
from repro_torch.parallel.tp import PSUM_MODES, ParallelCtx


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests (legacy: batch rows)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--psum-mode", default="ina", choices=PSUM_MODES,
                    help="one rank: only 'ina' until the multi-rank slice")
    # engine path
    ap.add_argument("--slots", type=int, default=None,
                    help="continuous-batching slots (default: --batch)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="tokens per batched prefill chunk; no effect for a "
                         "family without a batched prefill (ssm), whose "
                         "prompts are seated token by token")
    ap.add_argument("--no-batched-prefill", action="store_true",
                    help="prefill via the per-token decode loop")
    ap.add_argument("--check", action="store_true",
                    help="verify paged==monolithic cache on every retire")
    ap.add_argument("--legacy-loop", action="store_true",
                    help="pre-engine path: one batch, per-token prefill")
    return ap


def make_prompts(cfg, batch: int, prompt_len: int) -> torch.Tensor:
    """The seeded prompt block both paths share (CPU generator, seed 7)."""
    gen = torch.Generator().manual_seed(7)
    return torch.randint(3, cfg.vocab, (batch, prompt_len), generator=gen)


def _params(args, cfg, params):
    """The caller's weights, or random ones from a generator seeded with 0."""
    if params is not None:
        return params
    return get_model(cfg).init(device=_device.resolve(args.device))


def run_engine(args, cfg, params=None):
    """Serve ``--batch`` requests through the engine; returns its report."""
    from repro_torch.serve.batching import Request
    from repro_torch.serve.engine import ServingEngine

    max_seq = args.prompt_len + args.gen + 1
    slots = args.slots or args.batch
    block = args.block_size
    if max_seq % block:
        block = 1 << max(0, (max_seq & -max_seq).bit_length() - 1)
        block = min(block, args.block_size)
        print(f"[serve] block size {args.block_size} does not divide "
              f"max_seq {max_seq}; using {block}")
    engine = ServingEngine(
        cfg, params=_params(args, cfg, params), device=args.device,
        slots=slots, max_seq=max_seq, block_size=block,
        prefill_chunk=args.prefill_chunk, psum_mode=args.psum_mode,
        batched_prefill=not args.no_batched_prefill, check=args.check)

    prompts = make_prompts(cfg, args.batch, args.prompt_len)
    requests = [
        Request(rid=f"req{i}", prompt_len=args.prompt_len,
                max_new=args.gen + 1, prompt=tuple(prompts[i].tolist()))
        for i in range(args.batch)]

    t0 = time.perf_counter()
    report = engine.run(requests)
    dt = time.perf_counter() - t0
    total = sum(len(r["tokens"]) for r in report.requests)
    print(f"[serve] engine: {args.batch} requests on {slots} slots, "
          f"{report.iterations} iterations ({report.prefill_chunks} prefill "
          f"chunks, {report.decode_steps} decode steps), {total} tokens in "
          f"{dt * 1e3:.1f} ms ({total / dt:.1f} tok/s); prefill "
          f"{report.prefill_ms:.1f} ms, decode {report.decode_ms:.1f} ms")
    by_rid = report.tokens()
    print(f"[serve] sample req0: {by_rid['req0']}")
    for rid, toks in by_rid.items():
        if not all(0 <= t < cfg.vocab for t in toks):
            raise RuntimeError(f"{rid}: token out of the vocabulary")
    return report


def run_legacy(args, cfg, params=None) -> dict:
    """The pre-engine loop: one fixed batch, per-token prefill steps.

    Returns the tokens [B, gen+1] (the first generated token, then ``gen``
    greedy continuations), each step's top-2 logit margin [B, gen+1], and
    the first-token logits [B, V]."""
    model = get_model(cfg)
    dev = _device.resolve(args.device)
    params = _params(args, cfg, params)
    step = build_serve_step(model, ParallelCtx(psum_mode=args.psum_mode))
    max_seq = args.prompt_len + args.gen
    cache = model.init_cache(args.batch, max_seq, device=dev)
    prompts = make_prompts(cfg, args.batch, args.prompt_len).to(dev)

    def margin(logits):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        return top2[:, 0] - top2[:, 1]

    # prefill token-by-token through the serve step (keeps one artifact)
    t0 = time.perf_counter()
    for pos in range(args.prompt_len):
        nxt, cache, logits = step.fn(
            params, {"tokens": prompts[:, pos:pos + 1], "pos": pos}, cache)
    tokens, margins, first_logits = [nxt], [margin(logits)], logits
    nxt.tolist()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    print(f"[serve] prefill {args.prompt_len} steps {prefill_ms:.1f} ms")

    t0 = time.perf_counter()
    for i in range(args.gen):
        nxt, cache, logits = step.fn(
            params, {"tokens": nxt[:, None], "pos": args.prompt_len + i},
            cache)
        tokens.append(nxt)
        margins.append(margin(logits))
    out = torch.stack(tokens, dim=1).cpu()
    dt = time.perf_counter() - t0
    print(f"[serve] generated {args.gen} x {args.batch} tokens in "
          f"{dt * 1e3:.1f} ms ({args.gen * args.batch / dt:.1f} tok/s)")
    print(f"[serve] sample row: {out[0].tolist()}")
    if out.shape != (args.batch, args.gen + 1) or not (
            bool((out >= 0).all()) and bool((out < cfg.vocab).all())):
        raise RuntimeError(f"bad legacy output {tuple(out.shape)}")
    return {"tokens": out, "margins": torch.stack(margins, dim=1).cpu(),
            "first_logits": first_logits, "prefill_ms": prefill_ms,
            "decode_ms": dt * 1e3}


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if args.legacy_loop:
        run_legacy(args, cfg)
    else:
        run_engine(args, cfg)


if __name__ == "__main__":
    main()
