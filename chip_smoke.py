#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the process exits non-zero:

1. device check: a CUDA device, its name and power limit, TF32 off;
2. both hand-written CUDA kernels built from ``src/repro_torch/kernels/csrc``
   and held against their plain PyTorch versions at the shapes and dtypes
   that phases 3 (bf16) and 4 (float32) give them, each timed beside its
   bound, its plain version and one library call;
3. qwen2-1.5b at its published widths (bf16, seeded random weights) served
   through the port's ``ServingEngine``: 4 requests on 2 slots, prompt 128,
   32 generated tokens, prefill chunk 64.  The kernels' launch counters must
   equal the expected counts, and the engine must agree with the legacy
   per-token loop on the same weights;
4. the same at 2 layers in float32: the engine's tokens must equal the
   legacy loop's, token for token;
5. a ``kernels`` JSON line, then the device JSON line, last.

It needs the checkout's ``src/`` beside it and exits non-zero without a GPU.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ina_matmul as im  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.parallel.steps import build_paged_serve_step  # noqa: E402

# H100 SXM, dense, at the full 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # f32: no TF32

ARCH = "qwen2-1.5b"
SERVE_ARGV = ["--arch", ARCH, "--batch", "4", "--slots", "2",
              "--prompt-len", "128", "--gen", "32", "--prefill-chunk", "64"]
MATMULS_PER_PASS = 7    # wq wk wv wo w_up w_gate w_down, per layer
L2_FLUSH_BYTES = 128 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# phase 1
# --------------------------------------------------------------------------- #
def device_check() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no port sources under {SRC}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmul and cuDNN: float32 products are "
        "full float32")
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    log(f"[device] {dev['kind']} x{dev['count']}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return {"device": dev, "smi": smi}


# --------------------------------------------------------------------------- #
# phase 2
# --------------------------------------------------------------------------- #
class Timer:
    """Median time of ``fn`` over launches that each find the L2 cold,
    as a decode step finds the weights."""

    def __init__(self):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: int, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Tolerances, elementwise |kernel - plain| <= atol + rtol * |plain|.
# bf16: both sides round an f32 sum of the same terms (summed in another
# order) to bf16 once, so they may land on neighbouring bf16 values: one
# ulp, 2^-7 relative at most.  f32: the sums differ only in order.
TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -8), torch.float32: (1e-5, 1e-5)}


def compare(got, want, dtype) -> dict:
    rtol, atol = TOL[dtype]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    rel = float((diff / want.abs().clamp_min(atol)).max())
    return {"max_abs_err": float(diff.max()), "max_rel_err": rel,
            "rtol": rtol, "atol": atol, "ok": ok}


def matmul_cases():
    cfg = ARCHS[ARCH]
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.resolved_head_dim
    cases = []
    # bf16: the serve phase; f32: the exact-f32 phase (same widths, same M)
    for dt, tag in ((torch.bfloat16, ""), (torch.float32, " f32")):
        for m in (64, 2):
            cases += [(f"wq/wo{tag} M={m}", m, d, d, "row", dt),
                      (f"wk/wv{tag} M={m}", m, d, kv, "row", dt),
                      (f"w_up/w_gate{tag} M={m}", m, d, f, "row", dt),
                      (f"w_down{tag} M={m}", m, f, d, "row", dt),
                      (f"tied head{tag} M={m}", m, d, cfg.vocab, "tied", dt)]
    cases += [("ragged M=3 N=200", 3, d, 200, "row", torch.bfloat16),
              # K and N off the 8-element grid: element-by-element loads
              ("odd K=1001 N=201", 3, 1001, 201, "row", torch.bfloat16),
              ("odd tied K=1001", 3, 1001, 77, "tied", torch.bfloat16)]
    return cases


def check_matmul(timer, gen) -> list:
    rows = []
    for name, m, k, n, kind, dt in matmul_cases():
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        w = (torch.randn(k, n, generator=gen, device="cuda")
             / math.sqrt(k)).to(dt) if kind == "row" else \
            (torch.randn(n, k, generator=gen, device="cuda")
             / math.sqrt(k)).to(dt).T                  # embed.T, in place
        got = im.ina_matmul(x, w)
        torch.cuda.synchronize()
        row = {"case": name, "shape": f"[{m},{k}]x[{k},{n}]",
               "dtype": str(dt).removeprefix("torch."),
               **compare(got, im.ina_matmul_plain(x, w), dt)}
        elt = x.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            (m * k + k * n + m * n) * elt, 2.0 * m * n * k, dt)
        row["ms"] = timer(lambda: im.ina_matmul(x, w))
        row["plain_ms"] = timer(lambda: im.ina_matmul_plain(x, w))
        row["library_ms"] = timer(lambda: torch.matmul(x, w))
        log(f"[kernels] ina_matmul {name:22s} {row['shape']:24s} "
            f"{row['dtype']:8s} max_abs_err {row['max_abs_err']:.3g} "
            f"max_rel_err {row['max_rel_err']:.3g} (rtol {row['rtol']:.3g}, "
            f"atol {row['atol']:.3g}) {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, torch.matmul {row['library_ms']:.4f} ms")
        if not row["ok"]:
            raise AssertionError(f"ina_matmul {name} disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


ATTN_CASES = [  # (name, Sq, Sk, q_offset, dtype): BH = 12 heads, D = 128
    ("prefill chunk 1", 64, 64, 0, torch.bfloat16),
    ("prefill chunk 2", 64, 128, 64, torch.bfloat16),
    ("square 256", 256, 256, 0, torch.bfloat16),
    ("offset 128", 64, 192, 128, torch.bfloat16),
    ("ragged Sk", 64, 100, 36, torch.bfloat16),
    # the exact-f32 phase's two prefill chunks
    ("prefill chunk 1 f32", 64, 64, 0, torch.float32),
    ("prefill chunk 2 f32", 64, 128, 64, torch.float32)]


def check_attention(timer, gen) -> list:
    cfg = ARCHS[ARCH]
    bh, d = cfg.n_heads, cfg.resolved_head_dim
    rows = []
    for name, sq, sk, off, dt in ATTN_CASES:
        q = torch.randn(bh, sq, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(bh, sk, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(bh, sk, d, generator=gen, device="cuda").to(dt)
        got = fa.flash_attention(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        row = {"case": name, "shape": f"BH={bh} Sq={sq} Sk={sk} D={d} "
                                      f"q_offset={off}",
               "dtype": str(dt).removeprefix("torch."),
               **compare(got, fa.flash_attention_plain(q, k, v, q_offset=off),
                         dt)}
        pairs = sum(min(sk, off + i + 1) for i in range(sq))
        row["bound_ms"], row["bound_by"] = bound(
            bh * (2 * sq + 2 * sk) * d * q.element_size(),
            4.0 * bh * d * pairs, dt)
        mask = (torch.arange(sq, device="cuda")[:, None] + off
                >= torch.arange(sk, device="cuda")[None, :])
        row["ms"] = timer(lambda: fa.flash_attention(q, k, v, q_offset=off))
        row["plain_ms"] = timer(
            lambda: fa.flash_attention_plain(q, k, v, q_offset=off))
        # sdpa's is_causal is anchored top-left, the same function only
        # where q_offset is 0 and Sq == Sk; elsewhere it takes the mask
        row["library_masked_ms"] = timer(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        row["library_ms"] = timer(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)) \
            if off == 0 and sq == sk else row["library_masked_ms"]
        log(f"[kernels] flash_attention {name:19s} {row['shape']:40s} "
            f"{row['dtype']:8s} max_abs_err {row['max_abs_err']:.3g} "
            f"max_rel_err {row['max_rel_err']:.3g} (rtol {row['rtol']:.3g}, "
            f"atol {row['atol']:.3g}) {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
            f"(with the mask {row['library_masked_ms']:.4f} ms)")
        if not row["ok"]:
            raise AssertionError(f"flash_attention {name} disagrees with its "
                                 f"plain version: {row}")
        rows.append(row)
    return rows


# --------------------------------------------------------------------------- #
# phases 3 and 4
# --------------------------------------------------------------------------- #
def reset_launches() -> None:
    im.launches = 0
    fa.launches = 0


def serve(cfg, params, phase: str):
    """Engine run (launches counted) and legacy loop on the same weights."""
    args = launch_serve.build_parser().parse_args(SERVE_ARGV)
    reset_launches()
    report = launch_serve.run_engine(args, cfg, params)
    torch.cuda.synchronize()
    launches = {"ina_matmul": im.launches, "flash_attention": fa.launches}
    passes = report.prefill_chunks + report.decode_steps
    expect = {"ina_matmul": (MATMULS_PER_PASS * cfg.n_layers + 1) * passes,
              "flash_attention": cfg.n_layers * report.prefill_chunks}
    total = sum(len(r["tokens"]) for r in report.requests)
    secs = (report.prefill_ms + report.decode_ms) / 1e3
    log(f"[{phase}] {total} tokens, {total / secs:.1f} tok/s; prefill "
        f"{report.prefill_ms:.1f} ms ({report.prefill_chunks} chunks), decode "
        f"{report.decode_ms:.1f} ms ({report.decode_steps} steps); launches "
        f"{launches}, expected {expect}")
    if launches != expect or min(launches.values()) <= 0:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    legacy = launch_serve.run_legacy(args, cfg, params)
    return report, legacy, launches


def phase_serve_bf16() -> dict:
    cfg = ARCHS[ARCH]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = get_model(cfg).init(gen, device="cuda")
    nparams = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{nparams / 1e9:.3f} B parameters in {cfg.dtype}")
    report, legacy, launches = serve(cfg, params, "serve")
    phase_profile(cfg, params)
    # Tolerance for the bf16 comparison with the legacy loop: the two paths
    # differ in attention arithmetic (flash kernel with bf16 p over the
    # prefix, against grouped plain attention per token), each rounding to
    # bf16 once per op, and the difference runs through 28 residual layers.
    # 2^-5 of the largest logit is 4 to 8 bf16 ulps there; a wrong kernel
    # moves logits by the order of the logits themselves.
    scale = float(legacy["first_logits"].float().abs().max())
    tol = 2.0 ** -5 * scale
    worst, near_ties = 0.0, 0
    for r in report.requests:
        i = int(r["rid"].removeprefix("req"))
        diff = float((r["first_logits"].float()
                      - legacy["first_logits"][i].float()).abs().max())
        worst = max(worst, diff)
        if diff > tol:
            raise AssertionError(f"{r['rid']}: first-token logits differ by "
                                 f"{diff} > {tol}")
        for t, (a, b) in enumerate(zip(r["tokens"],
                                       legacy["tokens"][i].tolist())):
            if a == b:
                continue
            margin = float(legacy["margins"][i, t])
            if margin >= tol:
                raise AssertionError(
                    f"{r['rid']} step {t}: engine token {a} != loop token {b} "
                    f"with the loop's top-2 margin {margin} >= {tol}")
            near_ties += 1
            break          # the continuations now condition on other tokens
    log(f"[serve] engine vs legacy loop: first-token logits max |diff| "
        f"{worst:.4g} <= tol {tol:.4g} (2^-5 x max|logit| {scale:.4g}); "
        f"greedy tokens equal except {near_ties} step(s) where the loop's "
        f"top-2 margin < tol")
    del params
    torch.cuda.empty_cache()
    return launches


def profile_step(label: str, fn, steps: int = 5) -> dict:
    """Where one step's time goes: its wall time on the host clock (no
    profiler), and its kernels' device time by name from a torch.profiler
    trace of the same steps.  The busy share is device time over wall."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    trace = _build.BUILD_DIR.parent / f"trace_{label}.json"
    prof.export_chrome_trace(str(trace))
    kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    dev = {"ina_matmul": 0.0, "flash_attention": 0.0, "other": 0.0}
    for e in kernels:
        key = next((k for k in ("ina_matmul", "flash_attention")
                    if k in e["name"]), "other")
        dev[key] += e["dur"] / 1e3 / steps
    busy = sum(dev.values())
    out = {"wall_ms": wall, "device_ms": busy, "kernels_per_step":
           len(kernels) / steps, **{f"{k}_ms": v for k, v in dev.items()}}
    log(f"[profile] {label}: wall {wall:.2f} ms/step (host clock), device "
        f"kernels {busy:.2f} ms/step = busy share {busy / wall:.3f} "
        f"(ina_matmul {dev['ina_matmul']:.2f}, flash_attention "
        f"{dev['flash_attention']:.2f}, other {dev['other']:.2f} ms; "
        f"{len(kernels) / steps:.0f} kernels/step)")
    return out


def phase_profile(cfg, params) -> None:
    """One paged decode step of 2 slots, and one 64-token prefill chunk at
    position 64, at the serve phase's shapes."""
    model = get_model(cfg)
    step = build_paged_serve_step(model)
    cache = model.init_cache(2, 161, device="cuda")
    batch = {"tokens": torch.full((2, 1), 11, device="cuda"),
             "pos": torch.tensor([128, 140], device="cuda")}
    profile_step("decode", lambda: step.fn(params, batch, cache)[0].tolist())
    pcache = model.init_cache(1, 192, device="cuda")
    toks = torch.full((1, 64), 11, device="cuda")
    profile_step("prefill", lambda: model.prefill(
        params, {"tokens": toks}, pcache, pos_offset=64)[0])


def phase_exact_f32() -> None:
    cfg = dataclasses.replace(ARCHS[ARCH], n_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = get_model(cfg).init(gen, device="cuda")
    report, legacy, _ = serve(cfg, params, "exact-f32")
    for r in report.requests:
        i = int(r["rid"].removeprefix("req"))
        if r["tokens"] != legacy["tokens"][i].tolist():
            raise AssertionError(f"{r['rid']}: f32 engine tokens {r['tokens']}"
                                 f" != legacy {legacy['tokens'][i].tolist()}")
    log(f"[exact-f32] 2 layers, full width, float32: engine tokens equal the "
        f"legacy loop's for all {len(report.requests)} requests")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# --------------------------------------------------------------------------- #
def kernel_entry(name, source, replaces, rows, case, launches, smi) -> dict:
    row = next(r for r in rows if r["case"] == case)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "device": smi, "cases": rows}


def main() -> int:
    info = device_check()
    logs = _build.build(["ina_matmul", "flash_attention"])
    for name, text in logs.items():
        used = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}.cu: " + " | ".join(used))
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    mm_rows = check_matmul(timer, gen)
    at_rows = check_attention(timer, gen)
    del timer
    launches = phase_serve_bf16()
    phase_exact_f32()
    kernels = [
        kernel_entry("ina_matmul", "src/repro_torch/kernels/csrc/ina_matmul.cu",
                     "src/repro/kernels/ina_matmul.py:57", mm_rows,
                     "w_up/w_gate M=2", launches["ina_matmul"], info["smi"]),
        kernel_entry("flash_attention",
                     "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:78", at_rows,
                     "prefill chunk 2", launches["flash_attention"],
                     info["smi"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": info["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
