#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the process exits non-zero:

1. device check: a CUDA device, its name and power limit, TF32 off;
2. the three hand-written CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` (one nvcc each, all started together)
   and held against their plain PyTorch versions: first ``ina_matmul`` on
   one small case per regime, tile, layout and cluster size (1 and 2) and
   ``flash_attention`` on one small case per dtype, head dim (16 to 160)
   and tile, causal and not, then every kernel at the shapes and dtypes
   that phases 3-16 give it, and
   ``ina_matmul`` at each tile of phase 4b's decode plan, forced (for
   ``flash_attention`` also in the model's layout, GQA read in place from
   a KV cache slice; for ``wkv6`` also at decays past the model's clip
   floor, one of them held to the step-by-step ``wkv6_ref`` as well; for
   ``ina_matmul`` also the train steps' products: qwen2-1.5b's forward at
   M = 4096, dX with w^T read in place, dW with K = 4096, and phase 18's
   rwkv6-7b and deepseek-v2-lite at 2048 tokens; for ``wkv6`` also the
   train step's B 2 x S 1024), and at every shape one rank
   of a 2- or 4-rank rwkv6-7b, deepseek-v2-lite or llama4-scout launches
   (the cut products at forward and decode M, ``wkv6`` at H 32 and 16,
   llama4's flash at 20:4 and 10:2), each timed beside its bound, its
   plain version and one library call where one computes the same
   function;
3. qwen2-1.5b at its published widths (bf16, seeded random weights) served
   through the port's ``ServingEngine``: 4 requests on 2 slots, prompt 128,
   32 generated tokens, prefill chunk 64.  The kernels' launch counters must
   equal the expected counts, no matmul may take the generic (non-TMA)
   path, and the engine must agree with the legacy per-token loop on the
   same weights;
4. ``[tp]``: qwen2-1.5b served again at full width and depth through
   tensor parallelism, a ``torch.distributed`` NCCL group of W = min(card
   count, 4) ranks, one process each, under every ``--psum-mode``.  At
   W = 1 the tokens must equal phase 3's bit for bit and the decode step and
   prefill chunk under ``ina`` and ``auto`` (at one rank every mode runs the
   same code) must launch as many kernels as phase 3's; each ``auto``
   site's resolution is printed, with a decode step's host time under
   ``auto`` beside ``ina`` and a cold cost-model resolution's host time at
   2, 4 and 8 ranks.  At W >= 2 every mode is profiled, every collective is
   held against the rank sum on CUDA tensors, one psum a mode is timed at
   the decode and prefill row-linear payloads beside its bytes a link, and
   the tokens must match phase 3's within its engine-against-loop margin.
   At W = 1 the launcher's serve (``serve_rank``, ``--ranks 1``) also runs
   on the one-rank group as the model and the data group, under
   ``serve_replicated_params`` off and on (printed as ``[serve] --ranks
   1`` lines): its tokens and launches must be phase 3's and ``ina``'s;
4b. ``[plan]``: qwen2-1.5b's decode and prefill ExecutionPlans for phase
    3's shapes at the mesh ``(("model", 1),)``, built cold into a fresh
    store under ``build/``, then loaded warm (no collective simulation),
    each free of ``verify_plan`` findings, with its key, build seconds,
    collective simulations, tiles and mapper verdicts printed; phase 3's
    requests served again under ``--psum-mode auto`` through those plans:
    tokens equal to phase 3's bit for bit, ``ina_matmul`` launches by
    regime equal to phase 3's, and the plan's tile hits and misses counted
    for one decode step, one prefill chunk and the whole run; a decode
    step's host wall planless and planned in 20 alternating turns (median
    and quartiles of each, and whether every planned turn read no worse
    than the planless turn beside it); then the
    three phase plans at the reference's ``(("data", 16), ("model", 16))``
    mesh on the host, cold and warm, their psum decisions equal to
    :data:`PLAN_16X16` (the reference's, held on the CPU by
    ``tests/test_torch_plan.py``); the same three plans with the model
    axis over 4 chips of the NoC model's package hierarchy, under the
    ``mesh`` and the ``express`` package (keys ``__c4`` and ``__c4e``),
    cold and warm, equal to :data:`PLAN_16X16_C4`; the mapper over
    qwen2-1.5b's decoder GEMMs at 2 tokens with chips 1, 2 and 4 under
    each package, its winner verified (``debug=True``) and equal to
    :data:`MAPPER_CHIPS`; each psum mode's lowering of the decode site
    through ``run_program(verify=True)``, its cycles the plan's; and
    ``verify_hier_schedule`` clean over the 32 hierarchical schedules of
    :data:`HIER_GRIDS`;
4c. ``[capacity]``: the capacity planner, ``python -m repro_torch.serve``
    (``main``), for qwen2-1.5b at full width, one replica an 8 x 8 mesh,
    200 requests at 0.1 qps, ``--search-fleet`` for p99 admission queueing
    at most 30 s, its plans in phase 4b's store, once under ``--semantics
    ina`` and once under ``eject_inject``, each fleet answer printed (in
    the NoC model's seconds); each run's engine demo (the reduced config
    on the card, 6 requests, 2 slots, block 8, prefill chunk 4,
    ``check=True``) launches ``ina_matmul`` and ``flash_attention`` as
    often as the code gives (:func:`demo_launches`), its tokens equal
    between the two runs and each new launch shape held against its plain
    version; the calibration ``PlanCostModel`` is for (phase 3's measured
    decode step of 2 slots and prefill chunk of 64, each over the same
    plans' modeled one), and the planner once more with ``--calibration``
    the decode ratio, its answer in the card's seconds; then ``python -m
    repro_torch.experiments --quick`` over every section the port has
    (Tables I-II, Figs 7-12, mesh scaling, hierarchy, mapper, plan,
    serve, faults), no failed plan or serve row, and Figs 7-12 at E 1 and 16
    rounds for AlexNet, VGG-16 and ResNet-50 held to the reference's pins
    (:data:`FIG7_9_PINS`, :data:`FIG10_12_PINS`), their averages printed
    beside the paper's 1.22x latency and 2.16x power;
4d. ``[noc]``: the NoC fault layer and the three executors.  ``python -m
    repro_torch.experiments --quick`` over :data:`NOC_SECTIONS` once under
    each ``--engine`` (heap, compiled, vectorized, auto), each into a fresh
    output directory and window store, every section's JSON equal across
    the four (less :data:`NOC_HOST_FIELDS`), no ``faults_error`` row, the
    faults table and each run's vectorized counters and seconds printed;
    the batched window pass with ``set_array_backend("torch")`` (int64 and
    float64 tensors on the card) over the window keys of one quick AlexNet
    mapper search, every store entry it writes bit for bit the numpy
    backend's and the heap engine's, with both backends' seconds; and every
    program of the quick faulted corpora (``analysis.corpus``) clean under
    ``verify_faulted`` and equal (latency, ledger, ``done``,
    ``delivered``) under the heap, compiled and vectorized engines where
    the program allows each;
5. phase 3's serve at 2 layers in float32: the engine's tokens must equal
   the legacy loop's, token for token;
6. rwkv6-7b at its published widths, depth cut to 24 of 32 layers
   (:data:`RWKV_DEPTH`, to keep the run under 1000 s) (bf16, seeded
   random weights): one forward pass through ``build_prefill`` at B 2, S
   2048 (24 wkv6 and 193 ina_matmul launches), profiled; the forward against the
   decode loop (which runs no wkv6) on a 300-token prefix; then served
   through the engine, 4 requests on 2 slots, prompt 64, 16 generated, with
   prompts seated token by token (no wkv6), against the legacy loop;
7. the same widths at 2 layers in float32: forward against the decode loop
   within rtol = atol = 1e-4, and engine tokens equal the legacy loop's;
8. ``[train]``: qwen2-1.5b at its published widths, 8 of its 28 layers
   (to keep the whole run under 900 s), trained
   through ``launch.train`` (float32 masters, bf16 compute, seeded
   weights, the port's token pipeline): 8 AdamW steps at B 4 x S 1024,
   warmup 2, a checkpoint at step 4 into a temporary directory, then a
   second run into it.  Every step must launch the derived 227
   ``ina_matmul`` (none generic) and 16 ``flash_attention``, every loss
   be finite and the last below the first, and the second run resume at
   step 5 with step 5's loss equal to the first run's; one step is
   profiled (device time by kernel, inside the attention backward and
   AdamW, tokens/s, peak memory).  Then one step from the resumed state
   and batch under each remat policy, ``nothing``, ``dots_nb`` and
   ``dots`` (:func:`policy_steps`): each policy's loss, ``grad_norm`` and
   every param bit-equal to ``nothing``'s, its launches the derived ones
   (171 ``ina_matmul`` under both, 16 and 8 flash), and a ``[train]
   policy`` line a policy with its device ms, busy share and peak memory;
8a. ``[dryrun]``: ``[train]``'s step (8 layers, B 4 x S 1024, one rank,
    ``nothing``), a prefill (B 4 x S 1024) and a decode step (B 4, a
    cache of 1024) of the same model traced on ``meta`` by the dry-run
    (``launch.dryrun.trace_step``) and then run on the card: the predicted
    launches by kernel equal the card's counters exactly; the predicted
    argument bytes are within 0.5% of the device memory the step's state
    takes (``memory_allocated`` after the state is built, less before);
    the train step's and the prefill's predicted temp bytes within 10% of
    the card's peak above the step's start (the ratios are printed); the
    decode step's predicted bytes at least its weights'; the
    step's predicted FLOPs over ``[train]``'s profiled device ms against
    989 TFLOP/s bf16, with the card's name and power limit;
8b. ``[tp-train]``: the same model through the tensor-parallel train step
    on a one-rank NCCL group (the card count bounds the group), under
    every ``--psum-mode``: 2 steps from ``[train]``'s seed on its first
    batches, each bit-equal to the step without a group (losses, grad
    norms, every param leaf), with 227 ``ina_matmul`` (none generic) and
    16 ``flash_attention`` launches a step and no collective call; then
    ``[train]``'s step-4 checkpoint restored through ``elastic_restore``
    at world 1, bit-equal to the ``CheckpointManager`` restore, and cut
    for every rank of worlds 2 and 4, which ``unshard_state`` rejoins
    bit for bit; each check timed, the peak memory printed;
8c. ``[dp-train]``: the same model through the train step on the rank
    mesh at ``(data 1, model 1)`` (``launch.mesh.make_host_mesh`` over the
    one card), a one-rank NCCL group standing for the model, data and pod
    axes: 2 steps from ``[train]``'s seed on its first batches, losses,
    grad norms and every param leaf bit-equal to the step without a group,
    227 ``ina_matmul`` (none generic) and 16 ``flash_attention`` launches
    a step, no collective call; ``compressed_psum`` of the step's whole
    gradient tree over the group under ``none``, ``int8`` and ``topk``,
    each timed with its peak memory and its largest error against the
    gradient, one leaf bit-equal to the same function on the CPU; and the
    launcher's ``--production-mesh`` refused short of 256 ranks;
9. ``[train-f32]``: the same widths at 2 layers in float32, one step's
   loss and every gradient leaf through the kernels against the same step
   through their plain versions on the card;
10. ``[mla]``: deepseek-v2-lite-16b at its published widths (MLA, 64
    routed top-6 + 2 shared experts, one dense layer; bf16, seeded random
    weights), depth cut to 18 of 27 layers (:data:`MLA_DEPTH`, to keep
    the run under 1000 s), served through the engine, 4 requests on 2
    slots, prompt 64, 16 generated, prompts seated token by token, against
    the legacy loop of 4 rows within 2^-3 of the largest logit, then
    against the loop run alone, one request at B 1 on the engine's cache
    length: first-token logits and every token equal to the bit, with the
    (position, layer) pairs whose top-6 experts differ at 4 rows counted;
    launches equal the derived 145 ``ina_matmul`` a pass
    (none generic); one paged decode step profiled beside its bound (the
    weights it reads), with the expert products' device time; one B 1 x S
    2048 forward through ``build_prefill`` (MLA's ``attn_chunked`` past its
    chunk of 1024), profiled, with its dropped share of expert assignments;
11. ``[mla-f32]``: the same widths at 2 layers in float32: the S 2048
    forward through the kernels against their plain versions on the card
    within rtol = atol = 1e-4, the forward against the decode loop on an
    8-token prefix (capacity 8: no drop), engine tokens equal the legacy
    loop's;
12. ``[moe]``: llama4-scout-17b-16e at its published widths, depth cut to
    4 of 48 layers: one B 1 x S 2048 forward (``flash_attention`` at GQA
    40:8, D 128, once a layer), a decode step profiled, and 2 requests on 2
    slots, prompt 16, 8 generated, against the legacy loop;
13. ``[hybrid]``: zamba2-2.7b as published (54 Mamba2 layers, the shared
    attention block 9 times at head dim 160; bf16, seeded random weights,
    nothing cut): one B 1 x S 2048 forward (190 ``ina_matmul``, 9
    ``flash_attention``), 4 requests on 2 slots, prompt 32, 15 generated,
    prompts seated token by token, against the legacy loop within 2^-3 of
    the largest logit; the forward and a paged decode step profiled;
14. ``[hybrid-f32]``: the same widths at 2 groups (12 Mamba2 layers) in
    float32: the S 300 forward through the kernels against their plain
    versions on the card within rtol = atol = 1e-4, and against the decode
    loop at every position within the same bound, greedy tokens equal;
15. ``[vlm]``: llama-3.2-vision-11b as published (32 self and 8 gated
    cross-attention layers; the gates set to 0.5, since the reference's 0
    would cut the media off): one B 1 x S 2048 forward over 1601 media
    rows (281 ``ina_matmul``, 40 ``flash_attention``, the cross layers'
    non-causal at GQA 32:8), the legacy loop (2 rows, prompt 16, 8
    generated; ``prefill_media_kv`` first) with its launches derived, its
    logits after the prompt against the forward's over the same prompts
    within 2^-3 of the largest;
16. ``[encdec]``: whisper-medium as published (24 encoder layers over 1500
    frames, 24 decoder layers, the tied head over 51865 tokens): one
    forward of 448 tokens (385 ``ina_matmul``, 72 ``flash_attention``),
    the legacy loop (2 rows, prompt 8, 8 generated, the encoder again at
    every step) checked as ``[vlm]``'s.  Phases 13-16 also check that each
    shape they launched a kernel at was held against its plain version in
    phase 2, and print their peak memory;
17. ``[tp-families]``: rwkv6-7b and deepseek-v2-lite at their published
    widths, depth cut to 4 and 2 layers (to keep the whole run under
    900 s; phases 6 and 10 run them at 16 and 9),
    and llama4-scout at ``[moe]``'s 4 layers, each served
    (2 requests on 2 slots) without a group and then through
    ``launch/serve.py``'s ``serve_rank`` on a one-rank NCCL group under
    every psum mode, one process: the tensor-parallel code (expert-parallel
    MoE combine, RWKV6 heads and MLA heads cut, at one rank all of them)
    must give the groupless tokens bit for bit and the same kernel launches,
    the derived counts, at shapes phase 2 checked;
18. ``[train-families]``: rwkv6-7b and deepseek-v2-lite (2 layers
    each), zamba2-2.7b (12 of 54 layers: 2
    groups), llama-3.2-vision-11b (5 of 40: one group, gates 0.5) and
    whisper-medium (whole) at their published widths, depth cut so that
    16 bytes a parameter fit the card (:data:`TRAIN_FAMILIES`), trained
    through ``launch.train`` (float32 masters, bf16 compute, seeded
    weights, media of ones for the vlm and whisper): 4 AdamW steps at B 2
    x S 1024 (whisper B 4 x S 448 over 1500 frames), warmup 1, every
    step's launches the derived counts (a layer's or group's products
    once more in its recompute, ``wkv6`` and flash forward and
    recomputed, none in their backwards), a falling loss; for rwkv6-7b,
    deepseek and zamba2 a checkpoint at step 2 and a second run resuming
    at step 3 with run 1's loss to the bit; one step profiled (inside the
    ``wkv6`` and attention backwards, the expert products, MLA's
    attention and AdamW), its launch shapes each held in phase 2; one
    step under every psum mode on a one-rank NCCL group, bit-equal to the
    groupless step, no collective call; and one step under each of the
    ``dots_nb`` and ``dots`` remat policies, bit-equal to the groupless
    step, with the policy's launches (:func:`train_launches`);
19. ``[train-families-f32]``: the same five in float32 at the smallest
    depth each runs (2 layers; zamba2's group of 6, the vlm's of 5,
    whisper's 2 + 2): one step's loss and every gradient leaf through the
    kernels against their plain versions on the card, as phase 9;
20. a ``kernels`` JSON line, then the device JSON line, last.

It needs the checkout's ``src/`` beside it and exits non-zero without a GPU.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint.ckpt import (CheckpointManager,  # noqa: E402
                                         latest_step)
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.analysis import (verify_collective,  # noqa: E402
                                  verify_faulted, verify_hier_schedule,
                                  verify_plan)
from repro_torch.analysis import corpus as noc_corpus  # noqa: E402
from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.core.noc import SIM_CACHE, fresh_sim_cache  # noqa: E402
from repro_torch.core.noc import NocConfig  # noqa: E402
from repro_torch.core.noc import power as noc_power  # noqa: E402
from repro_torch.core.noc import hierarchy as noc_hier  # noqa: E402
from repro_torch.core.noc import traffic as noc_traffic  # noqa: E402
from repro_torch.core.noc import vectorized as noc_vec  # noqa: E402
from repro_torch.core.noc.compiled import UncompilableProgram  # noqa: E402
from repro_torch.core.noc.collective import cost as noc_cost  # noqa: E402
from repro_torch.core.noc.collective import schedule as noc_sched  # noqa: E402
from repro_torch.core.noc.collective.engine import run_program  # noqa: E402
from repro_torch.core.noc.collective.trees import mesh_row  # noqa: E402
from repro_torch.core.workloads import WORKLOADS  # noqa: E402
from repro_torch.core.workloads import mapper_workloads  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.experiments import __main__ as experiments  # noqa: E402
from repro_torch.experiments import report as noc_report  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ina_matmul as im  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.mapper import QUICK_MAPPER, search_network  # noqa: E402
from repro_torch.mapper import search as mapper_search  # noqa: E402
from repro_torch.launch.kernel_times import (TP_WORLDS,  # noqa: E402
                                             FAMILY_TRAIN_B,
                                             FAMILY_TRAIN_S,
                                             FAMILY_TRAIN_TOKENS,
                                             WHISPER_TRAIN_B,
                                             WHISPER_TRAIN_S,
                                             Timer, attention_cases,
                                             attention_operands,
                                             family_projections,
                                             matmul_layout,
                                             matmul_operands,
                                             matmul_projections,
                                             media_train_products,
                                             moe_projections,
                                             rank_projections,
                                             train_products, wkv_cases,
                                             wkv_operands)
from repro_torch.models import mla as mla_model  # noqa: E402
from repro_torch.models import moe as moe_model  # noqa: E402
from repro_torch.models import vision  # noqa: E402
from repro_torch.models import remat  # noqa: E402
from repro_torch.models.api import (MEDIA_FAMILIES,  # noqa: E402
                                    get_model, media_ones)
from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: E402
                                     tree_leaves)
from repro_torch.parallel.sharding import (kv_groups,  # noqa: E402
                                           shard_params, shard_state,
                                           unshard_state)
from repro_torch.parallel.steps import (build_paged_serve_step,  # noqa: E402
                                        build_prefill, build_serve_step,
                                        build_train_step, loss_and_grads)
from repro_torch.runtime import compression  # noqa: E402
from repro_torch.parallel.tp import ParallelCtx  # noqa: E402
from repro_torch.plan import PHASES, PlanStore, tile_choices  # noqa: E402
from repro_torch.runtime.fault_tolerance import elastic_restore  # noqa: E402
from repro_torch.serve import __main__ as planner  # noqa: E402
from repro_torch.serve.costs import (SEMANTICS,  # noqa: E402
                                     PlanCostModel, serve_plans)

# H100 SXM, dense, at the full 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # f32: no TF32

ARCH = "qwen2-1.5b"
RWKV = "rwkv6-7b"
MLA = "deepseek-v2-lite-16b"
MOE = "llama4-scout-17b-16e"
HYBRID = "zamba2-2.7b"
VLM = "llama-3.2-vision-11b"
ENCDEC = "whisper-medium"
SERVE_ARGV = {
    ARCH: ["--arch", ARCH, "--batch", "4", "--slots", "2", "--prompt-len",
           "128", "--gen", "32", "--prefill-chunk", "64"],
    RWKV: ["--arch", RWKV, "--batch", "4", "--slots", "2", "--prompt-len",
           "64", "--gen", "16"],
    MLA: ["--arch", MLA, "--batch", "4", "--slots", "2", "--prompt-len",
          "64", "--gen", "16"],
    MOE: ["--arch", MOE, "--batch", "2", "--slots", "2", "--prompt-len",
          "16", "--gen", "8"],
    HYBRID: ["--arch", HYBRID, "--batch", "4", "--slots", "2",
             "--prompt-len", "32", "--gen", "15"],
    # the media families serve through the legacy loop (one batch)
    VLM: ["--arch", VLM, "--batch", "2", "--prompt-len", "16", "--gen", "8"],
    ENCDEC: ["--arch", ENCDEC, "--batch", "2", "--prompt-len", "8", "--gen",
             "8"]}
# per layer and pass: dense wq wk wv wo w_up w_gate w_down; ssm the time
# mix's wr wk wv wg wo and the channel mix's wk wv wr (the decay's LoRA is
# torch.matmul).  Plus one for the head.
MATMULS_PER_PASS = {"dense": 7, "ssm": 8}


def matmuls_per_pass(cfg, media_cached: bool = False) -> int:
    """``ina_matmul`` launches of one pass (a decode step or a forward),
    derived from the code.  dense and ssm: :data:`MATMULS_PER_PASS` a
    layer.  moe and mla_moe: the attention's projections (GQA wq wk wv wo;
    MLA wq w_dkv w_uk w_uv wo), then a dense layer's SwiGLU (w_up w_gate
    w_down), or an MoE layer's shared experts, one SwiGLU of 3 products
    where the config has any: the router is torch.matmul and the routed
    experts torch.bmm.  hybrid: a Mamba2 layer's w_in and w_out, and for
    each group the shared block's wq wk wv wo, wo_down, w_up w_gate w_down
    and mlp_down.  vlm: 7 a self layer as dense; a cross layer's wq wo and
    SwiGLU, and its wk wv over the media unless ``media_cached`` (a decode
    step reads their K/V from the cache).  encdec: an encoder layer's wq
    wk wv wo w_up w_down, a decoder layer's self and cross wq wk wv wo and
    w_up w_down (a decode step encodes the media again).  Plus one for the
    head."""
    if cfg.family in MATMULS_PER_PASS:
        return MATMULS_PER_PASS[cfg.family] * cfg.n_layers + 1
    if cfg.family == "hybrid":
        return 9 * (cfg.n_layers // cfg.shared_attn_every) \
            + 2 * cfg.n_layers + 1
    if cfg.family == "vlm":
        g = cfg.n_layers // cfg.cross_attn_every
        return 7 * (cfg.n_layers - g) + (5 if media_cached else 7) * g + 1
    if cfg.family == "encdec":
        return 6 * cfg.encoder_layers + 10 * cfg.n_layers + 1
    attn = 5 if cfg.family == "mla_moe" else 4
    nd = cfg.moe.first_dense_layers
    shared = 3 if cfg.moe.num_shared else 0
    return nd * (attn + 3) + (cfg.n_layers - nd) * (attn + shared) + 1


def flash_per_pass(cfg, decode: bool = False) -> int:
    """``flash_attention`` launches of one pass, derived from the code:
    attention over more than one query.  A forward: once a layer (dense,
    moe, vlm's self and cross layers), once a group's shared block
    (hybrid), the encoder's, the decoder's and its cross-attention's
    (encdec), never for MLA or RWKV6.  A decode step (one query): none,
    but the encoder's over the frames (encdec)."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + (0 if decode else 2 * cfg.n_layers)
    if decode or cfg.family in ("mla_moe", "ssm"):
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


RWKV_FWD_B, RWKV_FWD_S, RWKV_PREFIX = 2, 2048, 300
# the MoE families' forward (B 1 x S 2048: MLA's attn_chunked runs past its
# attn_chunk 1024); llama4-scout's depth, cut from 48 to fit one card
MOE_FWD_S, MOE_DEPTH = 2048, 4
# [rwkv]'s and [mla]'s depths: 24 of rwkv6-7b's 32 layers and 18 of
# deepseek-v2-lite's 27 (its dense layer and 17 MoE layers), cut to keep
# the whole run under 1000 s (it took 1082.5 s at 32 and 27 on an H100);
# the widths, and so every kernel shape, are the published ones
RWKV_DEPTH, MLA_DEPTH = 24, 18
# [tp-families]: each tensor-parallel family's requests, served six times
# (without a group, then under each psum mode), so fewer than its serve
# phase's for rwkv6-7b, deepseek-v2-lite, zamba2 (engine), vlm and whisper
# (legacy loop, 2 rows); llama4-scout at [moe]'s depth
TP_FAMILY_ARGV = {
    RWKV: ["--arch", RWKV, "--batch", "2", "--slots", "2", "--prompt-len",
           "8", "--gen", "4", "--layers", "4"],
    MLA: ["--arch", MLA, "--batch", "2", "--slots", "2", "--prompt-len",
          "8", "--gen", "4", "--layers", "2"],
    MOE: SERVE_ARGV[MOE] + ["--layers", str(MOE_DEPTH)],
    HYBRID: ["--arch", HYBRID, "--batch", "2", "--slots", "2",
             "--prompt-len", "8", "--gen", "4"],
    VLM: ["--arch", VLM, "--batch", "2", "--prompt-len", "8", "--gen", "4"],
    ENCDEC: ["--arch", ENCDEC, "--batch", "2", "--prompt-len", "8", "--gen",
             "4"]}
# zamba2 and llama-3.2-vision's forwards, B 1 x S 2048; whisper's at its
# decoder context, 448 tokens, over its 1500 frames; [hybrid-f32]: 2 groups
# (12 Mamba2 layers) over 300 tokens, past the SSD's chunk of 256
FAMILY_FWD_S = {HYBRID: 2048, VLM: 2048, ENCDEC: 448}
HYBRID_F32_S, HYBRID_F32_GROUPS = 300, 2
# The reference's mesh for qwen2-1.5b's plans, and the psum decisions of
# each phase there: (p, nbytes, mode, ops, count, ((mode, latency cycles,
# energy pJ), ...)).  The reference's resolve_sites gives these on the CPU
# (tests/test_torch_plan.py holds them to it), with count 2, one a row
# linear of its scanned layer body; the port's loop records each of the 28
# layers', so 56.
MESH_16 = (("data", 16), ("model", 16))
_PREFILL_COSTS = (("ina", 402653350, 57901528110.8),
                  ("ina_ring", 377487472, 60085925889.600006),
                  ("eject_inject", 6039798067, 196897408335.0))
PLAN_16X16 = {
    "train": ((16, 3221225472, "ina_ring", ("psum",), 56, _PREFILL_COSTS),),
    "prefill": ((16, 3221225472, "ina_ring", ("psum",), 56, _PREFILL_COSTS),),
    "decode": ((16, 393216, "ina_ring", ("psum",), 56,
                (("ina", 49318, 7068309.2), ("ina_ring", 46192, 7339214.4),
                 ("eject_inject", 737587, 24036687.0))),)}
# The same plans with the model axis split over 4 chips (the NoC model's
# package hierarchy), keyed (package, phase): the reference's
# resolve_sites(..., chips=4, package=...), held by tests/test_torch_plan.py.
PLAN_CHIPS = 4
_C4_COSTS = {
    "mesh": (("ina", 805306478, 72074920354.0),
             ("ina_ring", 704643169, 73323145544.0),
             ("eject_inject", 2415919256, 109924320140.99998)),
    "express": (("ina", 1409286224, 76504105444.0),
                ("ina_ring", 1409286224, 76504105444.0),
                ("eject_inject", 2415919208, 107025217201.19998))}
_C4_MODE = {"mesh": "ina_ring", "express": "ina"}
PLAN_16X16_C4 = {
    **{(pk, phase): ((16, 3221225472, _C4_MODE[pk], ("psum",), 56,
                      _C4_COSTS[pk]),)
       for pk in _C4_COSTS for phase in ("train", "prefill")},
    ("mesh", "decode"): ((16, 393216, "ina_ring", ("psum",), 56,
                          (("ina", 98414, 8798626.0),
                           ("ina_ring", 86113, 8951316.8),
                           ("eject_inject", 295064, 13419405.0))),),
    ("express", "decode"): ((16, 393216, "ina", ("psum",), 56,
                             (("ina", 172112, 9339364.0),
                              ("ina_ring", 172112, 9339364.0),
                              ("eject_inject", 295016,
                               13065495.600000001))),)}
# The mapper over qwen2-1.5b's decoder GEMMs at 2 tokens with the package
# axis (chips 1, 2 and 4), under each package, debug=True: the winner's
# hardware, latency cycles and energy pJ (the reference's search_network,
# held by tests/test_torch_hierarchy.py).
MAPPER_CHIPS_LIST = (1, 2, 4)
MAPPER_CHIPS = {"mesh": ((8, 4, 2, 2), 5780.0, 3746739.2),
                "express": ((8, 4, 2, 2), 5780.0, 3746739.2)}
# The package grids of the hierarchy corpus [plan] verifies (each x both
# packages x every op, semantics and allreduce algorithm: 32 schedules).
HIER_GRIDS = ((2, 1), (2, 2))
# [capacity]: the capacity planner (python -m repro_torch.serve) for
# qwen2-1.5b at full width on an 8 x 8 mesh a replica, 200 requests at 0.1
# qps, the fewest replicas whose p99 admission queueing is at most 30 s
CAPACITY_ARGV = ["--arch", ARCH, "--mesh", "8x8", "--requests", "200",
                 "--qps", "0.1", "--search-fleet", "--slo-metric",
                 "queueing_s", "--slo-p99-ms", "30000"]
# the paper's evaluation, as python -m repro_torch.experiments --quick runs
# it (every section the port has)
EXPERIMENT_SECTIONS = ("tables,fig7_9,fig10_12,mesh_scaling,hierarchy,"
                       "mapper,plan,serve,faults")
# [noc]: the sections each --engine runs (every one but plan and serve,
# whose model traces and cluster runs no executor changes), the engines, and
# the JSON fields left out of their comparison: wall clock, and the
# mapper's window-store lookups, which the batched prefetch and the heap
# engine's bypass of the layer memo change by design (the reference's
# engines differ in them too)
NOC_SECTIONS = "tables,fig7_9,fig10_12,mesh_scaling,hierarchy,mapper,faults"
NOC_ENGINES = ("heap", "compiled", "vectorized", "auto")
NOC_HOST_FIELDS = ("elapsed_us", "sim_hits", "sim_misses")
# [noc]: the mapper search whose window keys the batched pass on the card
# prices (the quick space, as the experiments' mapper section searches it)
NOC_MAPPER_WORKLOAD = "alexnet"
# Figs 7-9 (WS+INA over WS) and 10-12 (WS+INA over OS) at E 1, 16 rounds:
# (latency_x, power_x, energy_x) a network, the pins of the reference's
# tests/test_experiments.py (held to rel 1e-9), and the paper's headline
FIG7_9_PINS = {
    "alexnet": (1.3174422192115254, 1.5607175433789333, 2.056155183911502),
    "vgg16": (1.7419385086187669, 1.1141116323217497, 1.9407139552413686),
    "resnet50": (1.1205548873901459, 1.095398960338809, 1.227454658649737)}
FIG10_12_PINS = {
    "alexnet": (1.092087802270031, 1.718684924481257, 1.876954841971371),
    "vgg16": (1.445953875070858, 1.111861273869205, 1.607700117492398),
    "resnet50": (0.7179804315656954, 1.853857557221294, 1.33103344899507)}
PAPER_HEADLINE = {"fig7_9": (1.22, 2.16), "fig10_12": (1.19, 2.16)}


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
def bound(nbytes: int, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Tolerances, elementwise |kernel - plain| <= atol + rtol * |plain|.
# bf16: both sides round an f32 sum of the same terms (summed in another
# order) to bf16 once, so they may land on neighbouring bf16 values: one
# ulp, 2^-7 relative at most.  f32: the sums differ only in order.
TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -8), torch.float32: (1e-5, 1e-5)}


def compare(got, want, dtype, tol=None) -> dict:
    rtol, atol = tol or TOL[dtype]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    rel = float((diff / want.abs().clamp_min(atol)).max())
    return {"max_abs_err": float(diff.max()), "max_rel_err": rel,
            "rtol": rtol, "atol": atol, "ok": ok}


def serve_cache(argv) -> int:
    """Positions of the engine's working cache for a serve phase's
    ``argv``: the prompt, the generated tokens and one more."""
    args = launch_serve.build_parser().parse_args(argv)
    return args.prompt_len + args.gen + 1


def matmul_cases():
    proj = matmul_projections() + moe_projections()
    cases = []
    # qwen2-1.5b, bf16: the serve phase (prefill chunk 64, 2 decode slots,
    # M = 1 and 4 beside them); f32: the exact-f32 phase (same widths, same M)
    for dt, tag in ((torch.bfloat16, ""), (torch.float32, " f32")):
        for m in ((64, 4, 2, 1) if dt == torch.bfloat16 else (64, 2)):
            cases += [(f"{name}{tag} M={m}", m, k, n, kind, dt)
                      for model, name, k, n, kind in proj if model == ARCH]
    d = ARCHS[ARCH].d_model
    cases += [("ragged M=3 N=200", 3, d, 200, "row", torch.bfloat16),
              # K and N off the 8-element grid: element-by-element loads
              ("odd K=1001 N=201", 3, 1001, 201, "row", torch.bfloat16),
              ("odd tied K=1001", 3, 1001, 77, "tied", torch.bfloat16)]
    # rwkv6-7b: the forward (M = B*S), the paged decode (M = 2 slots), and
    # the exact-f32 phase's forward (M = 300) and decode
    for m, dt, tag in ((RWKV_FWD_B * RWKV_FWD_S, torch.bfloat16, "fwd"),
                       (4, torch.bfloat16, "decode"),
                       (2, torch.bfloat16, "decode"),
                       (1, torch.bfloat16, "decode"),
                       (RWKV_PREFIX, torch.float32, "f32 fwd"),
                       (2, torch.float32, "f32 decode")):
        cases += [(f"rwkv {tag} {name} M={m}", m, k, n, kind, dt)
                  for model, name, k, n, kind in proj if model == RWKV]
    # deepseek-v2-lite and llama4-scout: the forward (M = 2048), a prompt
    # seated token by token at B 1 (M = 1, most of a serve's passes) and
    # the paged decode of 2 slots.  MLA's decode expands the whole cached
    # latent through w_uk/w_uv: M = 1 x the cache seating, 2 x the cache
    # decoding.  [mla-f32] serves the same widths in f32 at the same M (its
    # S 2048 forward is held to the plain versions whole).
    cache = serve_cache(SERVE_ARGV[MLA])
    for model, tag, dt, ms in (
            (MLA, "mla", torch.bfloat16, (MOE_FWD_S, 1, 2)),
            (MOE, "moe", torch.bfloat16, (MOE_FWD_S, 1, 2)),
            (MLA, "mla f32", torch.float32, (1, 2))):
        for m in ms:
            what = {MOE_FWD_S: "fwd", 1: "seat", 2: "decode"}[m]
            cases += [(f"{tag} {what} {name} M={m}", m, k, n, kind, dt)
                      for mod, name, k, n, kind in proj if mod == model
                      and (what == "fwd" or name != "w_uk/w_uv")]
        if model == MLA:
            cases += [(f"{tag} {what} {name} M={m}", m, k, n, kind, dt)
                      for what, m in (("seat", cache), ("decode", 2 * cache))
                      for mod, name, k, n, kind in proj
                      if mod == MLA and name == "w_uk/w_uv"]
    # the hybrid, vlm and encdec phases, each M the path gives a product:
    # zamba2's forward (M 2048), engine seating (1) and decode (2), legacy
    # loop (4 rows), [hybrid-f32]'s forward (300) and decode loop (1);
    # llama-3.2-vision's forward (2048; wk/wv over the 1601 media rows),
    # legacy decode (2 rows; prefill_media_kv over 2 x 1601) and the
    # prompts' forward (2 x 16); whisper's forward (the encoder at 1500
    # frames, the decoder at 448), legacy decode (2 rows, the encoder
    # again at 2 x 1500) and the prompts' forward (2 x 8)
    hb = legacy_rows(SERVE_ARGV[HYBRID])[0]
    vb, vp = legacy_rows(SERVE_ARGV[VLM])
    wb, wp = legacy_rows(SERVE_ARGV[ENCDEC])
    vm, wf = ARCHS[VLM].num_media_tokens, ARCHS[ENCDEC].num_media_tokens
    bf16, f32 = torch.bfloat16, torch.float32
    enc_names = ("wq/wk/wv/wo", "w_up", "w_down")
    family = {}     # one case a shape (zamba2's w_out is wo_down's)
    for model, tag, dt, ms, names in (
            (HYBRID, "zamba2", bf16, (FAMILY_FWD_S[HYBRID], hb, 2, 1), None),
            (HYBRID, "zamba2 f32", f32, (HYBRID_F32_S, 1), None),
            (VLM, "vlm", bf16, (FAMILY_FWD_S[VLM], vb, vb * vp), None),
            (VLM, "vlm media", bf16, (vm, vb * vm), ("wk/wv",)),
            (ENCDEC, "whisper", bf16,
             (wf, wb * wf, FAMILY_FWD_S[ENCDEC], wb, wb * wp), enc_names),
            (ENCDEC, "whisper", bf16, (FAMILY_FWD_S[ENCDEC], wb, wb * wp),
             ("tied head",))):
        for mod, name, k, n, kind in family_projections():
            if mod == model and (names is None or name in names):
                for m in ms:
                    family.setdefault((m, k, n, kind, dt),
                                      f"{tag} {name} M={m}")
    cases += [(name, *key) for key, name in family.items()]
    # one rank's products at worlds 2 and 4, what --model-parallel 2 and 4
    # launch on each rank (one card runs no such world): each family's
    # forward M and its 2 decode slots (or rows), MLA's w_uk/w_uv at the
    # forward and at the decode's 2 x cache; zamba2's seating at B 1 too,
    # vlm's wk/wv over the forward's 1601 media rows, whisper's products
    # at the encoder's 1500 frames and the decoder's 448 tokens; then
    # [tp-families]' deepseek serve, whose w_uk/w_uv expand its shorter
    # cache
    fwd_m = {RWKV: (RWKV_FWD_B * RWKV_FWD_S,), MLA: (MOE_FWD_S,),
             MOE: (MOE_FWD_S,), HYBRID: (FAMILY_FWD_S[HYBRID], 1),
             VLM: (FAMILY_FWD_S[VLM],), ENCDEC: (wf, FAMILY_FWD_S[ENCDEC])}
    for p in TP_WORLDS:
        for model, name, k, n, kind in rank_projections(p):
            ms = (*fwd_m[model], 2 * cache if name.startswith("w_uk") else 2)
            if model == VLM and name.startswith("wk/wv"):
                ms += (vm,)
            cases += [(f"{model} {name} M={m}", m, k, n, kind, bf16)
                      for m in ms]
    tcache = serve_cache(TP_FAMILY_ARGV[MLA])
    cases += [(f"tp-families mla {what} {name} M={m}", m, k, n, kind, bf16)
              for what, m in (("seat", tcache), ("decode", 2 * tcache))
              for mod, name, k, n, kind in proj
              if mod == MLA and name == "w_uk/w_uv"]
    return cases


def legacy_rows(argv) -> tuple[int, int]:
    """(rows, prompt length) of a legacy serve phase's ``argv``."""
    args = launch_serve.build_parser().parse_args(argv)
    return args.batch, args.prompt_len


# One small case per regime, tile, w layout and cluster size, run before
# the full shapes so that a wrong shared-memory descriptor, swizzle or
# cluster reduction fails here, fast and by name: (m, k, n, tile_m, tile_n).
SMALL_TILES = [(64, 128, 64, 64, 128), (128, 128, 256, 128, 128),
               (128, 128, 256, 128, 256), (2, 128, 64, 8, 64),
               (16, 128, 64, 16, 64)]


def check_matmul_small(gen) -> None:
    for m, k, n, tm, tn in SMALL_TILES:
        for kind in ("row", "tied"):
            for c in (1, 2):
                x, w = matmul_operands(gen, m, k, n, kind, torch.bfloat16)
                plan = im.plan_for(x, w)._replace(tile_m=tm, tile_n=tn,
                                                  cluster=c)
                got = im.ina_matmul(x, w, plan)
                torch.cuda.synchronize()
                res = compare(got, im.ina_matmul_plain(x, w, plan),
                              torch.bfloat16)
                log(f"[kernels] ina_matmul small [{m},{k}]x[{k},{n}] {kind} "
                    f"{plan.regime} {tm}x{tn} c={c}: max_abs_err "
                    f"{res['max_abs_err']:.3g}")
                if not res["ok"]:
                    raise AssertionError(f"ina_matmul small case [{m},{k}]x"
                                         f"[{k},{n}] {kind} {plan}: {res}")


#: each trained family's tag in phase 2's case names, and its train
#: step's token rows in ``[train-families]``
TRAIN_TAGS = {RWKV: ("rwkv", FAMILY_TRAIN_TOKENS),
              MLA: ("mla", FAMILY_TRAIN_TOKENS),
              HYBRID: ("zamba2", FAMILY_TRAIN_TOKENS),
              VLM: ("vlm", FAMILY_TRAIN_TOKENS),
              ENCDEC: ("whisper", WHISPER_TRAIN_B * WHISPER_TRAIN_S)}


def train_matmul_cases():
    """The train steps' distinct products (forward, dX with w^T read in
    place, dW with K = the step's rows), bf16: qwen2-1.5b's at B 4 x S
    1024, then ``[train-families]``' rwkv6-7b, deepseek-v2-lite,
    zamba2-2.7b and llama-3.2-vision-11b at B 2 x S 1024 and
    whisper-medium's decoder at B 4 x S 448, and the products over the
    media (the vlm's ``wk``/``wv`` over 2 x 1601 rows, whisper's encoder
    over 4 x 1500 frames: ``media_train_products``)."""
    bf16 = torch.bfloat16
    cases = [(f"train {name} M={m}", m, k, n, kind, bf16)
             for name, m, k, n, kind in train_products()]
    for model, (tag, tokens) in TRAIN_TAGS.items():
        cases += [(f"train {tag} {name} M={m}", m, k, n, kind, bf16)
                  for name, m, k, n, kind in train_products(tokens, model)]
    return cases + [(f"train {TRAIN_TAGS[model][0]} {name} M={m}", m, k, n,
                     kind, bf16)
                    for model, name, m, k, n, kind in media_train_products()]


# What phase 2 held against the plain versions, by launch shape
# (:func:`matmul_key`, :func:`attention_key`); the hybrid, vlm and encdec
# phases check that every launch of theirs is among them.
CHECKED = {"ina_matmul": set(), "flash_attention": set()}


def matmul_key(x, w) -> tuple:
    """(M, K, N, w's layout, dtype) of an ``ina_matmul`` launch."""
    return (x.shape[0], x.shape[1], w.shape[1], matmul_layout(w), x.dtype)


def attention_key(q, k, causal, q_offset) -> tuple:
    """(B, Sq, Sk, H, KVH, D, causal, q_offset, dtype) of a
    ``flash_attention`` launch."""
    return (*q.shape[:3], k.shape[1], k.shape[2], q.shape[3], bool(causal),
            int(q_offset), q.dtype)


@contextlib.contextmanager
def record_shapes():
    """The launch shapes (:func:`matmul_key`, :func:`attention_key`) of the
    two kernels' wrappers inside the context, by kernel (``ina_matmul``
    called by the forward's dispatch and by ``InaMatmul``, the train
    step's forward and backward); the launches themselves go on, counted
    as ever.  A ``meta`` call (a plan's trace) launches nothing and is
    not recorded."""
    seen = {"ina_matmul": set(), "flash_attention": set()}
    omm, mm, att = ops.ina_matmul, im.ina_matmul, fa._attention

    def spy(real):
        def mm_spy(x, w, *args, **kw):
            if x.device.type != "meta":
                seen["ina_matmul"].add(matmul_key(x, w))
            return real(x, w, *args, **kw)
        return mm_spy

    def att_spy(q, k, v, causal, q_offset):
        if q.device.type != "meta":
            seen["flash_attention"].add(attention_key(q, k, causal,
                                                      q_offset))
        return att(q, k, v, causal, q_offset)
    ops.ina_matmul, im.ina_matmul, fa._attention = spy(omm), spy(mm), att_spy
    try:
        yield seen
    finally:
        ops.ina_matmul, im.ina_matmul, fa._attention = omm, mm, att


def check_shapes(seen: dict, label: str, where: str = "phase 2") -> None:
    """Every shape ``seen`` (:func:`record_shapes`) was held against the
    kernel's plain version (in phase 2, or ``where`` says where)."""
    missing = {name: sorted(map(str, keys - CHECKED[name]))
               for name, keys in seen.items() if keys - CHECKED[name]}
    if missing:
        raise AssertionError(f"[{label}] launched at shapes {where} did not "
                             f"check: {missing}")
    log(f"[{label}] each of the {len(seen['ina_matmul'])} ina_matmul and "
        f"{len(seen['flash_attention'])} flash_attention launch shapes of "
        f"the phase was held against its plain version in {where}")


def check_matmul(timer, gen, cases) -> list:
    rows = []
    for name, m, k, n, kind, dt in cases:
        x, w = matmul_operands(gen, m, k, n, kind, dt)
        CHECKED["ina_matmul"].add(matmul_key(x, w))
        plan = im.plan_for(x, w)
        got = im.ina_matmul(x, w)
        torch.cuda.synchronize()
        row = {"case": name, "shape": f"[{m},{k}]x[{k},{n}]",
               "dtype": str(dt).removeprefix("torch."),
               "regime": plan.regime, "tile": f"{plan.tile_m}x{plan.tile_n}",
               "cluster": plan.cluster,
               **compare(got, im.ina_matmul_plain(x, w), dt)}
        flops, nbytes = im.cost(m, n, k, x.element_size())
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
        row["ms"] = timer(lambda: im.ina_matmul(x, w))
        row["plain_ms"] = timer(lambda: im.ina_matmul_plain(x, w))
        row["library_ms"] = timer(lambda: torch.matmul(x, w))
        log(f"[kernels] ina_matmul {name:28s} {row['shape']:28s} "
            f"{row['dtype']:8s} {plan.regime} {row['tile']} c={plan.cluster} "
            f"max_abs_err {row['max_abs_err']:.3g} "
            f"max_rel_err {row['max_rel_err']:.3g} (rtol {row['rtol']:.3g}, "
            f"atol {row['atol']:.3g}) {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, torch.matmul {row['library_ms']:.4f} ms"
            f" ({row['ms'] / row['library_ms']:.2f}x, "
            f"{row['bound_ms'] / row['ms']:.1%} of the bound)")
        if not row["ok"]:
            raise AssertionError(f"ina_matmul {name} disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


def plan_serve_args(store: Path):
    """Phase 3's serve under ``--psum-mode auto`` with plans in ``store``."""
    return launch_serve.build_parser().parse_args(
        SERVE_ARGV[ARCH] + ["--psum-mode", "auto", "--plan-dir", str(store)])


def check_planned_tiles(timer, gen) -> list:
    """``ina_matmul`` at each tile of phase 4b's decode plan (the Hopper tile
    policy over qwen2-1.5b's decoder GEMMs at the slots' M), the planned
    launch forced, against its plain version blocked the same way."""
    cfg = ARCHS[ARCH]
    args = launch_serve.build_parser().parse_args(SERVE_ARGV[ARCH])
    rows = []
    for t in tile_choices(cfg, args.slots or args.batch, cfg.dtype):
        x, w = matmul_operands(gen, t.m, t.k, t.n, "row", torch.bfloat16)
        plan = t.matmul_plan
        got = im.ina_matmul(x, w, plan)
        torch.cuda.synchronize()
        row = {"case": f"planned [{t.m},{t.k}]x[{t.k},{t.n}]",
               "shape": f"[{t.m},{t.k}]x[{t.k},{t.n}]", "dtype": t.dtype,
               "regime": t.regime, "tile": f"{t.tile_m}x{t.tile_n}",
               "cluster": t.cluster,
               **compare(got, im.ina_matmul_plain(x, w, plan),
                         torch.bfloat16)}
        row["bound_ms"], row["bound_by"] = bound(
            (t.m * t.k + t.k * t.n + t.m * t.n) * 2, 2.0 * t.m * t.n * t.k,
            torch.bfloat16)
        row["ms"] = timer(lambda: im.ina_matmul(x, w, plan))
        row["plain_ms"] = timer(lambda: im.ina_matmul_plain(x, w, plan))
        row["library_ms"] = timer(lambda: torch.matmul(x, w))
        log(f"[kernels] ina_matmul {row['case']:34s} planned {t.regime} "
            f"{row['tile']} c={t.cluster}: max_abs_err "
            f"{row['max_abs_err']:.3g} (rtol {row['rtol']:.3g}, atol "
            f"{row['atol']:.3g}) {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, torch.matmul {row['library_ms']:.4f}"
            f" ms")
        if not row["ok"]:
            raise AssertionError(f"ina_matmul at the planned tile {t} "
                                 f"disagrees with its plain version: {row}")
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


def check_attention_small(gen) -> None:
    """One small case per dtype and head dim, GQA 2:1, ragged Sq and Sk,
    k/v read from a cache view, run before the timed shapes so that a wrong
    fragment layout, load or mask fails here, fast and by name."""
    cases = [(torch.bfloat16, d, True, 4) for d in (16, 64, 128, 144, 160)] \
        + [(torch.bfloat16, d, False, 4) for d in (64, 160)] \
        + [(torch.float32, d, True, 4) for d in (16, 128, 160)] \
        + [(torch.float32, 64, False, 4)] \
        + [(dt, 128, True, 10) for dt in (torch.bfloat16, torch.float32)]
    for dt, d, causal, h in cases:      # h = 10: GQA 5:1, llama4-scout's
        q, k, v, off = attention_operands(gen, 2, 19, 83, h, 2, d, dt, 100)
        got = fa.flash_attention_heads(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        res = compare(got, fa.flash_attention_heads_plain(
            q, k, v, causal=causal, q_offset=off), dt)
        log(f"[kernels] flash_attention small B=2 Sq=19 Sk=83 H={h} KVH=2 "
            f"D={d} {str(dt).removeprefix('torch.')} causal={causal}: "
            f"max_abs_err {res['max_abs_err']:.3g}")
        if not res["ok"]:
            raise AssertionError(f"flash_attention small case D={d} {dt} "
                                 f"causal={causal}: {res}")


def attention_row(timer, name, q, k, v, off, causal: bool = True) -> dict:
    """The kernel on q [B, Sq, H, D], k/v [B, Sk, KVH, D] (the model's
    layout) against its plain version, timed beside its bound, the plain
    version and sdpa.  sdpa gets [B, H, S, D] copies made outside the
    timer, GQA through ``enable_gqa``; its ``is_causal`` is anchored top
    left, the same function only where q_offset is 0 and Sq == Sk, so
    elsewhere it takes the mask (a non-causal case takes neither).  sdpa
    is a yardstick only, never on the port's path."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dt = q.dtype
    kw = dict(causal=causal, q_offset=off)
    got = fa.flash_attention_heads(q, k, v, **kw)
    torch.cuda.synchronize()
    CHECKED["flash_attention"].add(attention_key(q, k, causal, off))
    plan = fa.plan_attention(b, sq, h, kvh, dt)
    row = {"case": name, "shape": f"B={b} Sq={sq} Sk={sk} H={h} KVH={kvh} "
                                  f"D={d} q_offset={off}"
                                  + ("" if causal else " non-causal"),
           "dtype": str(dt).removeprefix("torch."),
           "ctas": plan.ctas,
           "strides_kv": list(k.stride()),
           **compare(got, fa.flash_attention_heads_plain(q, k, v, **kw), dt)}
    flops, nbytes = fa.cost(b, sq, sk, h, kvh, d, q.element_size(), causal,
                            off)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
    row["ms"] = timer(lambda: fa.flash_attention_heads(q, k, v, **kw))
    row["plain_ms"] = timer(
        lambda: fa.flash_attention_heads_plain(q, k, v, **kw))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gqa = {"enable_gqa": True} if h != kvh else {}
    mask = (torch.arange(sq, device="cuda")[:, None] + off
            >= torch.arange(sk, device="cuda")[None, :])
    if not causal:
        row["library_ms"] = row["library_masked_ms"] = timer(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **gqa))
    else:
        row["library_masked_ms"] = timer(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask, **gqa))
        row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa)) \
            if off == 0 and sq == sk else row["library_masked_ms"]
    if h == kvh == 1:
        # the earlier yardstick of the [BH, S, D] cases: sdpa on the 3-d
        # tensors themselves, which it runs more slowly than [B, H, S, D]
        q3, k3, v3 = q[:, :, 0], k[:, :, 0], v[:, :, 0]
        row["library_3d_ms"] = timer(lambda: F.scaled_dot_product_attention(
            q3, k3, v3, is_causal=True)) if off == 0 and sq == sk else \
            timer(lambda: F.scaled_dot_product_attention(q3, k3, v3,
                                                         attn_mask=mask))
    log(f"[kernels] flash_attention {name:19s} {row['shape']:44s} "
        f"{row['dtype']:8s} {plan.ctas} CTAs max_abs_err "
        f"{row['max_abs_err']:.3g} max_rel_err {row['max_rel_err']:.3g} "
        f"(rtol {row['rtol']:.3g}, atol {row['atol']:.3g}) {row['ms']:.4f} "
        f"ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), plain "
        f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms (with "
        f"the mask {row['library_masked_ms']:.4f} ms; kernel "
        f"{row['ms'] / row['library_ms']:.2f}x sdpa)"
        + (f"; sdpa on [BH, S, D] {row['library_3d_ms']:.4f} ms"
           if "library_3d_ms" in row else ""))
    if not row["ok"]:
        raise AssertionError(f"flash_attention {name} disagrees with its "
                             f"plain version: {row}")
    return row


def check_attention(timer, gen) -> list:
    """The JAX signature's cases ([BH, S, D], one KV head per query head,
    as ``flash_attention`` takes them), then the model's layout
    (:func:`~repro_torch.launch.kernel_times.attention_cases`, the train
    step's)."""
    cfg = ARCHS[ARCH]
    bh, d = cfg.n_heads, cfg.resolved_head_dim
    floor = timer(lambda: torch.cuda._sleep(1))
    log(f"[kernels] the timer's floor, one empty launch: "
        f"{floor * 1e3:.2f} us")
    rows = []
    for name, sq, sk, off, dt in ATTN_CASES:
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(dt)
                   for s in (sq, sk, sk))
        res = fa.flash_attention(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        if not torch.equal(res, fa.flash_attention_heads(
                q[:, :, None], k[:, :, None], v[:, :, None],
                q_offset=off)[:, :, 0]):
            raise AssertionError(f"flash_attention {name}: the two fronts "
                                 f"differ")
        rows.append(attention_row(timer, name, q[:, :, None], k[:, :, None],
                                  v[:, :, None], off))
    for name, b, sq, sk, h, kvh, d, dt, cache, causal in attention_cases():
        q, k, v, off = attention_operands(gen, b, sq, sk, h, kvh, d, dt,
                                          cache, causal)
        rows.append(attention_row(timer, name, q, k, v, off, causal))
    # the train phases' layer attention: q, k and v whole from the
    # projections, [train] B 4 x S 1024 in bf16, [train-f32] in float32
    for name, b, s, dt in (("qwen2 train", 4, 1024, torch.bfloat16),
                           ("qwen2 train f32", TRAIN_F32_B, TRAIN_F32_S,
                            torch.float32)):
        q, k, v, off = attention_operands(gen, b, s, s, cfg.n_heads,
                                          cfg.n_kv_heads, d, dt, s)
        rows.append(attention_row(timer, name, q, k, v, off))
    for name, b, sq, sk, h, kvh, d, causal in train_attention_cases():
        q, k, v, off = attention_operands(gen, b, sq, sk, h, kvh, d,
                                          torch.bfloat16, sk, causal)
        rows.append(attention_row(timer, name, q, k, v, off, causal))
    return rows


def train_attention_cases() -> list:
    """(name, B, Sq, Sk, H, KVH, D, causal) of ``[train-families]``' flash
    launches in bf16 (q, k and v whole from the projections): zamba2's
    shared attention (32 heads of 160, causal) and the vlm's self layers
    (GQA 32:8, causal) at B 2 x S 1024, the vlm's cross-attention over 2 x
    1601 media rows, whisper's encoder over 4 x 1500 frames, its decoder
    at 448 tokens and its cross-attention over the frames."""
    z, v, w = ARCHS[HYBRID], ARCHS[VLM], ARCHS[ENCDEC]
    b, s = FAMILY_TRAIN_B, FAMILY_TRAIN_S
    wb, ws, wf = WHISPER_TRAIN_B, WHISPER_TRAIN_S, w.num_media_tokens
    zh = z.shared_attn_heads
    vh = (v.n_heads, v.n_kv_heads, v.resolved_head_dim)
    wh = (w.n_heads, w.n_kv_heads, w.resolved_head_dim)
    return [("zamba2 train", b, s, s, zh, zh, 2 * z.d_model // zh, True),
            ("vlm train self", b, s, s, *vh, True),
            ("vlm train cross", b, s, v.num_media_tokens, *vh, False),
            ("whisper train encoder", wb, wf, wf, *wh, False),
            ("whisper train decoder", wb, ws, ws, *wh, True),
            ("whisper train cross", wb, ws, wf, *wh, False)]


# |kernel - plain| <= atol + rtol |plain|: float32 outputs at
# tests/test_kernels.py's 1e-4 (sum order over hd and over S differs); bf16
# outputs one bf16 ulp on top, since each side rounds its f32 y once.
WKV_TOL = {torch.float32: (1e-4, 1e-4),
           torch.bfloat16: (1e-4 + 2.0 ** -7, 1e-4 + 2.0 ** -8)}
# the case also held to the step-by-step wkv6_ref, so that a fault the
# kernel and its chunked plain version share cannot hide
WKV_REF_CASE = "steep decay -20"


def check_wkv6(timer, gen) -> list:
    hd = ARCHS[RWKV].ssm.head_dim
    rows = []
    for name, b, s, h, decay, dt in wkv_cases():
        r, k, v, logw, u = wkv_operands(gen, b, s, h, hd, decay, dt)
        got = wk.wkv6_heads(r, k, v, logw, u)
        torch.cuda.synchronize()
        flat = [x.transpose(1, 2).reshape(b * h, s, hd).contiguous()
                for x in (r, k, v, logw)]
        ub = u.repeat(b, 1)

        def heads(y):
            return y.reshape(b, h, s, hd).transpose(1, 2)
        plan = wk.plan_wkv6(b, h, hd)
        row = {"case": name, "shape": f"B={b} S={s} H={h} hd={hd} "
                                      f"decay={decay}",
               "dtype": str(dt).removeprefix("torch."),
               "tiles": f"C={plan.chunk} sub={plan.sub} warps={plan.warps}",
               "ctas": plan.ctas,
               **compare(got, heads(wk.wkv6_plain(*flat, ub)), dt,
                         WKV_TOL[dt])}
        if name == WKV_REF_CASE:
            row["vs_ref"] = compare(got, heads(ref.wkv6_ref(*flat, ub)), dt,
                                    WKV_TOL[dt])
        flops, nbytes = wk.cost(b, s, h, hd, r.element_size())
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, torch.float32)
        row["ms"] = timer(lambda: wk.wkv6_heads(r, k, v, logw, u))
        row["plain_ms"] = timer(lambda: wk.wkv6_plain(*flat, ub), iters=3)
        row["library_ms"] = None      # no single PyTorch call computes WKV6
        log(f"[kernels] wkv6 {name:18s} {row['shape']:40s} {row['dtype']:8s} "
            f"{row['tiles']}, {plan.ctas} CTAs: max_abs_err "
            f"{row['max_abs_err']:.3g} max_rel_err "
            f"{row['max_rel_err']:.3g} (rtol {row['rtol']:.3g}, atol "
            f"{row['atol']:.3g}) {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.2f} ms, library none"
            + (f"; against wkv6_ref max_abs_err "
               f"{row['vs_ref']['max_abs_err']:.3g}" if "vs_ref" in row
               else ""))
        if not row["ok"]:
            raise AssertionError(f"wkv6 {name} disagrees with its plain "
                                 f"version: {row}")
        if not row.get("vs_ref", {"ok": True})["ok"]:
            raise AssertionError(f"wkv6 {name} disagrees with wkv6_ref: "
                                 f"{row['vs_ref']}")
        rows.append(row)
    return rows


# --------------------------------------------------------------------------- #
# phases 3-6
# --------------------------------------------------------------------------- #
def reset_launches() -> None:
    im.launches = 0
    im.launches_by_regime.update(dict.fromkeys(im.launches_by_regime, 0))
    fa.launches = 0
    wk.launches = 0


def read_launches() -> dict:
    return {"ina_matmul": im.launches, "flash_attention": fa.launches,
            "wkv6": wk.launches}


def check_launches(launches: dict, expect: dict, on_path) -> None:
    """Counts equal to the expected ones, every kernel of the path
    launched at least once, and no matmul on the generic (non-TMA) path:
    every operand the model hands the kernel must be one TMA describes."""
    if launches != expect or any(launches[k] <= 0 for k in on_path):
        raise AssertionError(f"launch counts {launches} != expected {expect}"
                             f" (on the path: {on_path})")
    if im.launches_by_regime["generic"] != 0:
        raise AssertionError(f"ina_matmul took the generic path on the main "
                             f"path: {im.launches_by_regime}")


def serve(cfg, params, phase: str, argv):
    """Engine run (launches counted) and legacy loop on the same weights;
    returns (report, legacy, launches, ``ina_matmul`` launches by regime).

    A dense prompt runs as batched prefill chunks, one flash attention per
    layer each; an ssm, moe or mla_moe prompt is seated token by token
    through decode steps (``prefill_chunks`` counts those), which run no
    wkv6 and no flash attention."""
    args = launch_serve.build_parser().parse_args(argv)
    reset_launches()
    report = launch_serve.run_engine(args, cfg, params)
    torch.cuda.synchronize()
    launches = read_launches()
    passes = report.prefill_chunks + report.decode_steps
    dense = cfg.family == "dense"
    expect = {"ina_matmul": matmuls_per_pass(cfg) * passes,
              "flash_attention": cfg.n_layers * report.prefill_chunks
              if dense else 0,
              "wkv6": 0}
    total = sum(len(r["tokens"]) for r in report.requests)
    secs = (report.prefill_ms + report.decode_ms) / 1e3
    log(f"[{phase}] {total} tokens, {total / secs:.1f} tok/s; prefill "
        f"{report.prefill_ms:.1f} ms ({report.prefill_chunks} "
        f"{'chunks' if dense else 'per-token steps'}), decode "
        f"{report.decode_ms:.1f} ms ({report.decode_steps} steps); launches "
        f"{launches}, expected {expect}; ina_matmul by regime "
        f"{im.launches_by_regime}")
    check_launches(launches, expect,
                   ("ina_matmul", "flash_attention") if dense
                   else ("ina_matmul",))
    by_regime = dict(im.launches_by_regime)
    legacy = launch_serve.run_legacy(args, cfg, params)
    return report, legacy, launches, by_regime


def compare_with_legacy(report, legacy, phase: str, n_layers: int,
                        bits: int) -> None:
    """The bf16 engine against the legacy loop on the same weights, within
    ``2^-bits`` of the largest logit (the reason is at each call)."""
    scale = float(legacy["first_logits"].float().abs().max())
    tol = 2.0 ** -bits * scale
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
    log(f"[{phase}] engine vs legacy loop ({n_layers} layers): first-token "
        f"logits max |diff| {worst:.4g} <= tol {tol:.4g} (2^-{bits} x "
        f"max|logit| {scale:.4g}); greedy tokens equal except {near_ties} "
        f"step(s) where the loop's top-2 margin < tol")


def phase_serve_bf16() -> dict:
    cfg = ARCHS[ARCH]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = get_model(cfg).init(gen, device="cuda")
    nparams = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{nparams / 1e9:.3f} B parameters in {cfg.dtype}")
    report, legacy, launches, by_regime = serve(cfg, params, "serve",
                                                   SERVE_ARGV[ARCH])
    profile = phase_profile(cfg, params)
    # The two paths differ in attention arithmetic (the flash kernel with
    # bf16 p over the prefix, against grouped plain attention per token),
    # each rounding to bf16 once per op, and the difference runs through 28
    # residual layers.  2^-5 of the largest logit is 4 to 8 bf16 ulps there;
    # a wrong kernel moves logits by the order of the logits themselves.
    compare_with_legacy(report, legacy, "serve", cfg.n_layers, bits=5)
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "by_regime": by_regime,
            "tokens": report.tokens(), "legacy": legacy, "profile": profile}


def profile_step(label: str, fn, steps: int = 5, spans=()) -> dict:
    """Where one step's time goes: its wall time on the host clock (no
    profiler), and the device time by name of the kernels each step
    launched (:func:`step_kernels`), from a torch.profiler trace of the
    same steps after one profiled warm-up step (the profiler's schedule).
    A trace now and then lacks some records of a step, which can only lower
    its count, so a step's kernel count is the largest over the steps, and
    the device time is averaged over the steps that reached it.  The busy
    share is device time over wall.  For each name in ``spans`` (a
    ``torch.profiler.record_function`` range of the step), the device time
    of the kernels launched inside it (``span_ms``)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    trace = _build.BUILD_DIR.parent / f"trace_{label}.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(trace))
                 ) as prof:
        for i in range(steps + 1):
            fn()
            if i == steps:
                torch.cuda.synchronize()
            prof.step()
    events = json.loads(trace.read_text())["traceEvents"]
    by_step = step_kernels(events)
    per_step = [len(kernels) for kernels in by_step]
    whole = [k for k in by_step if len(k) == max(per_step)]
    names = ("ina_matmul", "flash_attention", "wkv6")
    dev = dict.fromkeys(names + ("other",), 0.0)
    other = collections.Counter()
    for e in (e for kernels in whole for e in kernels):
        key = next((k for k in names if k in e["name"]), "other")
        dev[key] += e["dur"] / 1e3 / len(whole)
        if key == "other":
            other[kernel_family(e["name"])] += e["dur"] / 1e3 / len(whole)
    busy = sum(dev.values())
    span_ms = {}
    for name in spans:
        ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name") == name]
        span_ms[name] = sum(
            e["dur"] for kernels in whole for e in kernels
            if any(lo <= e["launch_ts"] <= hi for lo, hi in ranges)
        ) / 1e3 / len(whole)
    out = {"wall_ms": wall, "device_ms": busy, "kernels_per_step":
           max(per_step), "kernels_by_step": per_step, "span_ms": span_ms,
           "other_top": other.most_common(4),
           **{f"{k}_ms": v for k, v in dev.items()}}
    log(f"[profile] {label}: wall {wall:.2f} ms/step (host clock), device "
        f"kernels {busy:.2f} ms/step = busy share {busy / wall:.3f} ("
        + ", ".join(f"{k} {v:.2f}" for k, v in dev.items())
        + f" ms; {out['kernels_per_step']} kernels/step, the most of the "
        f"steps' {per_step}; device ms over the {len(whole)} steps at it)"
        + "".join(f"; inside {k}: {v:.2f} ms" for k, v in span_ms.items())
        + "; other's largest: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in out["other_top"]))
    return out


def kernel_family(name: str) -> str:
    """A kernel's name without its template arguments and parameters
    (``void at::native::elementwise_kernel<128, 2, ...>(...)`` ->
    ``at::native::elementwise_kernel``), cut to 60 characters."""
    return re.split(r"[<(]", name.removeprefix("void "), maxsplit=1)[0][:60]


def step_kernels(events: list) -> list:
    """The kernel records of each profiled step: each kernel joined to its
    launch call (the same ``correlation``) and given to the step whose
    host range holds the launch.  (A kernel's device time does not place
    it: the device runs behind the host, so a step's last kernels, or the
    warm-up step's, run inside the next step's range.)  A trace now and
    then lacks some records of one step (10-50 of a few thousand)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if str(e.get("name", "")).startswith("ProfilerStep#")
                   and e.get("cat") != "gpu_user_annotation")
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = [[] for _ in spans]
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        for i, (lo, hi) in enumerate(spans):
            if ts is not None and lo <= ts <= hi:
                e["launch_ts"] = ts
                out[i].append(e)
                break
    return out


def phase_profile(cfg, params, pctx=None, tag: str = "",
                  device="cuda") -> dict:
    """One paged decode step of 2 slots, and one 64-token prefill chunk at
    position 64, at the serve phase's shapes (on this rank's shard of a
    ``pctx`` group)."""
    model = get_model(cfg)
    world = 1 if pctx is None else pctx.world
    step = build_paged_serve_step(model, pctx)
    cache = model.init_cache(2, 161, device=device, world=world)
    batch = {"tokens": torch.full((2, 1), 11, device=device),
             "pos": torch.tensor([128, 140], device=device)}
    out = {"decode": profile_step(f"decode{tag}", lambda: step.fn(
        params, batch, cache)[0].tolist())}
    pcache = model.init_cache(1, 192, device=device, world=world)
    toks = torch.full((1, 64), 11, device=device)
    out["prefill"] = profile_step(f"prefill{tag}", lambda: model.prefill(
        params, {"tokens": toks}, pcache, pctx, pos_offset=64)[0])
    return out


# --------------------------------------------------------------------------- #
# phase 4: tensor parallelism
# --------------------------------------------------------------------------- #
# the row-parallel payloads of the serve phase: a decode step of 2 slots and
# a 64-token prefill chunk, qwen2-1.5b's d_model, bf16
TP_PAYLOADS = (((2, 1, 1536), torch.bfloat16), ((1, 64, 1536), torch.bfloat16))
PSUM_MODES = ("ina", "ina_ring", "eject_inject", "xla", "auto")


def tp_collectives(rank: int, world: int, group, device) -> list:
    """Every collective on this rank's tensor of each payload, held against
    the float64 sum of every rank's (each rank draws them all from seeds),
    then one psum a mode timed (host clock over 20, ending on a sync).

    Bound for a sum: each of the P-1 partial sums a reduction rounds to the
    dtype is off by at most one ulp of it (a faithful rounding: gloo's bf16
    sums are not always rounded to nearest), 2^-8 (bf16) or 2^-23 (f32) of
    ``sum_i |x_i|``; the bound takes P of them."""
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rows = []
    for shape, dt in TP_PAYLOADS:
        xs = [torch.randn(shape, generator=torch.Generator().manual_seed(
            100 + r)).to(dt).to(dev) for r in range(world)]
        x = xs[rank]
        total = sum(v.double() for v in xs)
        bound = world * (2.0 ** -8 if dt == torch.bfloat16 else 2.0 ** -23) \
            * sum(v.double().abs() for v in xs)
        axis = x.dim() - 1
        c = shape[axis] // world
        worst = 0.0
        for mode in PSUM_MODES:
            for name, got, want, lim in (
                    ("psum", C.psum_with_mode(x, group, mode, axis), total,
                     bound),
                    ("reduce_scatter",
                     C.reduce_scatter_with_mode(x, group, mode, axis),
                     total.narrow(axis, rank * c, c),
                     bound.narrow(axis, rank * c, c))):
                err = (got.double() - want).abs()
                if got.shape != want.shape or not bool((err <= lim).all()):
                    raise AssertionError(
                        f"[tp] {name} {mode} {shape} rank {rank}: max error "
                        f"{float(err.max())} beyond the rounding bound")
                worst = max(worst, float(err.max()))
        gathered = C.ring_all_gather(x, group, axis)
        if not torch.equal(gathered, torch.cat(xs, axis)):
            raise AssertionError(f"[tp] ring_all_gather {shape} rank {rank}")
        nbytes = x.numel() * x.element_size()
        for mode in PSUM_MODES:
            for _ in range(3):
                C.psum_with_mode(x, group, mode, axis)
            sync()
            torch.distributed.barrier(group)
            t0 = time.perf_counter()
            for _ in range(20):
                C.psum_with_mode(x, group, mode, axis)
            sync()
            ms = (time.perf_counter() - t0) * 1e3 / 20
            rows.append({"shape": list(shape), "dtype": str(dt), "mode": mode,
                         "nbytes": nbytes, "ms": ms, "per_link_bytes":
                         C.per_link_bytes(mode, world, nbytes),
                         "max_abs_err": worst})
    return rows


def tp_rank(rank, world, group, device, argv):
    """One rank of phase 4: the serve phase's weights (the same seeded
    draw) cut to this rank's shard, served under every psum mode, then
    profiled, its auto sites resolved, and at W >= 2 its collectives held
    against the rank sum and timed.  Rank 0 prints; the others' output is
    dropped.  Returns numpy and plain data only."""
    quiet = contextlib.nullcontext() if rank == 0 else \
        contextlib.redirect_stdout(io.StringIO())
    with quiet:
        return _tp_rank(rank, world, group, device, argv)


def data_group_serves(argv, cfg, params, group, device) -> dict:
    """The launcher's serve (``serve_rank``) with ``--ranks 1`` on the
    one-rank group as the model and the data group, under
    ``serve_replicated_params`` off and on: each one's tokens and
    launches."""
    out = {}
    for replicated in (False, True):
        reset_launches()
        tokens = launch_serve.serve_rank(
            0, 1, group, device, argv + ["--ranks", "1"]
            + (["--serve-replicated-params"] if replicated else []),
            params=params, groups={"pod": None, "data": group,
                                   "model": group})
        torch.cuda.synchronize()
        out[replicated] = {"tokens": tokens, "launches": read_launches()}
    return out


def _tp_rank(rank, world, group, device, argv):
    cfg = ARCHS[ARCH]
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    out = {"modes": {}, "profile": {}}
    # one uncounted run first: a new process's first serve pays its start
    # (the kernels' libraries loaded, the first collective)
    launch_serve.run_engine(launch_serve.build_parser().parse_args(
        argv + ["--device", str(device)]), cfg, params, group=group)
    for mode in C.CLI_PSUM_MODES:
        args = launch_serve.build_parser().parse_args(
            argv + ["--psum-mode", mode])
        reset_launches()
        args.device = str(device)
        report = launch_serve.run_engine(args, cfg, params, group=group)
        torch.cuda.synchronize()
        launches = read_launches()
        passes = report.prefill_chunks + report.decode_steps
        expect = {"ina_matmul": (MATMULS_PER_PASS["dense"] * cfg.n_layers + 1)
                  * passes, "flash_attention": cfg.n_layers
                  * report.prefill_chunks, "wkv6": 0}
        total = sum(len(r["tokens"]) for r in report.requests)
        secs = (report.prefill_ms + report.decode_ms) / 1e3
        log(f"[tp] W={world} {mode}: {total} tokens, {total / secs:.1f} tok/s; "
            f"prefill {report.prefill_ms:.1f} ms, decode {report.decode_ms:.1f}"
            f" ms; launches {launches}, expected {expect}")
        check_launches(launches, expect, ("ina_matmul", "flash_attention"))
        out["modes"][mode] = {
            "tokens": report.tokens(), "launches": launches,
            "tok_s": total / secs,
            "first_logits": {r["rid"]: r["first_logits"].float().cpu().numpy()
                             for r in report.requests}}
    if world == 1:
        out["data"] = data_group_serves(argv, cfg, params, group, device)
    shard = shard_params(params, cfg, rank, world)
    del params
    # the control: this process, no group (only where the shard is whole).
    # At one rank every mode runs the same code (each collective returns its
    # input), so ina and auto stand for them; at W >= 2 every mode runs.
    if world == 1:
        out["control"] = phase_profile(cfg, shard, tag=f"_tp_none_r{rank}",
                                       device=device)
    for mode in C.CLI_PSUM_MODES if world > 1 else ("ina", "auto"):
        out["profile"][mode] = phase_profile(
            cfg, shard, ParallelCtx(group=group, psum_mode=mode),
            tag=f"_tp_{mode}_r{rank}", device=device)
    # every auto site of a decode step and a prefill chunk, then resolved
    pctx = ParallelCtx(group=group, psum_mode="auto")
    with C.record_psum_sites() as sites:
        build_paged_serve_step(model, pctx).fn(
            shard, {"tokens": torch.full((2, 1), 11, device=device),
                    "pos": torch.tensor([128, 140], device=device)},
            model.init_cache(2, 161, device=device, world=world))
        model.prefill(shard, {"tokens": torch.full((1, 64), 11,
                                                   device=device)},
                      model.init_cache(1, 192, device=device, world=world),
                      pctx, pos_offset=64)
    out["sites"] = {"count": len(sites), "distinct": [
        (s.op, s.p, s.nbytes, C.resolve_auto_mode(s.op, s.p, s.nbytes))
        for s in dict.fromkeys(sites)]}
    # what one resolution costs once its shape is known (host clock; the
    # decode step's site)
    t0 = time.perf_counter()
    for _ in range(10000):
        C.resolve_auto_mode("psum", world, 2 * cfg.d_model * 2)
    out["sites"]["us"] = (time.perf_counter() - t0) / 10000 * 1e6
    # and what the first resolution of a shape costs: the cost model's
    # event-driven simulation on an empty store and memo (host clock)
    out["sites"]["cold"] = []
    for p in (2, 4, 8):
        for shape, dt in TP_PAYLOADS:
            nbytes = math.prod(shape) * dt.itemsize
            noc_cost._simulate.cache_clear()
            with fresh_sim_cache():
                t0 = time.perf_counter()
                mode = C.choose_psum_mode(p, nbytes)
                ms = (time.perf_counter() - t0) * 1e3
            out["sites"]["cold"].append((p, nbytes, mode, ms))
    noc_cost._simulate.cache_clear()
    if world >= 2:
        out["collectives"] = tp_collectives(rank, world, group, device)
    return out


def phase_tp(served: dict) -> dict:
    """Phase 4 (see the module docstring).  Returns each mode's launch
    counts on rank 0, for the kernels line."""
    cfg = ARCHS[ARCH]
    world = min(torch.cuda.device_count(), 4)
    log(f"[tp] world {world}: {ARCH} at full width and depth on an NCCL group"
        f" of {world} rank(s), one process each, under every psum mode")
    if world == 1:
        log("[tp] the multi-rank checks (collectives against the rank sum, "
            "psum times, tokens across ranks) need two or more devices; this "
            "machine has one, so they were not run")
    ranks = mesh.spawn(tp_rank, world, "cuda", args=(SERVE_ARGV[ARCH],))
    r0 = ranks[0]
    for mode, run in r0["modes"].items():
        for rank, other in enumerate(ranks):
            if other["modes"][mode]["tokens"] != run["tokens"]:
                raise AssertionError(f"[tp] {mode}: rank {rank}'s tokens differ"
                                     f" from rank 0's")
        if world == 1:
            if run["tokens"] != served["tokens"]:
                raise AssertionError(f"[tp] {mode}: tokens differ from the "
                                     f"serve phase's")
            continue
        report = types.SimpleNamespace(requests=[
            {"rid": rid, "tokens": toks,
             "first_logits": torch.from_numpy(run["first_logits"][rid])}
            for rid, toks in run["tokens"].items()])
        compare_with_legacy(report, served["legacy"], f"tp {mode}",
                            cfg.n_layers, bits=5)
    if world == 1:
        log(f"[tp] W=1: tokens of all {len(r0['modes'])} modes equal the serve "
            f"phase's bit for bit")
        ina = r0["modes"]["ina"]
        for replicated, run in r0["data"].items():
            tokens = {f"req{i}": t for i, t in enumerate(run["tokens"])}
            log(f"[serve] --ranks 1, a one-rank data group, "
                f"serve_replicated_params {replicated}: tokens "
                f"{'equal' if tokens == served['tokens'] else 'DIFFER FROM'}"
                f" the groupless serve's, launches {run['launches']} (ina "
                f"on the group: {ina['launches']})")
            if tokens != served["tokens"] or run["launches"] != \
                    ina["launches"]:
                raise AssertionError(f"[serve] data group, replicated "
                                     f"{replicated}: not the groupless "
                                     f"serve")
    for mode, prof in r0["profile"].items():
        counts = {k: v["kernels_per_step"] for k, v in prof.items()}
        want = {k: v["kernels_per_step"] for k, v in served["profile"].items()}
        log(f"[tp] W={world} {mode}: kernels a step {counts} (no group: "
            f"{want}; each the most of its steps' counts: a record the trace "
            f"drops only lowers a step's)")
        if world == 1 and counts != want:
            raise AssertionError(f"[tp] {mode}: kernels a step {counts} != "
                                 f"the no-group run's {want}")
    if "control" in r0:
        log(f"[tp] control, the rank's process without a group: decode "
            f"{r0['control']['decode']['wall_ms']:.2f}, prefill "
            f"{r0['control']['prefill']['wall_ms']:.2f} host ms a step (the "
            f"serve phase's process: {served['profile']['decode']['wall_ms']:.2f}"
            f", {served['profile']['prefill']['wall_ms']:.2f})")
    for op, p, nbytes, mode in r0["sites"]["distinct"]:
        log(f"[tp] auto site: op {op}, p {p}, nbytes {nbytes} -> {mode}")
    log(f"[tp] {r0['sites']['count']} auto sites a decode step and prefill "
        f"chunk, {len(r0['sites']['distinct'])} distinct; a known site "
        f"resolves in {r0['sites']['us']:.2f} us (host clock, memo lookup); "
        f"decode step host ms: auto "
        f"{r0['profile']['auto']['decode']['wall_ms']:.2f}, ina "
        f"{r0['profile']['ina']['decode']['wall_ms']:.2f} (one call)")
    for p, nbytes, mode, ms in r0["sites"]["cold"]:
        log(f"[tp] cold resolution: p {p}, nbytes {nbytes} -> {mode} in "
            f"{ms:.3f} ms (host clock, empty store and memo)")
    for row in r0.get("collectives", []):
        log(f"[tp] psum W={world} {row['mode']:12s} {row['shape']} "
            f"{row['dtype']}: {row['ms']:.4f} ms (host clock, 20 in a row), "
            f"{row['per_link_bytes']:.0f} bytes a link")
    return {mode: run["launches"] for mode, run in r0["modes"].items()}


# --------------------------------------------------------------------------- #
# phase 4b: the plan layer
# --------------------------------------------------------------------------- #
def plan_tile_counts(fn) -> dict:
    """The plan's tile hits and misses of one call of ``fn``."""
    im.plan_tiles.update(hit=0, miss=0)
    fn()
    torch.cuda.synchronize()
    return dict(im.plan_tiles)


#: Turns of each of the planned and planless decode step walls.
WALL_TURNS = 10


def quartiles(values) -> tuple:
    """(first quartile, median, third quartile) of ``values``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return q1, q2, q3


def host_ms(fn, steps: int = 20) -> float:
    """Host-clock ms a call of ``fn``, over ``steps`` calls ending on a
    sync, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def log_plan(plan, info, label: str) -> None:
    log(f"[plan] {label} {plan.key}: {'warm' if info['from_store'] else 'cold'}"
        f" in {info['plan_s']:.4f} s (host clock), {info['collective_sims']} "
        f"collective simulations, psum {info['psum']}")
    for t in plan.tiles:
        log(f"[plan]   tile [{t.m},{t.k}]x[{t.k},{t.n}] {t.dtype}: {t.regime} "
            f"{t.tile_m}x{t.tile_n} c={t.cluster} bk={t.bk}")
    for g in plan.gemms:
        log(f"[plan]   verdict {g.layer} [{g.M},{g.K}]x[{g.K},{g.N}] -> "
            f"{g.mapping}: {g.latency_cycles} cycles, {g.energy_pj} pJ "
            f"(paper's mapping {g.baseline_latency_cycles} cycles, "
            f"{g.baseline_energy_pj} pJ; {g.latency_x:.4f}x, "
            f"{g.energy_x:.4f}x)")


def phase_plan(served: dict) -> dict:
    """Phase 4b (see the module docstring).  Returns the planned serve's
    launch counts, for the kernels line."""
    cfg = ARCHS[ARCH]
    model = get_model(cfg)
    root = _build.BUILD_DIR.parent
    store, sims = root / "plans", root / "plan_sims"
    for d in (store, sims):
        shutil.rmtree(d, ignore_errors=True)
    SIM_CACHE.persist(sims)          # an empty sim store: the builds are cold
    args = plan_serve_args(store)
    cold = launch_serve.launch_plans(args, cfg)
    warm = launch_serve.launch_plans(args, cfg)
    for kind in ("decode", "prefill"):
        (plan, info), (again, winfo) = cold[kind], warm[kind]
        log_plan(plan, info, kind)
        log_plan(again, winfo, kind)
        findings = verify_plan(plan, check_layers=True)
        if info["from_store"] or not winfo["from_store"] or again != plan \
                or winfo["collective_sims"] != 0 or findings:
            raise AssertionError(f"[plan] {kind}: cold {info}, warm {winfo},"
                                 f" findings {findings}")
    decode_plan, prefill_plan = cold["decode"][0], cold["prefill"][0]

    # phase 3's requests through the plans (the same seeded weights)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    reset_launches()
    im.plan_tiles.update(hit=0, miss=0)
    report = launch_serve.run_engine(args, cfg, params)
    torch.cuda.synchronize()
    launches, by_regime = read_launches(), dict(im.launches_by_regime)
    run_tiles = dict(im.plan_tiles)
    per_pass = MATMULS_PER_PASS["dense"] * cfg.n_layers
    want_tiles = {"hit": per_pass * report.decode_steps,
                  "miss": report.decode_steps
                  + (per_pass + 1) * report.prefill_chunks}
    log(f"[plan] serve under auto through the plans: launches {launches}, "
        f"by regime {by_regime} (phase 3: {served['launches']}, "
        f"{served['by_regime']}); plan tiles over the run {run_tiles} "
        f"(derived {want_tiles}: {report.decode_steps} decode steps, "
        f"{report.prefill_chunks} prefill chunks)")
    if report.tokens() != served["tokens"]:
        raise AssertionError("[plan] tokens differ from the serve phase's")
    if launches != served["launches"] or by_regime != served["by_regime"]:
        raise AssertionError(f"[plan] launches {launches} {by_regime} != the "
                             f"serve phase's")
    if run_tiles != want_tiles:
        raise AssertionError(f"[plan] tile hits and misses {run_tiles} != "
                             f"{want_tiles}")
    log(f"[plan] tokens of all {len(report.requests)} requests equal the "
        f"serve phase's bit for bit")

    # hits and misses of one pass of each phase, at the serve's shapes
    cache = model.init_cache(2, serve_cache(SERVE_ARGV[ARCH]), device="cuda")
    batch = {"tokens": torch.full((2, 1), 11, device="cuda"),
             "pos": torch.tensor([128, 140], device="cuda")}
    step = build_paged_serve_step(model, plan=decode_plan)
    pcache = model.init_cache(1, 192, device="cuda")
    toks = torch.full((1, args.prefill_chunk), 11, device="cuda")
    per_phase = {
        "decode": plan_tile_counts(lambda: step.fn(params, batch, cache)),
        "prefill": plan_tile_counts(lambda: model.prefill(
            params, {"tokens": toks}, pcache,
            ParallelCtx(plan=prefill_plan), pos_offset=64))}
    for kind, counts in per_phase.items():
        log(f"[plan] {kind} pass: plan tile hits {counts['hit']}, misses "
            f"{counts['miss']} (plan tokens "
            f"{cold[kind][0].tokens})")
    if per_phase["decode"] != {"hit": per_pass, "miss": 1} or \
            per_phase["prefill"] != {"hit": 0, "miss": per_pass + 1}:
        raise AssertionError(f"[plan] hits and misses a pass {per_phase}")
    # what reading the plan costs the host: a decode step's wall planless
    # and planned (the same launches), in pairs of turns whose order
    # alternates (planless first, then planned first)
    steps = {"planless": build_paged_serve_step(model), "planned": step}
    walls = {"planless": [], "planned": []}
    for turn in range(WALL_TURNS):
        order = ("planless", "planned")[::1 if turn % 2 == 0 else -1]
        for label in order:
            walls[label].append(host_ms(
                lambda: steps[label].fn(params, batch, cache)))
    stats = {label: [round(q, 4) for q in quartiles(ms)]
             for label, ms in walls.items()}
    no_worse = all(p <= q for p, q in zip(walls["planned"],
                                          walls["planless"]))
    log(f"[plan] decode step wall, host clock, 20 steps a turn, "
        f"{WALL_TURNS} turns each in alternating order: planless "
        f"{walls['planless']} ms, planned {walls['planned']} ms; "
        f"(q1, median, q3) planless {stats['planless']}, planned "
        f"{stats['planned']}; every planned turn no worse than its pair's "
        f"planless turn: {no_worse}")
    del params, cache, pcache
    fresh_phase()

    # the three phase plans at the reference's mesh, on the host
    for phase in PHASES:
        built = []
        for _ in range(2):
            runs = noc_cost.COST_STATS["engine_runs"]
            t0 = time.perf_counter()
            plan, cold_build = PlanStore(store).get_or_build(cfg, MESH_16,
                                                             phase)
            built.append((cold_build, time.perf_counter() - t0,
                          noc_cost.COST_STATS["engine_runs"] - runs))
        got = tuple((d.p, d.nbytes, d.mode, d.ops, d.count, d.costs)
                    for d in plan.psum)
        log(f"[plan] {plan.key}: cold {built[0][1]:.4f} s, "
            f"{built[0][2]} collective simulations; warm {built[1][1]:.4f} s,"
            f" {built[1][2]}; psum {got}")
        if got != PLAN_16X16[phase] or not built[0][0] or built[1][0] \
                or built[1][2] != 0 or verify_plan(plan):
            raise AssertionError(f"[plan] {phase} at {MESH_16}: {got}, "
                                 f"builds {built}")
    log(f"[plan] the {len(PHASES)} phase plans at {MESH_16} equal the "
        f"reference's decisions")
    plans_across_chips(store)
    mapper_across_chips()
    verified_psum_programs()
    verified_hier_corpus()
    return launches


def plans_across_chips(store: Path) -> None:
    """The three phase plans at :data:`MESH_16` with the model axis over
    :data:`PLAN_CHIPS` chips, under each package: cold, then warm from the
    store with no collective simulation, each free of ``verify_plan``
    findings and equal to :data:`PLAN_16X16_C4`."""
    cfg = ARCHS[ARCH]
    for package in noc_hier.PACKAGE_VARIANTS:
        tag = f"__c{PLAN_CHIPS}" + ("e" if package == "express" else "")
        for phase in PHASES:
            built = []
            for _ in range(2):
                runs = noc_cost.COST_STATS["engine_runs"]
                t0 = time.perf_counter()
                plan, cold_build = PlanStore(store).get_or_build(
                    cfg, MESH_16, phase, chips=PLAN_CHIPS, package=package)
                built.append((cold_build, time.perf_counter() - t0,
                              noc_cost.COST_STATS["engine_runs"] - runs))
            got = tuple((d.p, d.nbytes, d.mode, d.ops, d.count, d.costs)
                        for d in plan.psum)
            log(f"[plan] {plan.key}: cold {built[0][1]:.4f} s (host clock),"
                f" {built[0][2]} collective simulations; warm "
                f"{built[1][1]:.4f} s, {built[1][2]}; psum {got}")
            if got != PLAN_16X16_C4[package, phase] or not built[0][0] \
                    or built[1][0] or built[1][2] != 0 or verify_plan(plan) \
                    or f"{tag}__" not in plan.key \
                    or (plan.chips, plan.package) != (PLAN_CHIPS, package):
                raise AssertionError(f"[plan] {phase} at {MESH_16} over "
                                     f"{PLAN_CHIPS} chips ({package}): "
                                     f"{plan.key} {got}, builds {built}")
    log(f"[plan] the {len(PHASES)} phase plans at {MESH_16} over "
        f"{PLAN_CHIPS} chips equal the reference's decisions under both "
        f"packages")


def mapper_across_chips() -> None:
    """The mapper over qwen2-1.5b's decoder GEMMs at 2 tokens with the
    package axis, under each package, its winner verified
    (``debug=True``): hardware, latency and energy equal
    :data:`MAPPER_CHIPS`."""
    layers = get_model(ARCHS[ARCH]).gemm_layers(2)
    for package, want in MAPPER_CHIPS.items():
        mcfg = dataclasses.replace(QUICK_MAPPER, chips_list=MAPPER_CHIPS_LIST,
                                   package=package)
        t0 = time.perf_counter()
        out = search_network(f"{ARCH}:gemm", layers, mcfg, debug=True)
        dt = time.perf_counter() - t0
        best = out.best
        got = (best.hardware, best.latency_cycles, best.total_energy_pj)
        labels = ", ".join(sorted({a.mapping.label()
                                   for a in best.assignments}))
        log(f"[plan] mapper, {len(layers)} GEMMs at 2 tokens, chips "
            f"{MAPPER_CHIPS_LIST}, package {package}, debug=True: winner "
            f"{best.hardware} ({labels}),"
            f" {best.latency_cycles} cycles, {best.total_energy_pj} pJ "
            f"(paper's mapping {out.baseline.latency_cycles} cycles, "
            f"{out.baseline.total_energy_pj} pJ); "
            f"{out.stats['hardware_evaluated']} hardware points in "
            f"{dt:.4f} s (host clock)")
        if got != want:
            raise AssertionError(f"[plan] mapper ({package}): {got} != "
                                 f"{want}")


def verified_psum_programs() -> None:
    """Each psum mode's lowering of the decode site (p 16, the
    :data:`PLAN_16X16` payload) run through ``run_program(verify=True)``:
    clean of program and collective findings, its latency the plan's
    recorded cost."""
    (p, nbytes, _, _, _, costs), = PLAN_16X16["decode"]
    latency = {m: lat for m, lat, _ in costs}
    rcfg = noc_cost._row_cfg(p, NocConfig())
    parts = mesh_row(p, 0)[:p]
    for mode, (algorithm, semantics) in noc_cost.PSUM_MODE_LOWERING.items():
        prog = noc_sched.plan_collective("allreduce", parts, nbytes * 8,
                                         rcfg, algorithm=algorithm,
                                         semantics=semantics)
        findings = verify_collective(prog, op="allreduce",
                                     participants=parts,
                                     algorithm=algorithm,
                                     semantics=semantics)
        t0 = time.perf_counter()
        res = run_program(prog, rcfg, verify=True)
        dt = time.perf_counter() - t0
        want = latency[mode if mode != "xla" else "ina"]
        log(f"[plan] run_program(verify=True) {mode} ({algorithm}, "
            f"{semantics}) at p {p}, {nbytes} B: {len(prog)} ops, "
            f"{res.latency_cycles} cycles (plan {want}), verified and run "
            f"in {dt:.4f} s (host clock)")
        if findings or res.latency_cycles != want:
            raise AssertionError(f"[plan] {mode}: {findings}, "
                                 f"{res.latency_cycles} != {want}")


def verified_hier_corpus() -> None:
    """``verify_hier_schedule`` clean over the hierarchy corpus: the grids
    of :data:`HIER_GRIDS` x both packages x every op, semantics and
    allreduce algorithm (4096-bit operands on 8 x 8 chips)."""
    t0 = time.perf_counter()
    n = 0
    for grid in HIER_GRIDS:
        for package in noc_hier.PACKAGE_VARIANTS:
            hmesh = noc_hier.HierarchicalMesh(chips_x=grid[0],
                                              chips_y=grid[1],
                                              package=package)
            for op in noc_hier.HIER_OPS:
                for semantics in noc_sched.SEMANTICS:
                    for algorithm in (noc_sched.ALLREDUCE_ALGORITHMS
                                      if op == "allreduce"
                                      else ("reduce_bcast",)):
                        sched = noc_hier.plan_hier_collective(
                            op, hmesh, 4096.0, NocConfig(n=4),
                            algorithm=algorithm, semantics=semantics)
                        findings = verify_hier_schedule(sched)
                        if findings:
                            raise AssertionError(
                                f"[plan] {grid} {package} {op} {semantics} "
                                f"{algorithm}: {findings}")
                        n += 1
    if n != 32:
        raise AssertionError(f"[plan] {n} hierarchical schedules, not 32")
    log(f"[plan] verify_hier_schedule: {n} hierarchical schedules (grids "
        f"{HIER_GRIDS}, both packages, every op, semantics and algorithm) "
        f"clean in {time.perf_counter() - t0:.4f} s (host clock)")


# --------------------------------------------------------------------------- #
# phase 4c: the capacity planner and the paper's evaluation
# --------------------------------------------------------------------------- #
def demo_launches(doc: dict) -> dict:
    """The engine demo's launches, derived from the code: a pass of the
    reduced model (:func:`matmuls_per_pass`) a prefill chunk and a decode
    step, flash attention once a layer a prefill chunk, no wkv6."""
    rc = ARCHS[ARCH].reduced()
    passes = doc["prefill_chunks"] + doc["decode_steps"]
    return {"ina_matmul": matmuls_per_pass(rc) * passes,
            "flash_attention": rc.n_layers * doc["prefill_chunks"],
            "wkv6": 0}


def capacity_run(argv: list, out: Path, label: str):
    """``python -m repro_torch.serve`` with ``argv``, its JSON in ``out``:
    (the document, launches by kernel, the launch shapes)."""
    reset_launches()
    with record_shapes() as seen:
        t0 = time.perf_counter()
        if planner.main(argv + ["--out", str(out)]) != 0:
            raise AssertionError(f"[capacity] {label}: the planner failed")
        torch.cuda.synchronize()
    launches = read_launches()
    doc = json.loads(out.read_text())
    ans = doc["fleet_answer"]
    log(f"[capacity] {label}: fleet answer {ans['fleet']} replica(s) of an "
        f"8 x 8 mesh for p99 {ans['metric']} <= {ans['slo_s']} s ("
        + ", ".join(f"fleet {r['fleet']}: p99 {r['p99_s']:.4f} s"
                    for r in ans["searched"])
        + f"); plans {[(k, v['collective_sims']) for k, v in
                       sorted(doc['plan'].items())]} (phase, collective "
        f"simulations); {time.perf_counter() - t0:.2f} s (host clock)")
    return doc, launches, seen


def check_demo_shapes(timer, gen, seen: dict) -> tuple[list, list]:
    """Each launch shape of the engine demo that phase 2 did not check,
    held against its plain version and timed as phase 2 times its cases:
    (``ina_matmul`` rows, ``flash_attention`` rows)."""
    cases = [(f"capacity demo [{m},{k}]x[{k},{n}]", m, k, n, layout, dt)
             for m, k, n, layout, dt in sorted(
                 seen["ina_matmul"] - CHECKED["ina_matmul"], key=str)]
    mm = check_matmul(timer, gen, cases)
    at = []
    for key in sorted(seen["flash_attention"] - CHECKED["flash_attention"],
                      key=str):
        b, sq, h, sk, kvh, d, causal, off, dt = key
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dt)
                   for shape in ((b, sq, h, d), (b, sk, kvh, d),
                                 (b, sk, kvh, d)))
        at.append(attention_row(timer, f"capacity demo Sk={sk}", q, k, v,
                                off, causal))
    check_shapes(seen, "capacity", "phase 2 or this phase")
    return mm, at


def phase_capacity(served: dict, smi: str) -> dict:
    """Phase 4c (see the module docstring).  Returns the engine demo's
    launch counts a run and its kernel rows, for the kernels line."""
    t_phase = time.perf_counter()
    cfg = ARCHS[ARCH]
    root = _build.BUILD_DIR.parent
    store, out = root / "plans", root / "capacity"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    base = CAPACITY_ARGV + ["--plan-dir", str(store)]
    docs, runs, tokens = {}, {}, None
    timer, gen = Timer(), torch.Generator(device="cuda").manual_seed(5)
    mm_rows, at_rows = [], []
    for sem in SEMANTICS:
        doc, launches, seen = capacity_run(
            base + ["--semantics", sem], out / f"{sem}.json", sem)
        eng = doc["engine"]
        expect = demo_launches(eng)
        log(f"[capacity] {sem}: engine demo on the card ({eng['arch_reduced']}"
            f", {eng['requests']} requests, {eng['slots']} slots, block "
            f"{eng['block_size']}, prefill chunk {eng['prefill_chunk']}): "
            f"{eng['iterations']} iterations, {eng['prefill_chunks']} prefill "
            f"chunks, {eng['decode_steps']} decode steps, "
            f"{eng['paged_monolithic_checks']} paged==monolithic checks; "
            f"launches {launches}, derived {expect}; {smi}")
        check_launches(launches, expect, ("ina_matmul", "flash_attention"))
        if eng["paged_monolithic_checks"] != eng["requests"]:
            raise AssertionError(f"[capacity] {sem}: {eng}")
        if tokens is not None and eng["tokens"] != tokens:
            raise AssertionError("[capacity] the engine demo's tokens differ "
                                 "between the two runs")
        tokens = eng["tokens"]
        mm, at = check_demo_shapes(timer, gen, seen)
        mm_rows += mm
        at_rows += at
        docs[sem], runs[sem] = doc, launches
    del timer
    for sem, doc in docs.items():
        log(f"[capacity] fleet answer under {sem}: "
            f"{doc['fleet_answer']['fleet']} (modeled seconds, 1 GHz mesh)")
    # the calibration PlanCostModel exists for: [serve]'s measured
    # full-width decode step (2 slots) and prefill chunk (64 tokens) over
    # the same plans' modeled ones
    plans = serve_plans(cfg, planner.parse_mesh("8x8"), plan_dir=store,
                        verbose=False)
    cost = PlanCostModel.from_plans(cfg, plans["prefill"][0],
                                    plans["decode"][0], prefill_chunk=64)
    prof = served["profile"]
    ratio = {"decode": prof["decode"]["wall_ms"] / 1e3
             / cost.decode_iter_seconds(2),
             "prefill": prof["prefill"]["wall_ms"] / 1e3
             / cost.prefill_chunk_seconds()}
    log(f"[capacity] calibration, measured over modeled: decode step of 2 "
        f"slots {prof['decode']['wall_ms']:.4f} ms (host clock) over "
        f"{cost.decode_iter_seconds(2) * 1e3:.4f} ms modeled = "
        f"{ratio['decode']:.6g}; prefill chunk of 64 "
        f"{prof['prefill']['wall_ms']:.4f} ms over "
        f"{cost.prefill_chunk_seconds() * 1e3:.4f} ms = "
        f"{ratio['prefill']:.6g}; {smi}")
    doc, launches, _ = capacity_run(
        base + ["--semantics", "ina", "--no-execute", "--calibration",
                repr(ratio["decode"])], out / "calibrated.json",
        "ina, calibrated to the card's decode step")
    if any(launches.values()):
        raise AssertionError(f"[capacity] --no-execute launched {launches}")
    metrics = doc["fleet_answer"]["metrics"] or {}
    log(f"[capacity] fleet answer in the card's seconds (calibration "
        f"{ratio['decode']:.6g}): {doc['fleet_answer']['fleet']} replica(s)"
        + (f"; p99 queueing {metrics['queueing_s']['p99']:.4f} s, ttft "
           f"{metrics['ttft_s']['p99']:.4f} s, e2e "
           f"{metrics['e2e_s']['p99']:.4f} s, "
           f"{metrics['throughput_tok_s']:.1f} tok/s" if metrics else "")
        + f"; {smi}")
    evaluation()
    log(f"[capacity] phase {time.perf_counter() - t_phase:.1f} s (host "
        f"clock)")
    return {"launches": runs, "mm_rows": mm_rows, "at_rows": at_rows,
            "calibration": ratio}


def evaluation() -> None:
    """The paper's evaluation through ``python -m repro_torch.experiments
    --quick`` (no failed plan or serve row), and Figs 7-12 at E 1 and 16
    rounds held to :data:`FIG7_9_PINS` and :data:`FIG10_12_PINS`."""
    root = _build.BUILD_DIR.parent
    out = root / "experiments"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = experiments.main(["--quick", "--sections", EXPERIMENT_SECTIONS,
                               "--out", str(out), "--plan-dir",
                               str(root / "plans"), "--cache-dir",
                               str(root / "plan_sims")])
    for line in text.getvalue().splitlines():
        log(f"[capacity] experiments: {line}")
    if rc != 0:
        raise AssertionError(f"[capacity] experiments exited {rc}")
    figs = {s: json.loads((out / f"{s}.json").read_text())
            for s in EXPERIMENT_SECTIONS.split(",")}
    bad = [r for s in ("plan", "serve") for r in figs[s]["rows"]
           if f"{s}_error" in r]
    if bad:
        raise AssertionError(f"[capacity] failed rows: {bad}")
    for a in figs["serve"]["answers"]:
        log(f"[capacity] experiments serve (16 x 16 mesh): {a}")
    log(f"[capacity] experiments --quick: {len(figs['plan']['rows'])} plans"
        f", {len(figs['serve']['rows'])} serve rows, no error, in "
        f"{time.perf_counter() - t0:.2f} s (host clock)")
    for fig, improve, pins in (("fig7_9", noc_power.ws_ina_improvement,
                                FIG7_9_PINS),
                               ("fig10_12", noc_power.ws_vs_os_improvement,
                                FIG10_12_PINS)):
        got = {}
        for name, want in pins.items():
            imp = improve(name, WORKLOADS[name], 1, NocConfig(), 16)
            got[name] = (imp.latency_x, imp.power_x, imp.energy_x)
            if not all(math.isclose(g, w, rel_tol=1e-9)
                       for g, w in zip(got[name], want)):
                raise AssertionError(f"[capacity] {fig} {name}: {got[name]}"
                                     f" != the pins {want}")
        mean = [sum(v[i] for v in got.values()) / len(got) for i in range(3)]
        quick = figs[fig]["average"]
        lat, pwr = PAPER_HEADLINE[fig]
        log(f"[capacity] {fig} at E 1, 16 rounds: "
            + ", ".join(f"{n} latency_x {v[0]:.4f} power_x {v[1]:.4f} "
                        f"energy_x {v[2]:.4f}" for n, v in got.items())
            + f" (the pins, rel 1e-9); mean latency_x {mean[0]:.4f}, "
            f"power_x {mean[1]:.4f}; --quick average latency_x "
            f"{quick['latency_x']:.4f}, power_x {quick['power_x']:.4f}; the "
            f"paper: up to {lat}x latency, {pwr}x power (modeled NoC "
            f"cycles and pJ, the same on any host)")


# --------------------------------------------------------------------------- #
# [noc]: the NoC fault layer and the compiled and vectorized executors
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def noc_fresh():
    """An empty, non-persistent window store, cold collective memos,
    executor programs and vectorized counters (each engine starts cold)."""
    with fresh_sim_cache():
        noc_cost._simulate.cache_clear()
        noc_cost._simulate_faulted.cache_clear()
        noc_hier.cost._simulate_express.cache_clear()
        noc_traffic.clear_compiled_caches()
        noc_vec.reset_vector_stats()
        yield


def noc_results(x):
    """A section's JSON without :data:`NOC_HOST_FIELDS`."""
    if isinstance(x, dict):
        return {k: noc_results(v) for k, v in x.items()
                if k not in NOC_HOST_FIELDS}
    if isinstance(x, list):
        return [noc_results(v) for v in x]
    return x


def noc_sweeps(root: Path) -> dict:
    """``python -m repro_torch.experiments --quick`` over
    :data:`NOC_SECTIONS` once under each of :data:`NOC_ENGINES`, each into
    a fresh output directory and window store: every section's JSON equal
    across the engines (less :data:`NOC_HOST_FIELDS`), no ``faults_error``
    row.  Returns ``{engine: seconds}``."""
    figs, seconds = {}, {}
    for engine in NOC_ENGINES:
        out = root / engine
        shutil.rmtree(out, ignore_errors=True)
        with noc_fresh(), \
                contextlib.redirect_stdout(io.StringIO()) as text:
            t0 = time.perf_counter()
            rc = experiments.main(["--quick", "--sections", NOC_SECTIONS,
                                   "--engine", engine, "--out", str(out),
                                   "--cache-dir", str(root / f"sims_{engine}")])
            seconds[engine] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"[noc] --engine {engine} exited {rc}")
        vec = text.getvalue().splitlines()[-1]
        log(f"[noc] --engine {engine}: {seconds[engine]:.3f} s (host "
            f"clock); {vec}")
        figs[engine] = {s: json.loads((out / f"{s}.json").read_text())
                        for s in NOC_SECTIONS.split(",")}
    for engine, got in figs.items():
        for section, fig in got.items():
            if noc_results(fig) != noc_results(figs["heap"][section]):
                raise AssertionError(f"[noc] --engine {engine}: {section} "
                                     f"differs from the heap engine's")
    faults = figs["auto"]["faults"]
    bad = [r for r in faults["rows"] + faults["cluster_rows"]
           if "faults_error" in r]
    if bad:
        raise AssertionError(f"[noc] faults_error rows: {bad}")
    log(f"[noc] {len(NOC_SECTIONS.split(','))} sections equal under "
        f"{', '.join(NOC_ENGINES)} (less {', '.join(NOC_HOST_FIELDS)}); the "
        f"faults section on the {faults['mesh_n']} x {faults['mesh_n']} mesh,"
        f" seed {faults['seed']} (modeled NoC cycles and pJ):")
    for line in noc_report._faults_table(faults).splitlines():
        log(f"[noc]   {line}")
    return seconds


def noc_window_keys() -> list:
    """The window keys one quick mapper search of
    :data:`NOC_MAPPER_WORKLOAD` hands the batched pass, in order (recorded
    from ``_prefetch_hardware``'s calls, on a cold store)."""
    keys: list = []
    real = mapper_search.prefetch_windows

    def record(batch):
        batch = list(batch)
        keys.extend(batch)
        return real(batch)
    mapper_search.prefetch_windows = record
    try:
        with noc_fresh():
            search_network(NOC_MAPPER_WORKLOAD,
                           mapper_workloads()[NOC_MAPPER_WORKLOAD],
                           QUICK_MAPPER)
    finally:
        mapper_search.prefetch_windows = real
    return keys


def _bits(latency: float, ledger) -> tuple:
    return (latency.hex(), tuple(float(c).hex() for c in ledger.as_tuple()))


def noc_batched_pass(keys: list, backend: str, device=None) -> tuple:
    """``prefetch_windows(keys)`` on a cold store under ``backend``:
    ``({key: bits}, windows batched, seconds)``; the backend goes back to
    numpy after."""
    noc_vec.set_array_backend(backend, device)
    try:
        with noc_fresh():
            t0 = time.perf_counter()
            noc_vec.prefetch_windows(keys)
            dt = time.perf_counter() - t0
            batched = noc_vec.VECTOR_STATS["windows_batched"]
            entries = {k: _bits(lat, led)
                       for k, (lat, led) in SIM_CACHE.export().items()}
    finally:
        noc_vec.set_array_backend("numpy")
    return entries, batched, dt


def noc_torch_backend(device: str, smi: str) -> dict:
    """The batched window pass in PyTorch on ``device`` over
    :func:`noc_window_keys`: every store entry it writes bit for bit the
    numpy backend's and the heap engine's; the tensors' device, the
    batched windows and both backends' seconds (host clock, the second of
    two passes each) printed."""
    keys = noc_window_keys()
    on_card = torch.device(device).type == "cuda"
    allocs = (lambda: torch.cuda.memory_stats(device).get(
        "allocation.all.allocated", 0)) if on_card else (lambda: 0)
    noc_batched_pass(keys, "torch", device)             # warm-up
    before = allocs()
    got, batched, t_torch = noc_batched_pass(keys, "torch", device)
    card_allocs = allocs() - before
    noc_batched_pass(keys, "numpy")
    want, np_batched, t_numpy = noc_batched_pass(keys, "numpy")
    if got != want or batched != np_batched or not batched:
        raise AssertionError(f"[noc] torch on {device}: {len(got)} entries, "
                             f"{batched} batched; numpy {len(want)}, "
                             f"{np_batched}; equal {got == want}")
    if on_card and not card_allocs:
        raise AssertionError("[noc] the torch pass allocated nothing on "
                             "the card")
    for key, bits in got.items():
        cfg, mode, window, g, p, gather_flits, unicast_flits, e_pes = key
        prog = noc_sched.ws_round_program(
            cfg, mode, window, g=g, p=p, gather_flits=gather_flits,
            unicast_flits=unicast_flits, e_pes=e_pes)
        res = run_program(prog, cfg, engine="heap")
        if _bits(float(res.latency_cycles), res.ledger) != bits:
            raise AssertionError(f"[noc] window {key[1:]}: the batched pass "
                                 f"gives {bits}, the heap engine "
                                 f"{_bits(float(res.latency_cycles), res.ledger)}")
    log(f"[noc] batched window pass, torch on {device} (int64/float64, "
        f"{card_allocs} CUDA allocations): {len(keys)} window keys of a "
        f"quick {NOC_MAPPER_WORKLOAD} mapper search, {len(got)} entries "
        f"({batched} batched windows), bit-equal to numpy's and the heap "
        f"engine's; {t_torch * 1e3:.3f} ms torch, {t_numpy * 1e3:.3f} ms "
        f"numpy (host clock, whole call); {smi}")
    return {"keys": len(keys), "entries": len(got), "batched": batched,
            "torch_s": t_torch, "numpy_s": t_numpy}


def _run(prog, cfg, engine: str):
    res = run_program(prog, cfg, engine=engine)
    return (res.latency_cycles, res.ledger.as_tuple(), res.done,
            res.delivered)


def noc_faulted_corpus() -> dict:
    """Every program of ``faulted_collective_programs(quick=True)`` and
    every lane of ``faulted_hier_schedules(quick=True)``: ``verify_faulted``
    finds nothing, and the heap, compiled and vectorized engines (where the
    program allows each) give the same latency, ledger, ``done`` and
    ``delivered``.  Returns the counts."""
    t0 = time.perf_counter()
    progs = []
    for case, cfg, faults, prog in noc_corpus.faulted_collective_programs(
            quick=True):
        findings = verify_faulted(
            prog, faults, cfg, op=case["op"],
            participants=case["participants"], algorithm=case["algorithm"],
            semantics=case["semantics"])
        progs.append((f"{case['fault']} {case['label']} {case['op']} "
                      f"{case['semantics']} {case['algorithm']}", cfg,
                      prog, findings))
    n_sched = 0
    for case, faults, sched in noc_corpus.faulted_hier_schedules(quick=True):
        n_sched += 1
        findings = verify_hier_schedule(sched)
        for level, lane in sched.all_lanes():
            lane_findings = (verify_faulted(list(lane.prog), faults, lane.cfg)
                             if lane.scope == "chip" else [])
            progs.append((f"hier {case['grid']} {case['op']} "
                          f"{case['semantics']} {level.name} {lane.label}",
                          lane.cfg, list(lane.prog),
                          findings + lane_findings))
    ran = {"heap": 0, "compiled": 0, "vectorized": 0}
    for label, cfg, prog, findings in progs:
        if findings:
            raise AssertionError(f"[noc] {label}: {findings}")
        want = _run(prog, cfg, "heap")
        ran["heap"] += 1
        for engine, refusal in (("compiled", UncompilableProgram),
                                ("vectorized",
                                 noc_vec.UnvectorizableProgram)):
            try:
                got = _run(prog, cfg, engine)
            except refusal:
                continue
            ran[engine] += 1
            if got != want:
                raise AssertionError(f"[noc] {label}: {engine} differs from "
                                     f"the heap engine")
    log(f"[noc] faulted corpus (quick): {len(progs)} programs "
        f"({n_sched} hierarchical schedules' lanes among them), "
        f"verify_faulted clean; heap {ran['heap']}, compiled "
        f"{ran['compiled']}, vectorized {ran['vectorized']} runs, equal "
        f"latency, ledger, done and delivered; "
        f"{time.perf_counter() - t0:.3f} s (host clock)")
    return ran


def phase_noc(smi: str) -> dict:
    """Phase 4d (see the module docstring)."""
    t_phase = time.perf_counter()
    root = _build.BUILD_DIR.parent / "noc"
    shutil.rmtree(root, ignore_errors=True)
    sweeps = noc_sweeps(root)
    backend = noc_torch_backend("cuda", smi)
    ran = noc_faulted_corpus()
    log(f"[noc] phase {time.perf_counter() - t_phase:.1f} s (host clock); "
        f"{smi}")
    return {"sweeps": sweeps, "backend": backend, "corpus": ran}


def phase_exact_f32() -> None:
    cfg = dataclasses.replace(ARCHS[ARCH], n_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = get_model(cfg).init(gen, device="cuda")
    report, legacy, _, _ = serve(cfg, params, "exact-f32", SERVE_ARGV[ARCH])
    for r in report.requests:
        i = int(r["rid"].removeprefix("req"))
        if r["tokens"] != legacy["tokens"][i].tolist():
            raise AssertionError(f"{r['rid']}: f32 engine tokens {r['tokens']}"
                                 f" != legacy {legacy['tokens'][i].tolist()}")
    log(f"[exact-f32] 2 layers, full width, float32: engine tokens equal the "
        f"legacy loop's for all {len(report.requests)} requests")


def forward_against_decode(model, params, tokens, label: str,
                           rtol: float = 0.0):
    """Logits of the forward pass over ``tokens`` [B, S] (wkv6, flash)
    against those of the per-token decode loop (neither) over the same
    tokens, at every position.  Returns (max |diff|, max (|diff| - rtol
    |forward|), max |forward logit|, positions whose greedy tokens
    differ)."""
    fwd = build_prefill(model).fn(params, {"tokens": tokens}).float()
    if not bool(torch.isfinite(fwd).all()):
        raise AssertionError(f"{label}: non-finite forward logits")
    step = build_serve_step(model)
    cache = model.init_cache(tokens.shape[0], tokens.shape[1], device="cuda")
    worst = torch.zeros((), device="cuda")
    over = torch.full((), -math.inf, device="cuda")
    flips = torch.zeros((), dtype=torch.long, device="cuda")
    for pos in range(tokens.shape[1]):
        nxt, cache, logits = step.fn(
            params, {"tokens": tokens[:, pos:pos + 1], "pos": pos}, cache)
        diff = (logits.float() - fwd[:, pos]).abs()
        worst = torch.maximum(worst, diff.max())
        over = torch.maximum(over, (diff - rtol * fwd[:, pos].abs()).max())
        flips += (nxt != torch.argmax(fwd[:, pos], dim=-1)).sum()
    return float(worst), float(over), float(fwd.abs().max()), int(flips)


def phase_rwkv_bf16() -> dict:
    cfg = dataclasses.replace(ARCHS[RWKV], n_layers=RWKV_DEPTH)
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, device="cuda")
    nparams = sum(t.numel() for t in _leaves(params))
    log(f"[rwkv] {RWKV}: {cfg.n_layers} of {ARCHS[RWKV].n_layers} layers "
        f"(cut for the run's time), d_model {cfg.d_model}, "
        f"{nparams / 1e9:.3f} B parameters in {cfg.dtype}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    tokens = torch.randint(3, cfg.vocab, (RWKV_FWD_B, RWKV_FWD_S),
                           generator=torch.Generator().manual_seed(11)
                           ).to("cuda")
    fwd = build_prefill(model)
    batch = {"tokens": tokens}

    reset_launches()
    t0 = time.perf_counter()
    logits = fwd.fn(params, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    expect = {"ina_matmul": MATMULS_PER_PASS["ssm"] * cfg.n_layers + 1,
              "flash_attention": 0, "wkv6": cfg.n_layers}
    log(f"[rwkv] forward B={RWKV_FWD_B} S={RWKV_FWD_S}: logits "
        f"{tuple(logits.shape)} {logits.dtype}, first call {first_ms:.1f} ms; "
        f"launches {launches}, expected {expect}; ina_matmul by regime "
        f"{im.launches_by_regime}")
    check_launches(launches, expect, ("ina_matmul", "wkv6"))
    if logits.shape != (RWKV_FWD_B, RWKV_FWD_S, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"rwkv forward: bad logits {logits.shape}")
    del logits
    prof = profile_step("rwkv_forward", lambda: fwd.fn(params, batch), steps=3)
    fwd_tokens_s = RWKV_FWD_B * RWKV_FWD_S / (prof["wall_ms"] / 1e3)
    log(f"[rwkv] forward {fwd_tokens_s:.0f} tokens/s (host clock)")
    # one paged decode step of 2 slots, the serve phase's decode shape
    step = build_paged_serve_step(model)
    cache = model.init_cache(2, 1, device="cuda")
    dbatch = {"tokens": torch.full((2, 1), 11, device="cuda"),
              "pos": torch.tensor([64, 70], device="cuda")}
    profile_step("rwkv_decode",
                 lambda: step.fn(params, dbatch, cache)[0].tolist())
    del cache

    # The decode loop runs no wkv6 (single-step update in plain PyTorch),
    # so it checks the kernel path independently.  300 tokens cross the
    # reference's 256-token chunk and end ragged.  Tolerance: the paths
    # differ in the WKV's f32 summation order (the kernel's recurrence
    # against per-step sums) and in the LoRA product's cuBLAS kernel
    # (M = 600 against M = 2), so a few bf16 values round to a neighbour.
    # The recurrent state carries each such difference to every later
    # position and the residual layers amplify it, so at a few hundred
    # positions the logits part by a few hundredths of their largest value.
    # The bound is 2^-3 of the largest logit, 32 bf16 ulps of it.  The
    # exact-f32 phase below holds the same two paths to 1e-4, so what is
    # left here is rounding; a wrong layout or wiring moves logits by their
    # own order, and check_wkv6 holds the kernel itself to one bf16 ulp.
    worst, _, scale, _ = forward_against_decode(
        model, params, tokens[:, :RWKV_PREFIX], "rwkv prefix")
    tol = 2.0 ** -3 * scale
    log(f"[rwkv] forward vs decode loop, {RWKV_PREFIX}-token prefix x "
        f"{RWKV_FWD_B}: max |diff| over every position {worst:.4g} <= tol "
        f"{tol:.4g} (2^-3 x max|logit| {scale:.4g})")
    if not worst <= tol:
        raise AssertionError(f"rwkv forward vs decode: {worst} > {tol}")

    report, legacy, serve_launches, _ = serve(cfg, params, "rwkv-serve",
                                           SERVE_ARGV[RWKV])
    # Both sides decode (the engine seats each prompt at B 1 and decodes 2
    # slots, the loop decodes 4 rows), so they differ only where the LoRA
    # product's cuBLAS kernel or a reduction depends on the batch; the
    # state carries each difference through the 64-token prompt and the
    # layers, as in the forward check above: the same 2^-3 bound.
    compare_with_legacy(report, legacy, "rwkv-serve", cfg.n_layers, bits=3)
    del params
    torch.cuda.empty_cache()
    return {"forward": launches, "serve": serve_launches}


def phase_rwkv_exact_f32() -> None:
    cfg = dataclasses.replace(ARCHS[RWKV], n_layers=2, dtype="float32")
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = model.init(gen, device="cuda")
    tokens = torch.randint(3, cfg.vocab, (1, RWKV_PREFIX),
                           generator=torch.Generator().manual_seed(12)
                           ).to("cuda")
    # elementwise |diff| <= atol + rtol |forward|, rtol = atol = 1e-4: in
    # float32 the two paths differ only in sum order
    reset_launches()
    worst, over, scale, _ = forward_against_decode(model, params, tokens,
                                                   "rwkv f32", rtol=1e-4)
    if read_launches()["wkv6"] != cfg.n_layers:
        raise AssertionError(f"f32 forward launched {read_launches()}")
    log(f"[rwkv-exact-f32] 2 layers, full width, float32: forward vs decode "
        f"loop over {RWKV_PREFIX} positions, max |diff| {worst:.3g} (max "
        f"|logit| {scale:.3g}); max(|diff| - 1e-4 |logit|) {over:.3g} <= "
        f"atol 1e-4")
    if not over <= 1e-4:
        raise AssertionError(f"rwkv f32 forward vs decode: {over} > 1e-4 "
                             f"beyond rtol 1e-4")
    report, legacy, _, _ = serve(cfg, params, "rwkv-exact-f32", SERVE_ARGV[RWKV])
    for r in report.requests:
        i = int(r["rid"].removeprefix("req"))
        if r["tokens"] != legacy["tokens"][i].tolist():
            raise AssertionError(f"{r['rid']}: f32 engine tokens {r['tokens']}"
                                 f" != legacy {legacy['tokens'][i].tolist()}")
    log(f"[rwkv-exact-f32] engine tokens equal the legacy loop's for all "
        f"{len(report.requests)} requests")
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phases 8-9: training
# --------------------------------------------------------------------------- #
# qwen2-1.5b at 8 of its 28 layers, to keep the whole run under 900 s: its
# checkpoint, written once and read three times, is 7.3 GB (10.7 GB at 14
# layers, 18.5 GB at the full depth)
TRAIN_ARGV = ["--arch", ARCH, "--layers", "8", "--steps", "8", "--batch",
              "4", "--seq", "1024", "--lr", "3e-4", "--ckpt-every", "4"]
TRAIN_SAVED = 4          # the newest checkpoint of 8 steps saved every 4
TRAIN_SPANS = ("flash_attention_backward", "adamw_update")
TRAIN_F32_B, TRAIN_F32_S = 2, 128


def train_launches(cfg) -> dict:
    """A train step's launches, derived from the code: each product of a
    pass (:func:`matmuls_per_pass`: 7 L + 1 for the dense family, 8 L + 1
    for rwkv6, the head outside the checkpointed layers) runs once forward
    and twice backward (dX and dW), and the layers' once more in their
    recompute, which stops only after a layer's last product (zamba2's
    and the vlm's checkpointed unit is a group, whisper's a layer of
    either stack), so the early stop of non-reentrant checkpointing cuts
    no launch; the vlm's ``wk``/``wv`` over the media take no dX, as
    the media take no gradient; flash attention and wkv6 run forward and
    recomputed, and their backwards launch no kernel.  Under
    ``cfg.remat_policy`` (:data:`repro_torch.models.remat.POLICIES`) the
    recompute reuses what the policy keeps and launches none of it: every
    projection under ``dots_nb`` and ``dots``, flash attention and wkv6
    under ``dots``."""
    keep = remat.POLICIES[cfg.remat_policy]
    per_pass = matmuls_per_pass(cfg) - 1
    no_dx = 2 * (cfg.n_layers // cfg.cross_attn_every) \
        if cfg.family == "vlm" else 0
    fused = 1 if "fused" in keep else 2
    return {"ina_matmul": 3 * (per_pass + 1) - no_dx
            + (0 if "nb" in keep else per_pass),
            "flash_attention": fused * flash_per_pass(cfg),
            "wkv6": fused * cfg.n_layers if cfg.family == "ssm" else 0}


def train_run(ck: str, label: str, device: str, argv=TRAIN_ARGV,
              phase: str = "train"):
    """One run of the training launcher (``argv``) into ``ck``; each step's
    launches are read, held to :func:`train_launches` (none generic) with
    a finite loss, and the counters set to 0 after it."""
    steps = []

    def on_step(step, metrics, dt):
        steps.append({"step": step, "loss": float(metrics["loss"]),
                      "seconds": dt, "launches": read_launches(),
                      "generic": im.launches_by_regime["generic"]})
        reset_launches()
    args = launch_train.build_parser().parse_args(
        argv + ["--ckpt-dir", ck, "--device", device])
    reset_launches()
    t0 = time.perf_counter()
    out = launch_train.run(args, on_step)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    in_steps = sum(s["seconds"] for s in steps)
    log(f"[{phase}] {label}: steps {out['steps']}, {secs:.1f} s, of which "
        f"{in_steps:.1f} s in the steps and {secs - in_steps:.1f} s outside "
        f"them (initial state, checkpoint save or restore); step seconds "
        + ", ".join(f"{s['seconds']:.3f}" for s in steps))
    expect = train_launches(launch_train._config(args))
    for s in steps:
        log(f"[{phase}] step {s['step']}: loss {s['loss']:.6f}, launches "
            f"{s['launches']}, expected {expect}, generic {s['generic']}")
        if s["launches"] != expect or s["generic"] != 0:
            raise AssertionError(f"train step {s['step']}: launches "
                                 f"{s['launches']} (generic {s['generic']})"
                                 f" != expected {expect}")
        if not math.isfinite(s["loss"]):
            raise AssertionError(f"train step {s['step']}: loss {s['loss']}")
    return out, steps


def phase_train(ck: str, device: str = "cuda") -> dict:
    """qwen2-1.5b at full width, 8 layers (:data:`TRAIN_ARGV`), through
    ``launch.train``: 8 steps
    at B 4 x S 1024, warmup 2, a checkpoint at step 4 into the empty
    directory ``ck``, then a second run into it, which must resume at step
    5 with step 5's loss bit-equal to the first run's (the same restored
    state and batch, and a forward that sums in a fixed order).  Then one
    step profiled.  The checkpoints stay in ``ck`` for ``[tp-train]``."""
    args = launch_train.build_parser().parse_args(TRAIN_ARGV
                                                  + ["--ckpt-dir", "-"])
    cfg = launch_train._config(args)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[train] {ARCH}: {cfg.n_layers} of {ARCHS[ARCH].n_layers} layers, "
        f"d_model {cfg.d_model}, "
        f"float32 masters, {cfg.dtype} compute, B {args.batch} x S "
        f"{args.seq}; checkpoints in a temporary directory with "
        f"{shutil.disk_usage(ck).free / 2 ** 30:.0f} GiB free")
    first, steps = train_run(ck, "run 1", device)
    peak = torch.cuda.max_memory_allocated()
    path = {k: sum(s["launches"][k] for s in steps)
            for k in steps[0]["launches"]}
    losses = first["losses"]
    log(f"[train] run 1: loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak "
        f"device memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); launches over the run "
        f"{path}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    first_losses = dict(zip(first["steps"], losses))
    del first
    torch.cuda.empty_cache()
    saved = latest_step(ck)
    second, _ = train_run(ck, "run 2 (resume)", device)
    if saved != TRAIN_SAVED or second["steps"][0] != saved + 1:
        raise AssertionError(f"resume: newest checkpoint {saved}, resumed at "
                             f"{second['steps'][0]}")
    diffs = {s: second_loss - first_losses[s] for s, second_loss
             in zip(second["steps"], second["losses"])}
    log(f"[train] resume: newest checkpoint at step {saved}, resumed at step "
        f"{second['steps'][0]}; loss against run 1's at the same step "
        + ", ".join(f"step {s} {d:+.3g}" for s, d in diffs.items()))
    if diffs[saved + 1] != 0.0:
        raise AssertionError(f"resumed step {saved + 1}'s loss differs from "
                             f"run 1's by {diffs[saved + 1]}")

    params, opt = second.pop("state")
    model = get_model(cfg)
    ts = build_train_step(model, ShapeConfig("cli", args.seq, args.batch,
                                             "train"),
                          base_lr=args.lr, warmup=2, total_steps=args.steps)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    batch = {k: v.to(device) for k, v in pipe.batch(0).items()}
    prof = profile_step("train", lambda: ts.fn(params, opt, batch), steps=2,
                        spans=TRAIN_SPANS)
    tokens = args.batch * args.seq
    log(f"[train] profiled step: wall {prof['wall_ms']:.1f} ms, device "
        f"{prof['device_ms']:.1f} ms, busy share "
        f"{prof['device_ms'] / prof['wall_ms']:.3f}, "
        f"{prof['kernels_per_step']} kernels a step; ina_matmul "
        f"{prof['ina_matmul_ms']:.1f} ms, flash_attention "
        f"{prof['flash_attention_ms']:.2f} ms, attention backward "
        f"{prof['span_ms']['flash_attention_backward']:.1f} ms, AdamW "
        f"{prof['span_ms']['adamw_update']:.1f} ms, other "
        f"{prof['other_ms']:.1f} ms; {tokens / prof['wall_ms'] * 1e3:.0f} "
        f"tokens/s (host clock); peak device memory {peak / 2 ** 30:.2f} GiB")
    policies = policy_steps(cfg, params, opt, batch, args, prof, peak)
    del params, opt, ts, batch, second
    torch.cuda.empty_cache()
    return {"launches": path, "profile": prof, "peak_bytes": peak,
            "policies": policies}


#: the remat policies a ``[train]`` step runs under beside ``nothing``
POLICIES = ("dots_nb", "dots")


def _cloned(tree):
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [_cloned(v) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return tree.clone() if torch.is_tensor(tree) else tree


def policy_step(cfg, policy: str, params, opt, batch, args) -> tuple:
    """One step of ``[train]``'s schedule under ``policy`` from a copy of
    ``(params, opt)``: (params after it, its stats, launches, generic
    launches, the step's peak device memory above what was allocated when
    it began, the step's function)."""
    model = get_model(dataclasses.replace(cfg, remat_policy=policy))
    ts = build_train_step(model, ShapeConfig("cli", args.seq, args.batch,
                                             "train"),
                          base_lr=args.lr, warmup=2, total_steps=args.steps)
    p, o = _cloned(params), _cloned(opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    reset_launches()
    p, o, st = ts.fn(p, o, batch)
    torch.cuda.synchronize()
    out = (p, {k: float(v) for k, v in st.items()}, read_launches(),
           im.launches_by_regime["generic"],
           torch.cuda.max_memory_allocated() - start)
    reset_launches()
    return out + (lambda: ts.fn(p, o, batch),)


def policy_steps(cfg, params, opt, batch, args, prof: dict,
                 peak: int) -> dict:
    """One step under ``nothing`` and under each of :data:`POLICIES` from
    the same state and batch: each policy's loss, ``grad_norm`` and every
    parameter after the step bit-equal to ``nothing``'s, its launches the
    derived counts (:func:`train_launches`) with none generic; then each
    policy's step profiled (device ms, busy share) and its peak device
    memory above the memory allocated when it began (the state, its copy
    and what the comparison holds), printed beside ``nothing``'s."""
    want, base, launches, generic, base_peak, fn = policy_step(
        cfg, "nothing", params, opt, batch, args)
    del fn
    rows = {"nothing": {"device_ms": prof["device_ms"],
                        "wall_ms": prof["wall_ms"], "peak_bytes": base_peak,
                        "launches": launches,
                        "ina_matmul_ms": prof["ina_matmul_ms"],
                        "flash_attention_ms": prof["flash_attention_ms"]}}
    if launches != train_launches(cfg) or generic:
        raise AssertionError(f"[train] nothing: launches {launches} (generic "
                             f"{generic}) != {train_launches(cfg)}")
    for policy in POLICIES:
        got, st, launches, generic, top, fn = policy_step(
            cfg, policy, params, opt, batch, args)
        expect = train_launches(dataclasses.replace(cfg,
                                                    remat_policy=policy))
        n = _same_state(got, want, f"train {policy} params")
        log(f"[train] {policy}: loss {st['loss']:.6f} (nothing "
            f"{base['loss']:.6f}), grad_norm {st['grad_norm']:.6f} "
            f"({base['grad_norm']:.6f}), {n} param leaves bit-equal to "
            f"nothing's; launches {launches}, expected {expect}, generic "
            f"{generic}")
        if (st["loss"], st["grad_norm"]) != (base["loss"], base["grad_norm"]) \
                or launches != expect or generic:
            raise AssertionError(f"[train] {policy}: the step is not "
                                 f"nothing's, or its launches are not "
                                 f"{expect}")
        del got
        p = profile_step(f"train_{policy}", fn, steps=1, spans=TRAIN_SPANS)
        rows[policy] = {"device_ms": p["device_ms"], "wall_ms": p["wall_ms"],
                        "peak_bytes": top, "launches": launches,
                        "ina_matmul_ms": p["ina_matmul_ms"],
                        "flash_attention_ms": p["flash_attention_ms"]}
        del fn
        torch.cuda.empty_cache()
    for policy, r in rows.items():
        log(f"[train] policy {policy}: device {r['device_ms']:.2f} ms a step "
            f"(ina_matmul {r['ina_matmul_ms']:.2f}, flash_attention "
            f"{r['flash_attention_ms']:.2f}), wall {r['wall_ms']:.1f} ms, "
            f"busy share "
            f"{r['device_ms'] / r['wall_ms']:.3f}, peak device memory "
            f"{gib(r['peak_bytes'])} above the step's start (one step from "
            f"the resumed state; the run's peak {gib(peak)}), launches "
            f"{r['launches']}")
    return rows


# --------------------------------------------------------------------------- #
# phase 8a: the dry-run's prediction against the card
# --------------------------------------------------------------------------- #
#: the dry-run's tolerances on the card: argument bytes (the allocator
#: rounds each block up to 512 bytes) and temp bytes (the peak above the
#: step's start)
DRYRUN_ARG_TOL, DRYRUN_TEMP_TOL = 0.005, 0.10


def _state_on_card(fn) -> tuple:
    """(``fn()``, the device memory it left allocated)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_allocated() - before


def phase_dryrun(train_prof: dict, smi: str) -> dict:
    """``[train]``'s step (8 layers, B 4 x S 1024, one rank, ``nothing``)
    and a decode step of the same model (B 4, a cache of 1024), each
    traced on ``meta`` by the dry-run (:func:`repro_torch.launch.dryrun.
    trace_step`, one rank) and then run once on the card from a fresh
    state: the predicted launches equal the card's counters, the
    predicted argument bytes lie within :data:`DRYRUN_ARG_TOL` of the
    memory the state takes, the train step's and a prefill's (B 4 x S
    1024, whose peak holds the head's logits, a kernel's output) predicted
    temp within :data:`DRYRUN_TEMP_TOL` of the card's peak above the
    step's start, and the decode step's predicted bytes are at least its
    weights'.  The
    step's predicted FLOPs over ``[train]``'s profiled device ms
    (``train_prof``) give its share of 989 TFLOP/s bf16."""
    fresh_phase()
    args = launch_train.build_parser().parse_args(TRAIN_ARGV
                                                  + ["--ckpt-dir", "-"])
    cfg = launch_train._config(args)
    model = get_model(cfg)
    one = mesh.RankMesh((1, 1), ("data", "model"))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    t0 = time.perf_counter()
    pred = dryrun.trace_step(cfg, shape, one)
    trace_s = time.perf_counter() - t0

    def state():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = model.init(gen, device="cuda", masters=True)
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch))
        return params, adamw_init(params), \
            {k: v.to("cuda") for k, v in pipe.batch(0).items()}
    (params, opt, batch), held = _state_on_card(state)
    ts = build_train_step(model, shape, base_lr=args.lr, warmup=2,
                          total_steps=args.steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    reset_launches()
    params, opt, stats = ts.fn(params, opt, batch)
    torch.cuda.synchronize()
    top = torch.cuda.max_memory_allocated() - start
    path = read_launches()
    card = {k: v for k, v in path.items() if v}
    reset_launches()
    if not math.isfinite(float(stats["loss"])):
        raise AssertionError(f"[dryrun] train step loss {stats['loss']}")
    del params, opt, batch, stats, ts
    arg_err = abs(pred.argument_bytes - held) / held
    temp_ratio = pred.temp_bytes / top
    device_ms = train_prof["device_ms"]
    tflops = pred.flops / device_ms / 1e9
    log(f"[dryrun] train step traced on meta in {trace_s:.1f} s: launches "
        f"{pred.launches}, card {card}; argument bytes {pred.argument_bytes}"
        f" predicted, {held} allocated for the state ({arg_err:.3%} apart, "
        f"tolerance {DRYRUN_ARG_TOL:.1%}); temp {gib(pred.temp_bytes)} "
        f"predicted, the card's peak above the step's start {gib(top)}: "
        f"ratio {temp_ratio:.4f} (tolerance {DRYRUN_TEMP_TOL:.0%}); "
        f"{pred.flops:.4e} FLOPs ({pred.products:.4e} in products and "
        f"kernels, {pred.other_flops:.4e} elementwise), "
        f"{pred.bytes:.4e} bytes")
    log(f"[dryrun] train step: {pred.flops:.4e} FLOPs over [train]'s "
        f"{device_ms:.2f} device ms = {tflops:.1f} TFLOP/s, "
        f"{tflops / (PEAK_OPS[torch.bfloat16] / 1e12):.2%} of 989 TFLOP/s "
        f"bf16 (products and kernels alone "
        f"{pred.products / device_ms / 1e9:.1f} TFLOP/s) on {smi}")
    if pred.launches != card:
        raise AssertionError(f"[dryrun] predicted launches {pred.launches} "
                             f"!= the card's {card}")
    if arg_err > DRYRUN_ARG_TOL:
        raise AssertionError(f"[dryrun] argument bytes {pred.argument_bytes}"
                             f" against {held} allocated")
    if abs(temp_ratio - 1) > DRYRUN_TEMP_TOL:
        raise AssertionError(f"[dryrun] temp {pred.temp_bytes} against the "
                             f"card's peak above the start {top}")
    fresh_phase()

    pshape = ShapeConfig("cli", args.seq, args.batch, "prefill")
    ppred = dryrun.trace_step(cfg, pshape, one)

    def prefill_state():
        gen = torch.Generator(device="cuda").manual_seed(0)
        weights = model.init(gen, device="cuda")
        tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                               generator=gen, dtype=torch.int32,
                               device="cuda")
        return weights, {"tokens": tokens}
    (weights, pbatch), pheld = _state_on_card(prefill_state)
    fn = build_prefill(model).fn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    reset_launches()
    logits = fn(weights, pbatch)
    torch.cuda.synchronize()
    ptop = torch.cuda.max_memory_allocated() - start
    pcard = {k: v for k, v in read_launches().items() if v}
    reset_launches()
    parg_err = abs(ppred.argument_bytes - pheld) / pheld
    ptemp_ratio = ppred.temp_bytes / ptop
    log(f"[dryrun] prefill (B {args.batch} x S {args.seq}): launches "
        f"{ppred.launches}, card {pcard}; argument bytes "
        f"{ppred.argument_bytes} predicted, {pheld} allocated "
        f"({parg_err:.3%} apart); temp {gib(ppred.temp_bytes)} predicted, "
        f"the card's peak above the step's start {gib(ptop)}: ratio "
        f"{ptemp_ratio:.4f} (tolerance {DRYRUN_TEMP_TOL:.0%}; the logits "
        f"{gib(logits.numel() * logits.element_size())})")
    if ppred.launches != pcard or parg_err > DRYRUN_ARG_TOL \
            or abs(ptemp_ratio - 1) > DRYRUN_TEMP_TOL:
        raise AssertionError("[dryrun] the prefill's prediction disagrees "
                             "with the card")
    if tuple(logits.shape) != (args.batch, args.seq, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[dryrun] prefill logits {tuple(logits.shape)}")
    del weights, pbatch, logits
    fresh_phase()

    dshape = ShapeConfig("cli", args.seq, args.batch, "decode")
    dpred = dryrun.trace_step(cfg, dshape, one)

    def serve_state():
        gen = torch.Generator(device="cuda").manual_seed(0)
        weights = model.init(gen, device="cuda")
        cache = model.init_cache(args.batch, args.seq, device="cuda")
        step = {"tokens": torch.zeros(args.batch, 1, dtype=torch.int32,
                                      device="cuda"),
                "pos": torch.full((args.batch,), args.seq // 2,
                                  dtype=torch.int32, device="cuda")}
        return weights, cache, step
    (weights, cache, step), dheld = _state_on_card(serve_state)
    fn = build_serve_step(model).fn
    reset_launches()
    tok, _, logits = fn(weights, step, cache)
    torch.cuda.synchronize()
    dcard = {k: v for k, v in read_launches().items() if v}
    reset_launches()
    wbytes = weight_bytes(weights, tied=cfg.tie_embeddings)
    darg_err = abs(dpred.argument_bytes - dheld) / dheld
    log(f"[dryrun] decode step (B {args.batch}, cache {args.seq}): launches "
        f"{dpred.launches}, card {dcard}; {dpred.bytes:.4e} bytes predicted "
        f"against {wbytes:.4e} of weights read; argument bytes "
        f"{dpred.argument_bytes} predicted, {dheld} allocated "
        f"({darg_err:.3%} apart); {dpred.flops:.4e} FLOPs")
    if dpred.launches != dcard or dpred.bytes < wbytes \
            or darg_err > DRYRUN_ARG_TOL:
        raise AssertionError("[dryrun] the decode step's prediction "
                             "disagrees with the card")
    if tuple(logits.shape) != (args.batch, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[dryrun] decode logits {tuple(logits.shape)}")
    del weights, cache, step, tok, logits
    fresh_phase()
    return {"launches": path, "decode_launches": dcard,
            "argument_error": arg_err, "temp_ratio": temp_ratio,
            "prefill_temp_ratio": ptemp_ratio, "tflops": tflops}


# --------------------------------------------------------------------------- #
# phase 8b: tensor-parallel training at one rank, and the elastic checkpoint
# --------------------------------------------------------------------------- #
TP_TRAIN_STEPS = 2


def tp_train_steps(model, shape, pctx, batches, args) -> tuple:
    """[train]'s seeded masters and zero AdamW state, and ``batches`` run
    through ``build_train_step`` with ``pctx``: (params, each step's loss,
    grad_norm, launches, generic launches and collective calls)."""
    params, opt = launch_train.initial_state(model, args.device)
    ts = build_train_step(model, shape, pctx, base_lr=args.lr,
                          warmup=min(20, args.steps // 5 + 1),
                          total_steps=args.steps)   # the launcher's schedule
    steps = []
    for batch in batches:
        reset_launches()
        C.CALLS.clear()
        t0 = time.perf_counter()
        params, opt, st = ts.fn(params, opt, batch)
        torch.cuda.synchronize()
        steps.append({"loss": float(st["loss"]),
                      "grad_norm": float(st["grad_norm"]),
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "launches": read_launches(),
                      "generic": im.launches_by_regime["generic"],
                      "calls": dict(C.CALLS)})
    del opt
    return params, steps


def _timed(label: str, fn, phase: str = "tp-train"):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    log(f"[{phase}] {label}: {time.perf_counter() - t0:.2f} s")
    return out


def _same_state(a, b, label: str) -> int:
    """Assert every tensor of two train states equal to the bit; returns
    the leaves compared."""
    pairs = list(zip(_state_leaves(a), _state_leaves(b)))
    for i, (x, y) in enumerate(pairs):
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"[tp-train] {label}: leaf {i} differs")
    return len(pairs)


def _state_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _state_leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _state_leaves(v)
    else:
        yield tree


def phase_tp_train(ck: str, smi: str, device: str = "cuda") -> dict:
    """``[tp-train]``: ``[train]``'s qwen2-1.5b (published widths, 14
    layers) trained
    through the tensor-parallel step on a one-rank NCCL group, under every
    CLI psum mode: 2 steps at B 4 x S 1024 from ``[train]``'s seed on its
    first batches, each mode's losses, grad norms and params bit-equal to
    the step without a group, with the derived 227 ``ina_matmul`` (none
    generic) and 16 ``flash_attention`` launches a step and no collective
    call.  Then ``[train]``'s step-4 checkpoint in ``ck`` restored through
    ``elastic_restore`` at world 1, bit-equal to the ``CheckpointManager``
    restore, and cut for every rank of world 2, then of world 4 (one world
    at a time: the float32 state is 10.7 GB): ``unshard_state`` of each
    world's cuts gives the state back bit for bit."""
    args = launch_train.build_parser().parse_args(
        TRAIN_ARGV + ["--ckpt-dir", ck, "--device", device])
    cfg = launch_train._config(args)
    model = get_model(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    batches = [{k: v.to(device) for k, v in pipe.batch(i).items()}
               for i in range(TP_TRAIN_STEPS)]
    expect = train_launches(cfg)
    fresh_phase()
    log(f"[tp-train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"B {args.batch} x S {args.seq}, {TP_TRAIN_STEPS} steps a mode; "
        f"{smi}")
    base, base_steps = _timed("groupless steps", lambda: tp_train_steps(
        model, shape, None, batches, args))
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_group_") as tmp:
        group, _ = mesh.init_group(1, 0, device, os.path.join(tmp, "store"))
        try:
            for mode in C.CLI_PSUM_MODES:
                pctx = ParallelCtx(group=group, psum_mode=mode)
                params, steps = _timed(f"{mode} steps", lambda: tp_train_steps(
                    model, shape, pctx, batches, args))
                for s, b in zip(steps, base_steps):
                    log(f"[tp-train] {mode}: loss {s['loss']:.6f} (groupless "
                        f"{b['loss']:.6f}), grad_norm {s['grad_norm']:.6f} "
                        f"({b['grad_norm']:.6f}), {s['ms']:.1f} ms "
                        f"(groupless {b['ms']:.1f}), launches "
                        f"{s['launches']}, generic {s['generic']}, "
                        f"collective calls {s['calls']}")
                    if (s["loss"], s["grad_norm"]) != (b["loss"],
                                                       b["grad_norm"]):
                        raise AssertionError(f"[tp-train] {mode}: the step "
                                             f"differs from the groupless one")
                    if s["launches"] != expect or s["generic"] != 0:
                        raise AssertionError(f"[tp-train] {mode}: launches "
                                             f"{s['launches']} != {expect}")
                    if s["calls"]:
                        raise AssertionError(f"[tp-train] {mode}: collective "
                                             f"calls {s['calls']} at one rank")
                n = _same_state(params, base, f"{mode} params")
                log(f"[tp-train] {mode}: {n} param leaves bit-equal to the "
                    f"groupless step's after {TP_TRAIN_STEPS} steps")
                paths[mode] = {k: sum(s["launches"][k] for s in steps)
                               for k in expect}
                del params
        finally:
            dist.destroy_process_group()
    step = latest_step(ck)
    like = (base, AdamWState(step=torch.zeros((), dtype=torch.int32,
                                              device=device),
                             m=base, v=base))
    managed, at = _timed("CheckpointManager restore", lambda: CheckpointManager(
        ck).restore_or_none(like))
    elastic, at_e = _timed("elastic_restore at world 1", lambda: elastic_restore(
        like, ck, cfg, 0, 1))
    if (at, at_e) != (TRAIN_SAVED, TRAIN_SAVED) or step != TRAIN_SAVED:
        raise AssertionError(f"[tp-train] restored steps {at}, {at_e}")
    n = _timed("compare", lambda: _same_state(elastic, managed,
                                               "elastic_restore"))
    log(f"[tp-train] elastic_restore at world 1: {n} leaves bit-equal to the "
        f"CheckpointManager restore of step {at}")
    del managed, like, base
    torch.cuda.empty_cache()
    for world in (2, 4):
        cuts = _timed(f"cut for the {world} ranks", lambda: [
            shard_state(elastic, cfg, r, world) for r in range(world)])
        back = _timed(f"unshard_state of the {world} cuts",
                      lambda: unshard_state(cuts, cfg, world))
        n = _timed("compare", lambda: _same_state(back, elastic,
                                                   f"world {world}"))
        kv = [cuts[r][0]["layers"]["attn"]["wk"].shape[-1]
              for r in range(world)]
        log(f"[tp-train] world {world}: every rank's cut rejoined, {n} leaves "
            f"bit-equal (wk columns a rank {kv}; ranks sharing a KV head "
            f"{kv_groups(cfg, world)})")
        del cuts, back
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    log(f"[tp-train] peak device memory {gib(peak)}; {smi}")
    del elastic
    fresh_phase()
    return paths


# --------------------------------------------------------------------------- #
# phase 8c: the train step on the rank mesh, and the compressed psum
# --------------------------------------------------------------------------- #
#: the leaf held against the CPU's compressed psum (11 M elements)
COMPRESSED_LEAF = ("layers", "attn", "wk")


def _leaf(tree, names):
    for k in names:
        tree = tree[k]
    return tree


def check_compressed_psum(grads, group, smi: str) -> dict:
    """``compressed_psum`` of the whole gradient tree over the one-rank
    ``group`` under each codec: seconds, peak memory above the gradients,
    the largest error against the gradient itself (the mean of one rank),
    and :data:`COMPRESSED_LEAF` bit-equal to the same function on the CPU
    (no group: one rank)."""
    out = {}
    cpu = {"w": _leaf(grads, COMPRESSED_LEAF).cpu()}
    for codec in ("none", "int8", "topk"):
        fresh_phase()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state = compression.CompressionState.init(grads)
        reduced, state = compression.compressed_psum(grads, state, group,
                                                     codec)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        err = max(float((r.float() - g.float()).abs().max()) for r, g in
                  zip(tree_leaves(reduced), tree_leaves(grads)))
        largest = max(float(g.abs().max()) for g in tree_leaves(grads))
        want, want_state = compression.compressed_psum(
            cpu, compression.CompressionState.init(cpu), None, codec)
        got = _leaf(reduced, COMPRESSED_LEAF).cpu()
        got_err = _leaf(state.err, COMPRESSED_LEAF).cpu()
        same = torch.equal(got, want["w"]) and \
            torch.equal(got_err, want_state.err["w"])
        log(f"[dp-train] compressed_psum {codec}: {secs:.3f} s over "
            f"{len(tree_leaves(grads))} leaves "
            f"({sum(g.numel() for g in tree_leaves(grads)) / 1e6:.1f} M "
            f"elements), peak {gib(peak)} above the gradients, largest "
            f"error against the gradient {err:.3g} (largest gradient "
            f"{largest:.3g}); {'/'.join(COMPRESSED_LEAF)} and its residual "
            f"{'bit-equal' if same else 'DIFFER'} on the CPU; {smi}")
        if not same:
            raise AssertionError(f"[dp-train] compressed_psum {codec}: "
                                 f"{'/'.join(COMPRESSED_LEAF)} differs from "
                                 f"the CPU's")
        out[codec] = {"seconds": secs, "peak_bytes": peak, "max_err": err}
        del reduced, state
    # the largest top-k: the embedding's, k = 5% of its elements
    embed = grads["embed"]
    fresh_phase()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sparse, err = compression.topk_encode(embed, torch.zeros_like(
        embed, dtype=torch.float32))
    torch.cuda.synchronize()
    log(f"[dp-train] topk_encode of the embedding gradient "
        f"{tuple(embed.shape)} ({embed.numel() / 1e6:.1f} M elements, k "
        f"{int(embed.numel() * 0.05) / 1e6:.2f} M, its zero residual "
        f"included): {time.perf_counter() - t0:.3f} s, peak "
        f"{gib(torch.cuda.max_memory_allocated() - base)} above the "
        f"gradients; {smi}")
    del sparse, err
    return out


def phase_dp_train(smi: str, device: str = "cuda") -> dict:
    """``[dp-train]``: ``[train]``'s qwen2-1.5b (published widths, 14
    layers) trained
    through the train step on the rank mesh ``make_host_mesh(cards, 1)``
    at ``(data 1, model 1)``, a one-rank NCCL group as its model, data and
    pod groups (so every gather and reduction of the data axis takes its
    one-rank exit): 2 steps at B 4 x S 1024 from ``[train]``'s seed on its
    first batches (the step given its rows of them, ``TrainStep.rows``),
    losses, grad norms and params bit-equal to the step without a group,
    with 227 ``ina_matmul`` (none generic) and 16 ``flash_attention``
    launches a step and no collective call.  Then the compressed psum of
    one step's gradient tree (:func:`check_compressed_psum`) and the
    launcher's refusal of ``--production-mesh`` on fewer than 256
    ranks."""
    args = launch_train.build_parser().parse_args(
        TRAIN_ARGV + ["--ckpt-dir", "-", "--device", device])
    cfg = launch_train._config(args)
    model = get_model(cfg)
    ranks = launch_train.rank_mesh(args)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    batches = [{k: v.to(device) for k, v in pipe.batch(i).items()}
               for i in range(TP_TRAIN_STEPS)]
    expect = train_launches(cfg)
    fresh_phase()
    log(f"[dp-train] {cfg.name}: the launcher's rank mesh on "
        f"{torch.cuda.device_count()} card(s) is {ranks.pairs}; this phase "
        f"runs (data 1, model 1), B {args.batch} x S {args.seq}, "
        f"{TP_TRAIN_STEPS} steps; {smi}")
    base, base_steps = _timed("groupless steps", lambda: tp_train_steps(
        model, shape, None, batches, args), "dp-train")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_group_") as tmp:
        group, _ = mesh.init_group(1, 0, device, os.path.join(tmp, "store"))
        try:
            pctx = ParallelCtx(group=group, data_group=group,
                               pod_group=group)
            ts = build_train_step(model, shape, pctx)
            if (ts.host, ts.hosts) != (0, 1):
                raise AssertionError(f"[dp-train] host {ts.host} of "
                                     f"{ts.hosts}")
            params, steps = _timed("rank-mesh steps", lambda: tp_train_steps(
                model, shape, pctx, [ts.rows(b) for b in batches], args),
                "dp-train")
            for s, b in zip(steps, base_steps):
                log(f"[dp-train] loss {s['loss']:.6f} (groupless "
                    f"{b['loss']:.6f}), grad_norm {s['grad_norm']:.6f} "
                    f"({b['grad_norm']:.6f}), {s['ms']:.1f} ms (groupless "
                    f"{b['ms']:.1f}), launches {s['launches']}, generic "
                    f"{s['generic']}, collective calls {s['calls']}")
                if (s["loss"], s["grad_norm"]) != (b["loss"], b["grad_norm"]):
                    raise AssertionError("[dp-train] the step differs from "
                                         "the groupless one")
                if s["launches"] != expect or s["generic"] != 0:
                    raise AssertionError(f"[dp-train] launches "
                                         f"{s['launches']} != {expect}")
                if s["calls"]:
                    raise AssertionError(f"[dp-train] collective calls "
                                         f"{s['calls']} at one rank")
            n = _same_state(params, base, "rank-mesh params")
            log(f"[dp-train] {n} param leaves bit-equal to the groupless "
                f"step's after {TP_TRAIN_STEPS} steps")
            path = {k: sum(s["launches"][k] for s in steps) for k in expect}
            del base
            _, grads = loss_and_grads(model, params, batches[0])
            del params
            codecs = check_compressed_psum(grads, group, smi)
            del grads
        finally:
            dist.destroy_process_group()
    argv = TRAIN_ARGV + ["--ckpt-dir", "-", "--device", device,
                         "--production-mesh"]
    try:
        launch_train.main(argv)
    except RuntimeError as e:
        if "256 ranks" not in str(e):
            raise
        log(f"[dp-train] --production-mesh refused: {e}")
    else:
        raise AssertionError("[dp-train] --production-mesh ran on "
                             f"{torch.cuda.device_count()} card(s)")
    fresh_phase()
    return {"launches": path, "compressed": codecs}


@contextlib.contextmanager
def plain_kernels(attention=None):
    """The three kernels replaced by their plain versions (the wrappers'
    CPU path) on CUDA tensors, in the forward's direct calls and inside
    the autograd Functions, which stay; flash attention's by
    ``attention(q, k, v, causal, q_offset)`` where given
    (:func:`attention_f64`)."""
    mm, omm, att, wkv = im.ina_matmul, ops.ina_matmul, fa._attention, \
        wk._wkv
    plain = lambda x, w, plan=None, tiles=None: \
        im.ina_matmul_plain(x, w, plan)  # noqa: E731
    im.ina_matmul = ops.ina_matmul = plain
    fa._attention = attention or (lambda q, k, v, causal, q_offset:
                                  fa.flash_attention_heads_plain(
                                      q, k, v, causal=causal,
                                      q_offset=int(q_offset)))
    wk._wkv = wk.wkv6_heads_plain
    try:
        yield
    finally:
        im.ina_matmul, ops.ina_matmul, fa._attention, wk._wkv = \
            mm, omm, att, wkv


def attention_f64(q, k, v, causal, q_offset) -> torch.Tensor:
    """Flash attention's function, q [B, Sq, H, D] over k/v [B, Sk, KVH, D]
    (GQA grouped, the causal mask anchored at ``q_offset``), evaluated in
    float64 and cast to q's dtype: the exact side of the float32 train
    checks (:func:`against_plain`).  On an H100 the kernel's float32
    output at zamba2's head dim of 160 is within 1.9e-7 of it, relative
    to its largest, and the plain float32 version within 3.7e-7: against
    the plain version those checks would measure the reference's own
    rounding more than the kernel's, and Mamba2's ``A_log`` gradient,
    a sum that cancels to a fiftieth of its terms, carries it past their
    bound."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.double()) / math.sqrt(d)
    if causal:
        qpos = torch.arange(sq, device=q.device) + int(q_offset)
        s = s.masked_fill(qpos[:, None] < torch.arange(
            sk, device=q.device)[None, :], float("-inf"))
    return torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1),
                        v.double()).reshape(b, sq, h, d).to(q.dtype)


def phase_train_f32(device: str = "cuda") -> None:
    """One step's loss and gradients at the full widths, 2 layers, float32,
    through the kernels and through their plain versions on the card.

    Tolerance: the f32 ``ina_matmul`` repeats its plain version's
    arithmetic (one FMA a k, in order), the attention backward is the
    same code on both sides, and the plain side's attention forward is
    exact (:func:`attention_f64`), so the two differ only by the flash
    kernel's f32 rounding, and in the embedding gradient's atomic adds;
    ~1e-6 relative.  Loss within
    1e-5 of itself; each gradient element within 1e-4 of itself plus 1e-5
    of its leaf's largest, the bound tests/test_torch_train.py holds the
    port to against jax.grad.  A wrong or missing term moves a leaf by
    its own order."""
    cfg = dataclasses.replace(ARCHS[ARCH], n_layers=2, dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(2),
                        device=device, masters=True)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_F32_S,
                                    global_batch=TRAIN_F32_B, seed=3))
    batch = {k: v.to(device) for k, v in pipe.batch(0).items()}
    reset_launches()
    loss, grads = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches(launches, train_launches(cfg),
                   ("ina_matmul", "flash_attention"))
    against_plain(model, params, batch, loss, grads, launches, "train-f32")
    del params, grads
    torch.cuda.empty_cache()


def against_plain(model, params, batch, loss, grads, launches,
                  phase: str) -> None:
    """The same step's loss and gradients through the plain versions
    (:func:`plain_kernels`; flash attention's forward in float64,
    :func:`attention_f64`), launching nothing, held to
    :func:`phase_train_f32`'s bound: loss within 1e-5 of itself, each
    gradient element within 1e-4 of itself plus 1e-5 of its leaf's
    largest."""
    t0 = time.perf_counter()
    with plain_kernels(attention_f64):
        ploss, pgrads = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if read_launches() != launches:
        raise AssertionError(f"[{phase}] the plain step launched a kernel")
    worst, names = (0.0, "none"), 0
    for (name, got), (_, want) in zip(_named_tensors(grads),
                                      _named_tensors(pgrads)):
        scale = float(want.abs().max())
        over = float(((got - want).abs() - 1e-4 * want.abs()).max())
        diff = float((got - want).abs().max()) / max(scale, 1e-30)
        if diff > worst[0]:
            worst = (diff, name)
        names += 1
        if not over <= 1e-5 * scale or scale == 0.0:
            raise AssertionError(f"{phase}: gradient leaf {name} differs: "
                                 f"{over} > 1e-5 x {scale}")
    dloss = abs(float(loss) - float(ploss))
    cfg = model.cfg
    depth = f"{cfg.encoder_layers} + {cfg.n_layers}" \
        if cfg.family == "encdec" else str(cfg.n_layers)
    log(f"[{phase}] {cfg.name}: {depth} layers, full width, float32, B "
        f"{TRAIN_F32_B} x S {TRAIN_F32_S}: launches {launches}; loss "
        f"{float(loss):.6f}, plain {float(ploss):.6f} (|diff| {dloss:.3g}); "
        f"{names} gradient leaves, largest |diff| over the leaf's largest "
        f"|gradient| {worst[0]:.3g} ({worst[1]}; bound 1e-5 beyond rtol "
        f"1e-4); the plain "
        f"step {plain_s:.1f} s")
    if not dloss <= 1e-5 * abs(float(ploss)):
        raise AssertionError(f"{phase} loss {float(loss)} != plain "
                             f"{float(ploss)}")


# --------------------------------------------------------------------------- #
# phases 10-12: the MoE families
# --------------------------------------------------------------------------- #
EXPERTS_SPAN = "moe_experts"


def gib(nbytes: float) -> str:
    return f"{nbytes / 2 ** 30:.2f} GiB"


def fresh_phase() -> None:
    """Free what earlier phases left in the allocator's cache and start the
    peak-memory count anew."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def moe_forward(model, params, tokens, label: str) -> dict:
    """One forward through ``build_prefill`` at ``tokens`` [B, S]: launches
    counted and held to the derived counts (flash attention once a layer
    for the GQA family, never for MLA), logits finite and of their shape;
    the dropped share of (token, expert) assignments printed."""
    cfg = model.cfg
    fwd = build_prefill(model)
    reset_launches()
    t0 = time.perf_counter()
    with moe_model.record_routing() as calls:
        logits = fwd.fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    expect = {"ina_matmul": matmuls_per_pass(cfg),
              "flash_attention": flash_per_pass(cfg), "wkv6": 0}
    b, sq = tokens.shape
    share = moe_model.dropped_share(calls)
    log(f"[{label}] forward B={b} S={sq}: logits {tuple(logits.shape)} "
        f"{logits.dtype}, first call {first_ms:.1f} ms; launches {launches}, "
        f"expected {expect}; ina_matmul by regime {im.launches_by_regime}; "
        f"capacity {moe_model.capacity(b * sq, cfg.moe)} slots an expert for "
        f"{b * sq} tokens x top-{cfg.moe.top_k} over {cfg.moe.num_experts} "
        f"experts: {share:.4%} of the assignments dropped")
    check_launches(launches, expect, [k for k, v in expect.items() if v])
    if logits.shape != (b, sq, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label} forward: bad logits {logits.shape}")
    return {"launches": launches, "logits": logits}


def weight_bytes(params: dict, tied: bool = False) -> int:
    """Bytes a decode step reads of the weights: every leaf but the
    embedding table, of which it reads a row a token, unless ``tied``: the
    tied head reads all of it (encdec's ``pos_dec`` a row a token too)."""
    return sum(t.numel() * t.element_size() for name, v in params.items()
               if (tied or name != "embed") and name != "pos_dec"
               for t in _leaves({name: v}))


def expert_bytes(params: dict) -> int:
    return sum(params["layers"]["mlp"][k].numel()
               * params["layers"]["mlp"][k].element_size()
               for k in ("w_gate", "w_up", "w_down"))


def profile_moe_decode(model, params, label: str, argv) -> None:
    """One paged decode step of 2 slots, one at the end of the prompt and
    one a few tokens further, on the serve phase's cache (``argv``'s prompt
    + generated + 1 positions), profiled; its bound: the weights it reads
    once (:func:`weight_bytes`) over the card's HBM rate."""
    args = launch_serve.build_parser().parse_args(argv)
    step = build_paged_serve_step(model)
    cache = model.init_cache(2, serve_cache(argv), device="cuda")
    pos = [args.prompt_len, args.prompt_len + args.gen // 2]
    batch = {"tokens": torch.full((2, 1), 11, device="cuda"),
             "pos": torch.tensor(pos, device="cuda")}
    prof = profile_step(label, lambda: step.fn(params, batch,
                                               cache)[0].tolist(),
                        spans=(EXPERTS_SPAN,))
    nbytes = weight_bytes(params)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    experts = prof["span_ms"][EXPERTS_SPAN]
    log(f"[{label}] decode step, 2 slots at {pos} of {serve_cache(argv)}: "
        f"wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms, "
        f"busy share {prof['device_ms'] / prof['wall_ms']:.3f}, "
        f"{prof['kernels_per_step']} kernels; ina_matmul "
        f"{prof['ina_matmul_ms']:.2f} ms, expert products (torch.bmm) "
        f"{experts:.2f} ms, the rest {prof['other_ms'] - experts:.2f} ms; "
        f"bound {bound_ms:.2f} ms ({nbytes / 1e9:.2f} GB of weights, "
        f"{expert_bytes(params) / 1e9:.2f} GB of them the routed experts, at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): wall "
        f"{prof['wall_ms'] / bound_ms:.2f}x the bound, device "
        f"{prof['device_ms'] / bound_ms:.2f}x")


def batch_witness(cfg, params, report, argv, label: str) -> None:
    """Where the bf16 engine and the legacy loop of 4 rows part: the loop
    run again at the engine's seating batch, one request a run, and at 4
    rows, both on a cache of the engine's length.

    A request run alone goes through the same ``build_serve_step`` at the
    same batch and cache length as the engine's seating, and the engine's
    paged decode treats each slot as a B 1 decode (its own routing group,
    rows summed independently), so its first-token logits must equal the
    engine's to the bit and its tokens the engine's, token for token.
    Against the loop of 4 rows it then differs by the batch alone: each
    prompt position and MoE layer whose top-k set of experts differs
    between the two is counted (the first printed), beside the first-token
    logits' gap."""
    args = launch_serve.build_parser().parse_args(argv)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    seated = args.prompt_len * n_moe              # the prompt's MoE calls
    cache = serve_cache(argv)

    def experts(calls, rows):
        """[positions x layers, rows, k] of the prompt, each set sorted."""
        return torch.stack([c.experts for c in calls[:seated]])[:, rows] \
            .sort(-1).values

    with moe_model.record_routing() as wide_calls:
        wide = launch_serve.run_legacy(args, cfg, params, max_seq=cache)
    for r in report.requests:
        i = int(r["rid"].removeprefix("req"))
        with moe_model.record_routing() as calls:
            one = launch_serve.run_legacy(args, cfg, params, rows=[i],
                                          max_seq=cache)
        if not torch.equal(r["first_logits"], one["first_logits"][0]):
            diff = float((r["first_logits"].float()
                          - one["first_logits"][0].float()).abs().max())
            raise AssertionError(f"{r['rid']}: the engine's first-token "
                                 f"logits differ from the same seating run "
                                 f"alone by {diff}")
        if r["tokens"] != one["tokens"][0].tolist():
            raise AssertionError(f"{r['rid']}: engine tokens {r['tokens']} "
                                 f"!= the loop's alone "
                                 f"{one['tokens'][0].tolist()}")
        flips = (experts(wide_calls, i) != experts(calls, 0)).any(-1) \
            .nonzero().flatten().tolist()
        gap = float((wide["first_logits"][i].float()
                     - one["first_logits"][0].float()).abs().max())
        first = (f"the first at position {flips[0] // n_moe}, MoE layer "
                 f"{flips[0] % n_moe}" if flips else "none")
        log(f"[{label}] {r['rid']} alone (B 1, cache {cache}): first-token "
            f"logits equal the engine's to the bit, and all "
            f"{len(r['tokens'])} tokens the engine's; against the loop of "
            f"{args.batch} rows on the same cache: first-token logits max "
            f"|diff| {gap:.4g}, top-{cfg.moe.top_k} expert sets differ at "
            f"{len(flips)} of {seated} (prompt position, MoE layer) pairs, "
            f"{first}")


def phase_mla() -> dict:
    """deepseek-v2-lite-16b at its published widths, :data:`MLA_DEPTH`
    layers (see the module docstring)."""
    fresh_phase()
    cfg = dataclasses.replace(ARCHS[MLA], n_layers=MLA_DEPTH)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    nparams = sum(t.numel() for t in _leaves(params))
    log(f"[mla] {MLA}: {cfg.n_layers} of {ARCHS[MLA].n_layers} layers "
        f"({cfg.moe.first_dense_layers} dense; cut for the run's time), "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads (q/k "
        f"{cfg.mla.qk_nope_head_dim}+{cfg.mla.qk_rope_head_dim}, v "
        f"{cfg.mla.v_head_dim}), {cfg.moe.num_experts} routed top-"
        f"{cfg.moe.top_k} + {cfg.moe.num_shared} shared experts, vocab "
        f"{cfg.vocab}; {nparams / 1e9:.3f} B parameters in {cfg.dtype}; "
        f"{matmuls_per_pass(cfg)} ina_matmul a pass (derived); "
        f"peak {gib(torch.cuda.max_memory_allocated())}")
    report, legacy, serve_launches, _ = serve(cfg, params, "mla-serve",
                                           SERVE_ARGV[MLA])
    # The engine seats each prompt at B 1 and decodes 2 slots routed one a
    # group; the loop decodes 4 rows routed as one group.  The witness
    # below runs the loop at B 1: its logits and tokens equal the engine's
    # to the bit, and its top-6 expert sets differ from the loop of 4
    # rows' at hundreds of the prompt's 1664 (position, layer) pairs,
    # from the first positions on: cuBLAS rounds the router's and the
    # experts' bf16 products otherwise at 4 rows, and random router
    # weights leave the 6th and 7th experts' probabilities within that
    # rounding.  Each swap trades one 1/6-weighted expert output for
    # another's, and the latent cache carries it through the layers: the
    # rwkv phase's 2^-3 of the largest logit.
    compare_with_legacy(report, legacy, "mla-serve", cfg.n_layers, bits=3)
    batch_witness(cfg, params, report, SERVE_ARGV[MLA], "mla-serve")
    profile_moe_decode(model, params, "mla", SERVE_ARGV[MLA])
    tokens = torch.randint(3, cfg.vocab, (1, MOE_FWD_S),
                           generator=torch.Generator().manual_seed(13)
                           ).to("cuda")
    fwd = moe_forward(model, params, tokens, "mla")
    del fwd["logits"]
    forward = profile_step("mla_forward", lambda: build_prefill(model).fn(
        params, {"tokens": tokens}), steps=3, spans=(EXPERTS_SPAN,))
    log(f"[mla] forward {MOE_FWD_S / (forward['wall_ms'] / 1e3):.0f} tokens/s "
        f"(host clock); expert products "
        f"{forward['span_ms'][EXPERTS_SPAN]:.2f} device ms; peak "
        f"{gib(torch.cuda.max_memory_allocated())} "
        f"(torch.cuda.max_memory_allocated)")
    del params
    fresh_phase()
    return {"serve": serve_launches, "forward": fwd["launches"]}


def phase_mla_f32() -> None:
    """The same widths at 2 layers (1 dense, 1 MoE) in float32."""
    fresh_phase()
    cfg = dataclasses.replace(ARCHS[MLA], n_layers=2, dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    tokens = torch.randint(3, cfg.vocab, (1, MOE_FWD_S),
                           generator=torch.Generator().manual_seed(14)
                           ).to("cuda")
    got = moe_forward(model, params, tokens, "mla-f32")
    launches = read_launches()
    t0 = time.perf_counter()
    with plain_kernels():
        want = build_prefill(model).fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if read_launches() != launches:
        raise AssertionError("the plain forward launched a kernel")
    # elementwise |diff| <= atol + rtol |plain|, rtol = atol = 1e-4: the f32
    # ina_matmul repeats its plain version's arithmetic, so the two differ
    # where cuBLAS's f32 products (router, experts, attention) see other
    # rounding upstream; a routing flip would show far beyond
    diff = (got["logits"] - want).abs()
    over = float((diff - 1e-4 * want.abs()).max())
    log(f"[mla-f32] 2 layers, full width, float32, B 1 x S {MOE_FWD_S}: "
        f"kernels against their plain versions on the card, max |diff| "
        f"{float(diff.max()):.3g} (max |logit| {float(want.abs().max()):.3g}); "
        f"max(|diff| - 1e-4 |plain|) {over:.3g} <= atol 1e-4; the plain "
        f"forward {plain_s:.1f} s")
    if not over <= 1e-4:
        raise AssertionError(f"mla f32 forward: {over} > 1e-4 beyond rtol")
    del got, want, diff
    # 8 tokens: the forward's capacity is min(max(8, .), 8) = 8, no drop,
    # so it equals the per-token decode loop (capacity 1, no drop)
    worst, over, scale, _ = forward_against_decode(
        model, params, tokens[:, :8], "mla f32", rtol=1e-4)
    log(f"[mla-f32] forward vs decode loop over 8 positions: max |diff| "
        f"{worst:.3g} (max |logit| {scale:.3g}); max(|diff| - 1e-4 |logit|) "
        f"{over:.3g} <= atol 1e-4")
    if not over <= 1e-4:
        raise AssertionError(f"mla f32 forward vs decode: {over} > 1e-4")
    report, legacy, _, _ = serve(cfg, params, "mla-f32", SERVE_ARGV[MLA])
    for r in report.requests:
        i = int(r["rid"].removeprefix("req"))
        if r["tokens"] != legacy["tokens"][i].tolist():
            raise AssertionError(f"{r['rid']}: f32 engine tokens {r['tokens']}"
                                 f" != legacy {legacy['tokens'][i].tolist()}")
    log(f"[mla-f32] engine tokens equal the legacy loop's for all "
        f"{len(report.requests)} requests; peak "
        f"{gib(torch.cuda.max_memory_allocated())}")
    del params
    fresh_phase()


def phase_moe() -> dict:
    """llama4-scout-17b-16e at its published widths, depth cut."""
    fresh_phase()
    full = ARCHS[MOE]
    cfg = dataclasses.replace(full, n_layers=MOE_DEPTH)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    nparams = sum(t.numel() for t in _leaves(params))
    per_layer = sum(t.numel() for t in _leaves(params["layers"])) / MOE_DEPTH
    whole = nparams + per_layer * (full.n_layers - MOE_DEPTH)
    log(f"[moe] {MOE}: depth cut to {MOE_DEPTH} of {full.n_layers} layers "
        f"(the whole model is {whole / 1e9:.1f} B parameters, "
        f"{whole * 2 / 1e9:.0f} GB in bf16, past one card's 80 GB); "
        f"d_model {cfg.d_model}, GQA {cfg.n_heads}:{cfg.n_kv_heads}, "
        f"{cfg.moe.num_experts} routed top-{cfg.moe.top_k} + "
        f"{cfg.moe.num_shared} shared experts of {cfg.moe.d_ff_expert}, vocab "
        f"{cfg.vocab}; {nparams / 1e9:.3f} B parameters here; "
        f"{matmuls_per_pass(cfg)} ina_matmul a pass (derived); peak "
        f"{gib(torch.cuda.max_memory_allocated())}")
    tokens = torch.randint(3, cfg.vocab, (1, MOE_FWD_S),
                           generator=torch.Generator().manual_seed(15)
                           ).to("cuda")
    fwd = moe_forward(model, params, tokens, "moe")
    del fwd["logits"]
    forward = profile_step("moe_forward", lambda: build_prefill(model).fn(
        params, {"tokens": tokens}), steps=3, spans=(EXPERTS_SPAN,))
    log(f"[moe] forward {MOE_FWD_S / (forward['wall_ms'] / 1e3):.0f} tokens/s "
        f"(host clock); expert products "
        f"{forward['span_ms'][EXPERTS_SPAN]:.2f} device ms")
    profile_moe_decode(model, params, "moe", SERVE_ARGV[MOE])
    report, legacy, serve_launches, _ = serve(cfg, params, "moe-serve",
                                           SERVE_ARGV[MOE])
    # As [mla]'s, through 4 layers; the top-1 choice can swap a whole
    # expert's output where two router probabilities lie within rounding,
    # in a prompt of 16: the same 2^-3 of the largest logit.
    compare_with_legacy(report, legacy, "moe-serve", cfg.n_layers, bits=3)
    log(f"[moe] peak {gib(torch.cuda.max_memory_allocated())}")
    del params
    fresh_phase()
    return {"serve": serve_launches, "forward": fwd["launches"]}


# --------------------------------------------------------------------------- #
# phases 13-16: the hybrid, vlm and encdec families
# --------------------------------------------------------------------------- #
def family_forward(model, params, batch: dict, label: str) -> dict:
    """One forward through ``build_prefill`` on ``batch``: launches held
    to the derived counts (:func:`matmuls_per_pass`,
    :func:`flash_per_pass`), none generic; logits finite and of their
    shape."""
    cfg = model.cfg
    fwd = build_prefill(model)
    reset_launches()
    t0 = time.perf_counter()
    logits = fwd.fn(params, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    expect = {"ina_matmul": matmuls_per_pass(cfg),
              "flash_attention": flash_per_pass(cfg), "wkv6": 0}
    b, sq = batch["tokens"].shape
    log(f"[{label}] forward B={b} S={sq}"
        + (f" over {batch['media'].shape[1]} media rows" if "media" in batch
           else "")
        + f": logits {tuple(logits.shape)} {logits.dtype}, first call "
        f"{first_ms:.1f} ms; launches {launches}, expected {expect}; "
        f"ina_matmul by regime {im.launches_by_regime}")
    check_launches(launches, expect, ("ina_matmul", "flash_attention"))
    if logits.shape != (b, sq, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label} forward: bad logits {logits.shape}")
    return {"launches": launches, "logits": logits}


def profile_forward(model, params, batch: dict, label: str) -> dict:
    """Three forwards on ``batch`` profiled, and their tokens/s."""
    prof = profile_step(f"{label}_forward", lambda: build_prefill(model).fn(
        params, batch), steps=3)
    log(f"[{label}] forward "
        f"{batch['tokens'].numel() / (prof['wall_ms'] / 1e3):.0f} tokens/s "
        f"(host clock)")
    return prof


def media(cfg, rows: int, seed: int) -> torch.Tensor:
    """Seeded N(0, 1) stand-ins for the stub frontend's embeddings."""
    return torch.randn(rows, cfg.num_media_tokens, cfg.d_model,
                       generator=torch.Generator().manual_seed(seed)
                       ).to("cuda", getattr(torch, cfg.dtype))


def family_params(cfg, label: str, seed: int = 0) -> dict:
    """Seeded random weights on the card, their size printed."""
    params = get_model(cfg).init(torch.Generator(device="cuda")
                                 .manual_seed(seed), device="cuda")
    nparams = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[{label}] {cfg.name}: {nparams / 1e9:.3f} B parameters in "
        f"{cfg.dtype} ({nbytes / 1e9:.2f} GB); "
        f"{matmuls_per_pass(cfg)} ina_matmul and {flash_per_pass(cfg)} "
        f"flash_attention a forward (derived); peak "
        f"{gib(torch.cuda.max_memory_allocated())}")
    return params


def encoder_ops(cfg, rows: int) -> float:
    """Operations of whisper's encoder over ``rows`` x its frames (which
    its decode step runs again): each layer's six products, 2 x M x K x N,
    and its attention, 4 x F^2 x d_model a row."""
    f, d = cfg.num_media_tokens, cfg.d_model
    products = 2.0 * rows * f * (4 * d * d + 2 * d * cfg.d_ff)
    return cfg.encoder_layers * (products + 4.0 * rows * f * f * d)


def profile_decode(model, params, label: str, batch: dict, cache: dict,
                   step) -> dict:
    """One decode step (``step``: a paged or legacy serve step's ``fn``)
    profiled; its bound: the weights it reads once (the tied head reads
    the whole embedding) over the card's HBM rate, or for encdec the
    encoder's operations over the bf16 peak where that is longer."""
    prof = profile_step(label, lambda: step(params, batch, cache)[0].tolist())
    nbytes = weight_bytes(params, tied="lm_head" not in params)
    ops_ = encoder_ops(model.cfg, batch["tokens"].shape[0]) \
        if model.cfg.family == "encdec" else 0.0
    bound_ms, bound_by = bound(nbytes, ops_, torch.bfloat16)
    log(f"[{label}] decode step, {batch['tokens'].shape[0]} rows: wall "
        f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms, busy "
        f"share {prof['device_ms'] / prof['wall_ms']:.3f}, "
        f"{prof['kernels_per_step']} kernels; bound {bound_ms:.2f} ms "
        f"({bound_by}: {nbytes / 1e9:.2f} GB of weights at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s"
        + (f", {ops_ / 1e12:.2f} T operations of the encoder at "
           f"{PEAK_OPS[torch.bfloat16] / 1e12:.0f} T/s" if ops_ else "")
        + f"): device {prof['device_ms'] / bound_ms:.2f}x the bound")
    prof["bound_ms"], prof["bound_by"] = bound_ms, bound_by
    return prof


def legacy_launches(cfg, args) -> dict:
    """The launches of one legacy-loop serve of ``args`` (the media
    families' serve path), derived from the code: vlm's
    ``prefill_media_kv`` (wk, wv a cross layer), then a decode step a
    position (:func:`matmuls_per_pass` with the media's K/V cached for
    vlm; the encoder again each step for encdec, its flash included)."""
    steps = args.prompt_len + args.gen
    media_kv = 2 * (cfg.n_layers // cfg.cross_attn_every) \
        if cfg.family == "vlm" else 0
    return {"ina_matmul": media_kv + steps
            * matmuls_per_pass(cfg, media_cached=True),
            "flash_attention": flash_per_pass(cfg, decode=True) * steps,
            "wkv6": 0}


def legacy_serve(cfg, params, phase: str, argv) -> dict:
    """The legacy loop (the only serve path of the media families) with
    its launches held to the derived counts (:func:`legacy_launches`).
    Then the forward over the same prompts and media (flash attention,
    the cross-attention's over the media included) against the loop's
    logits after the prompt (plain attention of one query a step): within
    2^-3 of the largest logit, the bound of the rwkv and MoE phases (bf16
    rounding in other places, carried through every layer); a wrong mask,
    media row or cache write moves logits by their own order."""
    args = launch_serve.build_parser().parse_args(argv)
    model = get_model(cfg)
    reset_launches()
    legacy = launch_serve.run_legacy(args, cfg, params)
    torch.cuda.synchronize()
    launches = read_launches()
    expect = legacy_launches(cfg, args)
    secs = (legacy["prefill_ms"] + legacy["decode_ms"]) / 1e3
    total = legacy["tokens"].numel()
    log(f"[{phase}] legacy loop: {args.batch} rows, prompt "
        f"{args.prompt_len}, {args.gen} more: {total} tokens, "
        f"{total / secs:.1f} tok/s; prefill {legacy['prefill_ms']:.1f} ms, "
        f"decode {legacy['decode_ms']:.1f} ms; launches {launches}, "
        f"expected {expect}; ina_matmul by regime {im.launches_by_regime}")
    check_launches(launches, expect,
                   [k for k, v in expect.items() if v])
    by_regime = dict(im.launches_by_regime)
    prompts = launch_serve.make_prompts(cfg, args.batch,
                                        args.prompt_len).to("cuda")
    ones = torch.ones(args.batch, cfg.num_media_tokens, cfg.d_model,
                      dtype=getattr(torch, cfg.dtype), device="cuda")
    fwd = build_prefill(model).fn(params, {"tokens": prompts, "media": ones})
    last = fwd[:, -1].float()
    scale = float(last.abs().max())
    diff = float((last - legacy["first_logits"].float()).abs().max())
    same = int((torch.argmax(last, dim=-1).cpu()
                == legacy["tokens"][:, 0]).sum())
    log(f"[{phase}] forward over the {args.batch} prompts (flash) against "
        f"the loop's logits after them: max |diff| {diff:.4g} <= tol "
        f"{2.0 ** -3 * scale:.4g} (2^-3 x max|logit| {scale:.4g}); first "
        f"greedy token equal in {same} of {args.batch} rows")
    if not (diff <= 2.0 ** -3 * scale and bool(torch.isfinite(fwd).all())):
        raise AssertionError(f"{phase}: forward vs legacy loop {diff}")
    return {"launches": launches, "by_regime": by_regime, "legacy": legacy}


def legacy_decode_profile(model, params, label: str, argv) -> dict:
    """One step of the legacy loop's serve step at its rows, at the last
    prompt position, on media of ones (vlm: the media K/V prefilled)."""
    cfg = model.cfg
    rows, plen = legacy_rows(argv)
    cache = model.init_cache(rows, serve_cache(argv), device="cuda")
    batch = {"tokens": torch.full((rows, 1), 11, device="cuda"),
             "pos": plen,
             "media": torch.ones(rows, cfg.num_media_tokens, cfg.d_model,
                                 dtype=getattr(torch, cfg.dtype),
                                 device="cuda")}
    if cfg.family == "vlm":
        cache = vision.prefill_media_kv(params, cfg, batch["media"], cache)
    return profile_decode(model, params, label, batch, cache,
                          build_serve_step(model).fn)


def phase_hybrid() -> dict:
    """zamba2-2.7b as published (bf16, nothing cut)."""
    fresh_phase()
    cfg = ARCHS[HYBRID]
    model = get_model(cfg)
    g = cfg.n_layers // cfg.shared_attn_every
    log(f"[hybrid] {HYBRID}: {cfg.n_layers} Mamba2 layers (d_inner "
        f"{cfg.ssm.expand * cfg.d_model}, {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim}"
        f" heads of {cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, SSD chunk "
        f"{cfg.ssm.chunk}) and {g} invocations of the shared block "
        f"({cfg.shared_attn_heads} heads of {2 * cfg.d_model // cfg.shared_attn_heads}"
        f" over 2 x d_model), d_model {cfg.d_model}, vocab {cfg.vocab}, "
        f"tied head")
    params = family_params(cfg, "hybrid")
    tokens = torch.randint(3, cfg.vocab, (1, FAMILY_FWD_S[HYBRID]),
                           generator=torch.Generator().manual_seed(16)
                           ).to("cuda")
    with record_shapes() as seen:
        fwd = family_forward(model, params, {"tokens": tokens}, "hybrid")
        del fwd["logits"]
        report, legacy, serve_launches, _ = serve(cfg, params,
                                                  "hybrid-serve",
                                                  SERVE_ARGV[HYBRID])
    check_shapes(seen, "hybrid")
    # As rwkv's: the engine seats each prompt at B 1 and decodes 2 slots,
    # the loop decodes 4 rows, so they part where cuBLAS's bf16 einsums of
    # the SSD step depend on the batch; the Mamba2 states carry each
    # difference through the 32-token prompt and 54 layers: 2^-3.
    compare_with_legacy(report, legacy, "hybrid-serve", cfg.n_layers, bits=3)
    fwd["profile"] = profile_forward(model, params, {"tokens": tokens},
                                     "hybrid")
    args = launch_serve.build_parser().parse_args(SERVE_ARGV[HYBRID])
    cache = model.init_cache(2, serve_cache(SERVE_ARGV[HYBRID]),
                             device="cuda")
    pos = [args.prompt_len, args.prompt_len + args.gen // 2]
    decode = profile_decode(
        model, params, "hybrid_decode",
        {"tokens": torch.full((2, 1), 11, device="cuda"),
         "pos": torch.tensor(pos, device="cuda")}, cache,
        build_paged_serve_step(model).fn)
    log(f"[hybrid] peak {gib(torch.cuda.max_memory_allocated())}")
    del params
    fresh_phase()
    return {"forward": fwd["launches"], "serve": serve_launches,
            "profile": {"forward": fwd["profile"], "decode": decode}}


def phase_hybrid_f32() -> None:
    """zamba2-2.7b's widths, 2 groups (12 Mamba2 layers, 2 shared-block
    invocations), float32."""
    fresh_phase()
    cfg = dataclasses.replace(ARCHS[HYBRID], dtype="float32",
                              n_layers=HYBRID_F32_GROUPS
                              * ARCHS[HYBRID].shared_attn_every)
    model = get_model(cfg)
    params = family_params(cfg, "hybrid-f32", seed=1)
    tokens = torch.randint(3, cfg.vocab, (1, HYBRID_F32_S),
                           generator=torch.Generator().manual_seed(17)
                           ).to("cuda")
    with record_shapes() as seen:
        got = family_forward(model, params, {"tokens": tokens}, "hybrid-f32")
        launches = read_launches()
        t0 = time.perf_counter()
        with plain_kernels():
            want = build_prefill(model).fn(params, {"tokens": tokens})
            torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if read_launches() != launches:
            raise AssertionError("the plain forward launched a kernel")
        # elementwise |diff| <= atol + rtol |plain|, rtol = atol = 1e-4:
        # the f32 ina_matmul repeats its plain version's arithmetic and the
        # f32 flash kernel sums in another order than its plain version;
        # cuBLAS's f32 SSD einsums see that rounding upstream
        diff = (got["logits"] - want).abs()
        over = float((diff - 1e-4 * want.abs()).max())
        log(f"[hybrid-f32] {cfg.n_layers} layers, full width, float32, B 1 x "
            f"S {HYBRID_F32_S}: kernels against their plain versions on the "
            f"card, max |diff| {float(diff.max()):.3g} (max |logit| "
            f"{float(want.abs().max()):.3g}); max(|diff| - 1e-4 |plain|) "
            f"{over:.3g} <= atol 1e-4; the plain forward {plain_s:.1f} s")
        if not over <= 1e-4:
            raise AssertionError(f"hybrid f32 forward: {over} > 1e-4 beyond "
                                 f"rtol")
        del got, want, diff
        # the decode loop: single-step SSD updates and plain attention of
        # one query, against the chunked SSD and flash; in float32 the two
        # differ in sum order only
        worst, over, scale, flips = forward_against_decode(
            model, params, tokens, "hybrid f32", rtol=1e-4)
    check_shapes(seen, "hybrid-f32")
    log(f"[hybrid-f32] forward vs decode loop over {HYBRID_F32_S} positions "
        f"(SSD chunks of {cfg.ssm.chunk}: one carried state): max |diff| "
        f"{worst:.3g} (max |logit| {scale:.3g}); max(|diff| - 1e-4 |logit|) "
        f"{over:.3g} <= atol 1e-4; greedy tokens differ at {flips} of "
        f"{HYBRID_F32_S} positions")
    if not (over <= 1e-4 and flips == 0):
        raise AssertionError(f"hybrid f32 forward vs decode: {over} > 1e-4 "
                             f"or {flips} tokens differ")
    del params
    fresh_phase()


def phase_vlm() -> dict:
    """llama-3.2-vision-11b as published (bf16, nothing cut)."""
    fresh_phase()
    cfg = ARCHS[VLM]
    model = get_model(cfg)
    g = cfg.n_layers // cfg.cross_attn_every
    log(f"[vlm] {VLM}: {cfg.n_layers - g} self layers and {g} gated "
        f"cross-attention layers (qk-norm) over {cfg.num_media_tokens} media "
        f"rows, d_model {cfg.d_model}, GQA {cfg.n_heads}:{cfg.n_kv_heads}, "
        f"vocab {cfg.vocab}")
    params = family_params(cfg, "vlm")
    # the reference initialises both gates at 0, so every cross layer's
    # output would be multiplied by tanh(0) = 0; at 0.5 (tanh 0.46) the
    # media reach the logits
    for name in ("gate_attn", "gate_mlp"):
        params["xlayers"][name].fill_(0.5)
    batch = {"tokens": torch.randint(3, cfg.vocab, (1, FAMILY_FWD_S[VLM]),
                                     generator=torch.Generator()
                                     .manual_seed(18)).to("cuda"),
             "media": media(cfg, 1, 19)}
    with record_shapes() as seen:
        fwd = family_forward(model, params, batch, "vlm")
        del fwd["logits"]
        served = legacy_serve(cfg, params, "vlm-serve", SERVE_ARGV[VLM])
    check_shapes(seen, "vlm")
    fwd["profile"] = profile_forward(model, params, batch, "vlm")
    decode = legacy_decode_profile(model, params, "vlm_decode",
                                   SERVE_ARGV[VLM])
    log(f"[vlm] peak {gib(torch.cuda.max_memory_allocated())}")
    del params
    fresh_phase()
    return {"forward": fwd["launches"], "serve": served["launches"],
            "profile": {"forward": fwd["profile"], "decode": decode}}


def phase_encdec() -> dict:
    """whisper-medium as published (bf16, nothing cut)."""
    fresh_phase()
    cfg = ARCHS[ENCDEC]
    model = get_model(cfg)
    log(f"[encdec] {ENCDEC}: {cfg.encoder_layers} encoder layers over "
        f"{cfg.num_media_tokens} frames (non-causal) and {cfg.n_layers} "
        f"decoder layers (causal + cross-attention), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, vocab {cfg.vocab} (tied head: embed.T read "
        f"k-major, row stride {cfg.d_model})")
    params = family_params(cfg, "encdec")
    batch = {"tokens": torch.randint(3, cfg.vocab, (1, FAMILY_FWD_S[ENCDEC]),
                                     generator=torch.Generator()
                                     .manual_seed(20)).to("cuda"),
             "media": media(cfg, 1, 21)}
    with record_shapes() as seen:
        fwd = family_forward(model, params, batch, "encdec")
        del fwd["logits"]
        served = legacy_serve(cfg, params, "encdec-serve",
                              SERVE_ARGV[ENCDEC])
    check_shapes(seen, "encdec")
    fwd["profile"] = profile_forward(model, params, batch, "encdec")
    decode = legacy_decode_profile(model, params, "encdec_decode",
                                   SERVE_ARGV[ENCDEC])
    log(f"[encdec] peak {gib(torch.cuda.max_memory_allocated())}")
    del params
    fresh_phase()
    return {"forward": fwd["launches"], "serve": served["launches"],
            "profile": {"forward": fwd["profile"], "decode": decode}}


# --------------------------------------------------------------------------- #
# phase 17: the non-dense families through their tensor-parallel code
# --------------------------------------------------------------------------- #
#: the sequence-sharded stream's cases (``ParallelCtx`` keywords) that
#: ``[tp-families]``' forward runs beside every psum mode; the first is
#: ``[train-families]``' one step under it
RS_CASES = {"ina+rs_seq": {"psum_mode": "ina", "rs_seq": True},
            "ina+rs_seq+sp_entry": {"psum_mode": "ina", "rs_seq": True,
                                    "sp_entry": True}}


def tp_cases(rs: tuple = tuple(RS_CASES)) -> dict:
    """Case name -> ``ParallelCtx`` keywords: every psum mode, then the
    :data:`RS_CASES` named in ``rs``."""
    return {**{m: {"psum_mode": m} for m in C.CLI_PSUM_MODES},
            **{name: RS_CASES[name] for name in rs}}


def tp_family_forward(model, params, batch: dict, group, rank: int,
                      world: int) -> dict:
    """The forward of ``batch`` through ``build_prefill``, without a group
    and then under each psum mode and each :data:`RS_CASES` case (the
    stream sequence-sharded: at one rank the whole sequence is the rank's
    slice) on ``group`` over this rank's shard: each run's launches, and
    whether its logits equal the groupless run's to the bit (with their
    largest difference)."""
    shard = shard_params(params, model.cfg, rank, world)
    runs = {}
    for mode, kw in {"none": None, **tp_cases()}.items():
        pctx = None if kw is None else ParallelCtx(group=group, **kw)
        reset_launches()
        logits = build_prefill(model, pctx).fn(
            params if pctx is None else shard, batch)
        torch.cuda.synchronize()
        runs[mode] = {"launches": read_launches(),
                      "by_regime": dict(im.launches_by_regime)}
        if mode == "none":
            base = logits
            finite = bool(torch.isfinite(logits).all())
        else:
            runs[mode]["equal"] = bool(torch.equal(logits, base))
            runs[mode]["max_diff"] = float((logits.float()
                                            - base.float()).abs().max())
        del logits
    return {"runs": runs, "finite": finite}


def tp_family_rank(rank, world, group, device) -> dict:
    """One rank of ``[tp-families]``: each family of
    :data:`TP_FAMILY_ARGV` on its seeded weights (vlm's gates at 0.5, as
    ``[vlm]``'s), served once without a group (``run_engine``; the legacy
    loop on media of ones for vlm and whisper, as ``launch/serve.py``
    serves them) and then under each psum mode through
    ``launch/serve.py``'s ``serve_rank`` on ``group``, then its forward
    (the family phase's tokens and media) likewise
    (:func:`tp_family_forward`), each run's kernel launches counted; the
    launch shapes of all of them recorded.  Rank 0 prints.  Returns plain
    data only."""
    quiet = contextlib.nullcontext() if rank == 0 else \
        contextlib.redirect_stdout(io.StringIO())
    fwd_shape = {RWKV: (RWKV_FWD_B, RWKV_FWD_S), MLA: (1, MOE_FWD_S),
                 MOE: (1, MOE_FWD_S), HYBRID: (1, FAMILY_FWD_S[HYBRID]),
                 VLM: (1, FAMILY_FWD_S[VLM]),
                 ENCDEC: (1, FAMILY_FWD_S[ENCDEC])}
    out = {}
    with quiet:
        for arch, argv in TP_FAMILY_ARGV.items():
            args = launch_serve.build_parser().parse_args(
                argv + ["--device", str(device)])
            cfg = launch_serve.config(args)
            t0 = time.perf_counter()
            params = get_model(cfg).init(
                torch.Generator(device=device).manual_seed(0), device=device)
            if cfg.family == "vlm":
                for name in ("gate_attn", "gate_mlp"):
                    params["xlayers"][name].fill_(0.5)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            batch = {"tokens": torch.randint(
                3, cfg.vocab, fwd_shape[arch],
                generator=torch.Generator().manual_seed(16)).to(device)}
            if cfg.family in MEDIA_FAMILIES:
                batch["media"] = media(cfg, 1, 21)
                passes = args.prompt_len + args.gen   # the loop's steps
                expect = legacy_launches(cfg, args)
            runs = {}
            with record_shapes() as seen:
                forward = tp_family_forward(get_model(cfg), params, batch,
                                            group, rank, world)
                for mode in ("none",) + C.CLI_PSUM_MODES:
                    reset_launches()
                    t0 = time.perf_counter()
                    if mode != "none":
                        tokens = launch_serve.serve_rank(
                            rank, world, group, device,
                            argv + ["--psum-mode", mode], params=params)
                    elif cfg.family in MEDIA_FAMILIES:
                        tokens = launch_serve.run_legacy(
                            args, cfg, params)["tokens"].tolist()
                    else:
                        report = launch_serve.run_engine(args, cfg, params)
                        tokens = [report.tokens()[f"req{i}"]
                                  for i in range(args.batch)]
                        passes = report.prefill_chunks + report.decode_steps
                        expect = {"ina_matmul": matmuls_per_pass(cfg)
                                  * passes, "flash_attention": 0, "wkv6": 0}
                    torch.cuda.synchronize()
                    runs[mode] = {"tokens": tokens,
                                  "launches": read_launches(),
                                  "by_regime": dict(im.launches_by_regime),
                                  "s": time.perf_counter() - t0}
            out[arch] = {"runs": runs, "passes": passes, "expect": expect,
                         "seen": seen, "forward": forward,
                         "tokens": tuple(batch["tokens"].shape),
                         "init_s": init_s, "n_layers": cfg.n_layers,
                         "per_pass": matmuls_per_pass(cfg),
                         "flash_per_pass": flash_per_pass(cfg),
                         "peak": torch.cuda.max_memory_allocated()}
            del params, batch
            fresh_phase()
    return out


def phase_tp_families() -> dict:
    """The six non-dense families served as ``--model-parallel`` serves
    them, on a one-rank NCCL group (one card: NCCL takes one rank a
    device), under every psum mode: tokens bit-equal to the same requests
    served without a group (the engine; vlm and whisper the legacy loop),
    and the kernel launches of every run (so of every step: the schedule
    is the same) equal to the groupless run's, which are the derived
    counts; then each family's forward (B 2 x S 2048 for rwkv, B 1 x S
    2048 for the MoE families, zamba2 and vlm, whisper's 448 tokens over
    its 1500 frames) likewise, under every mode and under the
    sequence-sharded stream (:data:`RS_CASES`), logits bit-equal; every
    launch shape held against its plain version in phase 2.  Returns each
    run's launches by path."""
    fresh_phase()
    log(f"[tp-families] {RWKV} (4 layers), {MLA} (2 layers), {MOE} "
        f"({MOE_DEPTH} layers), {HYBRID}, {VLM} and {ENCDEC} at their "
        f"published widths through "
        f"their tensor-parallel code on an NCCL group of 1 rank, one "
        f"process, under every psum mode (the forward also under "
        f"{' and '.join(RS_CASES)}), beside the same requests served "
        f"without a group; worlds 2 and 4 run on gloo on the CPU "
        f"(tests/test_torch_tp_families.py, "
        f"tests/test_torch_tp_hybrid_media.py), and phase 2 held their "
        f"rank-local kernel shapes")
    t0 = time.perf_counter()
    out = mesh.spawn(tp_family_rank, 1, "cuda")[0]
    paths = {}
    for arch, res in out.items():
        runs, passes, expect = res["runs"], res["passes"], res["expect"]
        base = runs["none"]
        serve = "legacy serve" if arch in (VLM, ENCDEC) else "serve"
        if base["launches"] != expect or base["by_regime"]["generic"]:
            raise AssertionError(f"[tp-families] {arch} without a group: "
                                 f"launches {base['launches']} (by regime "
                                 f"{base['by_regime']}) != expected {expect}")
        for mode, run in runs.items():
            if run["tokens"] != base["tokens"]:
                raise AssertionError(f"[tp-families] {arch} {mode}: tokens "
                                     f"{run['tokens']} != without a group "
                                     f"{base['tokens']}")
            if (run["launches"], run["by_regime"]) != \
                    (base["launches"], base["by_regime"]):
                raise AssertionError(
                    f"[tp-families] {arch} {mode}: launches {run['launches']}"
                    f" {run['by_regime']} != without a group "
                    f"{base['launches']} {base['by_regime']}")
            if mode != "none":
                paths[f"{arch} tp {serve} W=1 {mode}"] = run["launches"]
        fwd = res["forward"]["runs"]
        expect = {"ina_matmul": res["per_pass"],
                  "flash_attention": res["flash_per_pass"],
                  "wkv6": res["n_layers"] if arch == RWKV else 0}
        if fwd["none"]["launches"] != expect \
                or fwd["none"]["by_regime"]["generic"] \
                or not res["forward"]["finite"]:
            raise AssertionError(f"[tp-families] {arch} forward without a "
                                 f"group: launches {fwd['none']} != expected "
                                 f"{expect}, or logits not finite")
        for mode, run in fwd.items():
            if mode == "none":
                continue
            if not run["equal"] or (run["launches"], run["by_regime"]) != \
                    (fwd["none"]["launches"], fwd["none"]["by_regime"]):
                raise AssertionError(
                    f"[tp-families] {arch} forward {mode}: {run} against "
                    f"without a group {fwd['none']}")
            paths[f"{arch} tp forward W=1 {mode}"] = run["launches"]
        log(f"[tp-families] {arch} forward B={res['tokens'][0]} "
            f"S={res['tokens'][1]}: every mode's logits equal the groupless "
            f"forward's bit for bit, launches {fwd['none']['launches']} "
            f"(derived {expect}; by regime {fwd['none']['by_regime']})")
        log(f"[tp-families] {arch} forward under "
            + " and ".join(f"{name} (largest difference "
                           f"{fwd[name]['max_diff']})" for name in RS_CASES)
            + ": the stream sequence-sharded on the one-rank group, logits "
            f"bit-equal to the groupless forward's, the same launches "
            f"{fwd['none']['launches']}")
        log(f"[tp-families] {arch} ({res['n_layers']} layers; weights drawn "
            f"in {res['init_s']:.1f} s, peak {gib(res['peak'])}): "
            f"{len(base['tokens'])} requests, {passes} passes a {serve}; "
            f"every mode's tokens equal the groupless {serve}'s bit for bit "
            f"and its launches {base['launches']} (derived "
            f"{res['expect']}; by regime {base['by_regime']}); seconds a "
            f"serve: " + ", ".join(
                f"{mode} {run['s']:.2f}" for mode, run in runs.items()))
        check_shapes(res["seen"], "tp-families")
    log(f"[tp-families] {time.perf_counter() - t0:.1f} s in all")
    return paths


# --------------------------------------------------------------------------- #
# phases 18-19: training the ssm and mla_moe families
# --------------------------------------------------------------------------- #
#: (arch, depth) trained at the published widths, the depth cut so that 16
#: bytes a parameter (float32 masters, AdamW's m and v, float32 gradients)
#: fit one card and the whole run stays near 900 s: rwkv6-7b 2 of 32
#: layers and deepseek-v2-lite 2 of 27, the dense one and an MoE one (at
#: 8 and 4 layers their 27 GB checkpoints took most of the phase's time),
#: zamba2-2.7b 12 of 54 (2 groups, 0.85 B parameters),
#: llama-3.2-vision-11b 5 of 40 (one group: 4 self layers and a cross
#: layer; 2.14 B), whisper-medium whole (24 + 24 layers; 1.3 B with its
#: 524,288-row position table).  llama4-scout's one layer with its
#: embeddings is 4.27 B (68.3 GB) before the gradient restack and the
#: activations: it trains on the CPU only.
TRAIN_FAMILIES = ((RWKV, 2), (MLA, 2), (HYBRID, 12), (VLM, 5), (ENCDEC, 24))
#: the families whose run writes a checkpoint and resumes from it (the
#: vlm's and whisper's runs skip the resume, to keep the phase short)
FAMILY_RESUMED = (RWKV, MLA, HYBRID)
FAMILY_TRAIN_ARGV = ["--steps", "4"]
#: the learning rate a family trains at: 3e-4, but the vlm's 1e-4 (its
#: loss swings from batch to batch at random init, and at 3e-4 the fourth
#: batch's was above the first's on the H100; at 1e-4 and 5e-5 it fell)
FAMILY_TRAIN_LR = {VLM: "1e-4"}
FAMILY_TRAIN_SAVED = 2   # the newest checkpoint of 4 steps saved every 2
#: the :data:`RS_CASES` a family's step runs under beside every psum mode
TRAIN_RS_CASES = ("ina+rs_seq",)
FAMILY_TRAIN_SPANS = ("wkv6_backward", EXPERTS_SPAN,
                      mla_model.ATTENTION_SPAN, "flash_attention_backward",
                      "adamw_update")
VLM_GATE = 0.5


def family_train_argv(arch: str, layers: int) -> list:
    """``launch.train``'s arguments for ``[train-families]``: B 2 x S 1024
    (whisper B 4 x S 448, its decoder's context), a checkpoint every 2
    steps for the families that resume, none for the others."""
    shape = [WHISPER_TRAIN_B, WHISPER_TRAIN_S] if arch == ENCDEC \
        else [FAMILY_TRAIN_B, FAMILY_TRAIN_S]
    every = FAMILY_TRAIN_SAVED if arch in FAMILY_RESUMED else 100
    return ["--arch", arch, "--layers", str(layers), "--batch",
            str(shape[0]), "--seq", str(shape[1]), "--ckpt-every",
            str(every), "--lr", FAMILY_TRAIN_LR.get(arch, "3e-4")] \
        + FAMILY_TRAIN_ARGV


@contextlib.contextmanager
def vlm_gates(arch: str):
    """The launcher's initial state with the vlm's tanh gates at
    :data:`VLM_GATE`, as ``[vlm]`` sets them: the reference's init puts
    them at 0, which cuts the media off and zeroes every cross-attention
    weight's gradient.  Other families' states as they are."""
    real = launch_train.initial_state

    def gated(model, *args, **kw):
        params, opt = real(model, *args, **kw)
        for gate in ("gate_attn", "gate_mlp"):
            params["xlayers"][gate].fill_(VLM_GATE)
        return params, opt
    if arch == VLM:
        launch_train.initial_state = gated
    try:
        yield
    finally:
        launch_train.initial_state = real


def train_family(arch: str, layers: int, ck: str, smi: str,
                 device: str) -> dict:
    """One family of ``[train-families]`` (:func:`phase_train_families`):
    its launches over run 1 and under each mode, and its profile."""
    phase = "train-families"
    argv = family_train_argv(arch, layers)
    args = launch_train.build_parser().parse_args(
        argv + ["--ckpt-dir", ck, "--device", device])
    cfg = launch_train._config(args)
    model = get_model(cfg)
    fresh_phase()
    what = f"{cfg.encoder_layers} encoder and {layers} decoder layers" \
        if cfg.family == "encdec" else \
        f"{layers} of {ARCHS[arch].n_layers} layers"
    log(f"[{phase}] {arch}: {what} at the published widths (d_model "
        f"{cfg.d_model}), float32 masters, {cfg.dtype} compute, B "
        f"{args.batch} x S {args.seq}"
        + (f" over {cfg.num_media_tokens} media rows of ones"
           if cfg.family in MEDIA_FAMILIES else "")
        + (f", gates {VLM_GATE}" if arch == VLM else "")
        + f", {args.steps} steps, warmup 1; {smi}")
    with vlm_gates(arch):
        first, steps = train_run(ck, f"{arch} run 1", device, argv, phase)
    peak = torch.cuda.max_memory_allocated()
    losses = first["losses"]
    path = {k: sum(s["launches"][k] for s in steps)
            for k in steps[0]["launches"]}
    log(f"[{phase}] {arch} run 1: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"peak device memory {gib(peak)}; launches over the run {path}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[{phase}] {arch}: the loss did not fall: "
                             f"{losses}")
    if arch in FAMILY_RESUMED:
        first_losses = dict(zip(first["steps"], losses))
        del first
        fresh_phase()
        saved = latest_step(ck)
        first, _ = train_run(ck, f"{arch} run 2 (resume)", device, argv,
                             phase)
        if saved != FAMILY_TRAIN_SAVED or first["steps"][0] != saved + 1:
            raise AssertionError(f"[{phase}] {arch} resume: newest "
                                 f"checkpoint {saved}, resumed at "
                                 f"{first['steps'][0]}")
        diff = first["losses"][0] - first_losses[saved + 1]
        log(f"[{phase}] {arch} resume: newest checkpoint at step {saved}, "
            f"resumed at step {saved + 1} with loss "
            f"{first['losses'][0]:.6f}, run 1's "
            f"{first_losses[saved + 1]:.6f} (diff {diff:+.3g})")
        if diff != 0.0:
            raise AssertionError(f"[{phase}] {arch}: the resumed step's loss "
                                 f"differs from run 1's by {diff}")
    elif latest_step(ck) is not None:
        raise AssertionError(f"[{phase}] {arch}: a checkpoint was written")

    params, opt = first.pop("state")
    del first
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    ts = build_train_step(model, shape, base_lr=args.lr, warmup=1,
                          total_steps=args.steps)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    batch = {k: v.to(device) for k, v in pipe.batch(0).items()}
    batch.update(media_ones(cfg, args.batch, device))
    prof = profile_step(f"train_{arch}", lambda: ts.fn(params, opt, batch),
                        steps=1, spans=FAMILY_TRAIN_SPANS)
    tokens = args.batch * args.seq
    log(f"[{phase}] {arch} profiled step: wall {prof['wall_ms']:.1f} ms, "
        f"device {prof['device_ms']:.1f} ms, busy share "
        f"{prof['device_ms'] / prof['wall_ms']:.3f}, "
        f"{prof['kernels_per_step']} kernels a step; ina_matmul "
        f"{prof['ina_matmul_ms']:.1f} ms, flash_attention "
        f"{prof['flash_attention_ms']:.2f} ms, wkv6 {prof['wkv6_ms']:.2f} "
        f"ms, "
        + ", ".join(f"inside {k} {v:.1f} ms"
                    for k, v in prof["span_ms"].items())
        + f", other {prof['other_ms']:.1f} ms; "
        f"{tokens / prof['wall_ms'] * 1e3:.0f} tokens/s (host clock); peak "
        f"device memory {gib(peak)}; {smi}")
    del params, opt, ts
    fresh_phase()

    # one step under each mode (and TRAIN_RS_CASES) on a one-rank NCCL
    # group: the groupless step
    expect = train_launches(cfg)
    with vlm_gates(arch), record_shapes() as seen:
        base, base_steps = _timed("groupless step", lambda: tp_train_steps(
            model, shape, None, [batch], args), phase)
    check_shapes(seen, f"{phase} {arch}")
    modes = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_group_") as tmp, \
            vlm_gates(arch):
        group, _ = mesh.init_group(1, 0, device, os.path.join(tmp, "store"))
        try:
            for mode, kw in tp_cases(TRAIN_RS_CASES).items():
                pctx = ParallelCtx(group=group, **kw)
                got, st = _timed(f"{mode} step", lambda: tp_train_steps(
                    model, shape, pctx, [batch], args), phase)
                s, b = st[0], base_steps[0]
                log(f"[{phase}] {arch} {mode}: loss {s['loss']:.6f} "
                    f"(groupless {b['loss']:.6f}), grad_norm "
                    f"{s['grad_norm']:.6f} ({b['grad_norm']:.6f}), launches "
                    f"{s['launches']}, generic {s['generic']}, collective "
                    f"calls {s['calls']}")
                if (s["loss"], s["grad_norm"]) != (b["loss"], b["grad_norm"]) \
                        or s["launches"] != expect or s["generic"] != 0 \
                        or s["calls"]:
                    raise AssertionError(f"[{phase}] {arch} {mode}: the step "
                                         f"is not the groupless one")
                n = _same_state(got, base, f"{arch} {mode} params")
                log(f"[{phase}] {arch} {mode}: {n} param leaves bit-equal to "
                    f"the groupless step's")
                modes[mode] = s["launches"]
                del got
        finally:
            dist.destroy_process_group()
    # one step under each remat policy: the groupless step to the bit, with
    # the policy's launches
    policies = {}
    for policy in POLICIES:
        pm = get_model(dataclasses.replace(cfg, remat_policy=policy))
        expect = train_launches(pm.cfg)
        with vlm_gates(arch):
            got, st = _timed(f"{policy} step", lambda: tp_train_steps(
                pm, shape, None, [batch], args), phase)
        s, b = st[0], base_steps[0]
        log(f"[{phase}] {arch} {policy}: loss {s['loss']:.6f} (nothing "
            f"{b['loss']:.6f}), grad_norm {s['grad_norm']:.6f} "
            f"({b['grad_norm']:.6f}), launches {s['launches']} (nothing "
            f"{b['launches']}), expected {expect}, generic {s['generic']}")
        if (s["loss"], s["grad_norm"]) != (b["loss"], b["grad_norm"]) \
                or s["launches"] != expect or s["generic"] != 0:
            raise AssertionError(f"[{phase}] {arch} {policy}: the step is "
                                 f"not nothing's, or its launches are not "
                                 f"{expect}")
        n = _same_state(got, base, f"{arch} {policy} params")
        log(f"[{phase}] {arch} {policy}: {n} param leaves bit-equal to "
            f"nothing's")
        policies[policy] = s["launches"]
        del got
    del base
    fresh_phase()
    return {"launches": path, "modes": modes, "profile": prof,
            "peak_bytes": peak, "policies": policies}


def phase_train_families(smi: str, device: str = "cuda") -> dict:
    """``[train-families]``: :data:`TRAIN_FAMILIES` at their published
    widths through ``launch.train`` (float32 masters, bf16 compute, seeded
    weights, the port's token pipeline, media of ones for the vlm and
    whisper): 4 AdamW steps, warmup 1, every step's launches the derived
    counts (:func:`train_launches`: a layer's or group's products once
    more in its recompute, ``wkv6`` and flash forward and recomputed, none
    in their backwards; no ``ina_matmul`` generic), every loss finite and
    the last below the first; for :data:`FAMILY_RESUMED`, a checkpoint at
    step 2 into a temporary directory and a second run that resumes at
    step 3 with run 1's loss to the bit (zamba2's nested ``[G, per]``
    stack through save and restore).  Then one step profiled (device time
    inside the ``wkv6`` and attention backwards, the expert products,
    MLA's attention and AdamW), and one step under every psum mode on a
    one-rank NCCL group, bit-equal to the groupless step with the same
    launches and no collective call; the groupless step's launch shapes
    were each held against the kernel's plain version in phase 2; and the
    same step under the sequence-sharded stream (:data:`TRAIN_RS_CASES`),
    bit-equal to the groupless one with its launches."""
    out = {}
    for arch, layers in TRAIN_FAMILIES:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_families_") as ck:
            out[arch] = train_family(arch, layers, ck, smi, device)
    return out


def f32_train_config(arch: str):
    """The smallest depth of ``arch`` in float32 that runs each kind of
    layer: 2 layers (deepseek's dense one and an MoE one; whisper's 2
    decoder layers over 2 encoder layers), zamba2's one group of 6, the
    vlm's one group of 5."""
    cfg = ARCHS[arch]
    layers = cfg.shared_attn_every or cfg.cross_attn_every or 2
    extra = {"encoder_layers": 2} if cfg.family == "encdec" else {}
    return dataclasses.replace(cfg, n_layers=layers, dtype="float32", **extra)


def phase_train_families_f32(device: str = "cuda") -> None:
    """``[train-families-f32]``: each of :data:`TRAIN_FAMILIES` at its
    widths and :func:`f32_train_config`'s depth, float32, B 2 x S 128
    (the vlm and whisper over seeded N(0, 1) media, the vlm's gates at
    :data:`VLM_GATE`): one step's loss and every gradient leaf through
    the kernels against the same step through their plain versions on
    the card (:func:`against_plain`, :func:`phase_train_f32`'s bound).
    The ``wkv6`` and flash backwards are the same plain VJPs on both
    sides, from inputs that differ by the forward's f32 sum order."""
    for seed, (arch, _) in enumerate(TRAIN_FAMILIES):
        cfg = f32_train_config(arch)
        model = get_model(cfg)
        params = model.init(torch.Generator(device=device).manual_seed(2),
                            device=device, masters=True)
        if arch == VLM:
            for gate in ("gate_attn", "gate_mlp"):
                params["xlayers"][gate].fill_(VLM_GATE)
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_F32_S,
                                        global_batch=TRAIN_F32_B, seed=3))
        batch = {k: v.to(device) for k, v in pipe.batch(0).items()}
        if cfg.family in MEDIA_FAMILIES:
            batch["media"] = media(cfg, TRAIN_F32_B, 30 + seed)
        reset_launches()
        loss, grads = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        launches = read_launches()
        on_path = {"ssm": ("ina_matmul", "wkv6"),
                   "mla_moe": ("ina_matmul",)}.get(
            cfg.family, ("ina_matmul", "flash_attention"))
        check_launches(launches, train_launches(cfg), on_path)
        against_plain(model, params, batch, loss, grads, launches,
                      "train-families-f32")
        del params, grads
        fresh_phase()


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _named_tensors(tree, names=()):
    """(path, tensor) of each leaf of nested dicts, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_tensors(v, names + (k,))
        else:
            yield "/".join(names + (k,)), v


# --------------------------------------------------------------------------- #
def kernel_entry(name, source, replaces, rows, case, launches, smi,
                 by_path) -> dict:
    row = next(r for r in rows if r["case"] == case)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "device": smi, "cases": rows}


def ptxas_report(text: str, source: str) -> list:
    """(kernel, "registers, shared memory | spills") for each entry
    function in nvcc's ``-Xptxas -v`` output for ``<source>.cu``, whose
    kernels are named ``<source>..._kernel``; a template's arguments are
    shown as <...> (dynamic shared memory is the ring, set at launch)."""
    out, kernel, used = [], None, []
    for ln in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            if kernel:
                out.append((kernel, " | ".join(used)))
            mangled = entry.group(1)
            # the last "<source>..._kernel" in the name: the namespace
            # before it (an anonymous one) also holds the source's name
            name = re.search(rf"{source}(?:(?!{source})\w)*?_kernel", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled)
            kernel = (name.group() if name else mangled) + \
                (f"<{','.join(args)}>" if args else "")
            used = []
        elif kernel and ("registers" in ln or "spill" in ln):
            used.append(ln.split(":", 1)[-1].strip())
    if kernel:
        out.append((kernel, " | ".join(used)))
    return out


def phase_clock():
    """``mark(label)``: logs the seconds since the clock was made and since
    the last mark (the phases' share of the run's time limit)."""
    start = last = time.perf_counter()

    def mark(label: str) -> None:
        nonlocal last
        now = time.perf_counter()
        log(f"[time] {label}: {now - last:.1f} s (run at {now - start:.1f} "
            f"s)")
        last = now
    return mark


def main() -> int:
    mark = phase_clock()
    info = device_check()
    t0 = time.perf_counter()
    logs = _build.build(["ina_matmul", "flash_attention", "wkv6"])
    log(f"[build] {len(logs)} sources built in parallel in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for kernel, used in ptxas_report(text, name):
            log(f"[build] {name}.cu {kernel}: {used}")
    wide = [(kernel, re.findall(r"(\d+) bytes spill", used))
            for kernel, used in ptxas_report(logs["flash_attention"],
                                             "flash_attention")
            if re.search(r"<(144|160)>", kernel)]
    log("[build] flash_attention at D 144 and 160 (zamba2's shared "
        "attention, 160): " + "; ".join(
            f"{kernel} " + ("no spill" if set(spill) == {"0"} else
                            f"SPILLS {'/'.join(spill)} bytes (stores/loads)")
            for kernel, spill in wide))
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_matmul_small(gen)
    check_attention_small(gen)
    timer = Timer()
    mm_rows = check_matmul(timer, gen, matmul_cases())
    mm_rows += check_matmul(timer, gen, train_matmul_cases())
    mm_rows += check_planned_tiles(timer, gen)
    at_rows = check_attention(timer, gen)
    wkv_rows = check_wkv6(timer, gen)
    del timer
    mark("build and phase 2")
    served = phase_serve_bf16()
    tp = phase_tp(served)
    planned = phase_plan(served)
    mark("serve, tp, plan")
    capacity = phase_capacity(served, info["smi"])
    mm_rows += capacity["mm_rows"]
    at_rows += capacity["at_rows"]
    mark("capacity")
    phase_noc(info["smi"])
    mark("noc")
    phase_exact_f32()
    mark("exact-f32")
    rwkv = phase_rwkv_bf16()
    phase_rwkv_exact_f32()
    mark("rwkv, rwkv-f32")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as ck:
        trained = phase_train(ck)
        tp_trained = phase_tp_train(ck, info["smi"])
    dry = phase_dryrun(trained["profile"], info["smi"])
    dp_trained = phase_dp_train(info["smi"])
    phase_train_f32()
    mark("train, tp-train, dryrun, dp-train, train-f32")
    mla = phase_mla()
    phase_mla_f32()
    moe = phase_moe()
    mark("mla, mla-f32, moe")
    hybrid = phase_hybrid()
    phase_hybrid_f32()
    vlm = phase_vlm()
    encdec = phase_encdec()
    mark("hybrid, hybrid-f32, vlm, encdec")
    tp_families = phase_tp_families()
    mark("tp-families")
    trained_families = phase_train_families(info["smi"])
    mark("train-families")
    phase_train_families_f32()
    mark("train-families-f32")
    launches = served["launches"]
    world = min(torch.cuda.device_count(), 4)
    paths = {"qwen2-1.5b serve": launches,
             **{f"qwen2-1.5b tp serve W={world} {mode}": counts
                for mode, counts in tp.items()},
             "qwen2-1.5b planned serve (auto)": planned,
             **{f"qwen2-1.5b (reduced) capacity planner's engine demo "
                f"({sem})": counts
                for sem, counts in capacity["launches"].items()},
             "rwkv6-7b forward": rwkv["forward"],
             "rwkv6-7b serve": rwkv["serve"],
             "qwen2-1.5b train": trained["launches"],
             "qwen2-1.5b dryrun's train step on the card": dry["launches"],
             **{f"qwen2-1.5b tp train W=1 {mode} ({TP_TRAIN_STEPS} steps)":
                counts for mode, counts in tp_trained.items()},
             f"qwen2-1.5b dp train (data 1, model 1) ({TP_TRAIN_STEPS} "
             f"steps)": dp_trained["launches"],
             f"{MLA} forward": mla["forward"],
             f"{MLA} serve": mla["serve"],
             f"{MOE} ({MOE_DEPTH} layers) forward": moe["forward"],
             f"{MOE} ({MOE_DEPTH} layers) serve": moe["serve"],
             f"{HYBRID} forward": hybrid["forward"],
             f"{HYBRID} serve": hybrid["serve"],
             f"{VLM} forward": vlm["forward"],
             f"{VLM} legacy serve": vlm["serve"],
             f"{ENCDEC} forward": encdec["forward"],
             f"{ENCDEC} legacy serve": encdec["serve"], **tp_families,
             **{f"{arch} train ({layers} layers, run 1)":
                trained_families[arch]["launches"]
                for arch, layers in TRAIN_FAMILIES},
             **{f"{arch} train ({layers} layers) W=1 {mode}": counts
                for arch, layers in TRAIN_FAMILIES
                for mode, counts in trained_families[arch]["modes"].items()},
             **{f"qwen2-1.5b train step {policy}": row["launches"]
                for policy, row in trained["policies"].items()},
             **{f"{arch} train step ({layers} layers) {policy}": counts
                for arch, layers in TRAIN_FAMILIES for policy, counts
                in trained_families[arch]["policies"].items()}}

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}
    kernels = [
        kernel_entry("ina_matmul", "src/repro_torch/kernels/csrc/ina_matmul.cu",
                     "src/repro/kernels/ina_matmul.py:57", mm_rows,
                     "w_up/w_gate M=2", launches["ina_matmul"], info["smi"],
                     by_path("ina_matmul")),
        kernel_entry("flash_attention",
                     "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:78", at_rows,
                     "qwen2 chunk 2", launches["flash_attention"],
                     info["smi"], by_path("flash_attention")),
        kernel_entry("wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
                     "src/repro/kernels/wkv6.py:70", wkv_rows, "forward",
                     rwkv["forward"]["wkv6"], info["smi"], by_path("wkv6")),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": info["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
