"""The cases of ``tests/test_torch_serve_data_*.py``: every family's
reduced config served on gloo ranks of a mesh with a data axis, one spawn
a mesh with every family inside it (``_torch_dist_workers.
serve_data_rank``), under ``serve_replicated_params`` off (each data rank
holds its FSDP pieces and gathers each layer a step) and on (the model
shard gathered once): the engine, or the legacy loop for the vlm and
whisper, on 4 requests and 4 slots, each data rank holding its share of
the slots (of the batch rows), the tokens gathered over ``data`` and
``pod``.  Its tokens must equal the one-rank launcher's; the dense
family's, on the reference's weights, also the reference's greedy
per-token loop over ``Model.decode_step`` on the same prompts (its
``ServingEngine`` cannot be built on the installed jax, ROADMAP Queue 3).

The MoE families are also served at :data:`BIND_ROWS` requests, where an
expert's capacity binds over the global batch but not over one host's
rows (on the seeded weights, the legacy loop's tokens at 32 rows differ
in 12 rows for llama4 and 2 for deepseek if each host routes its own).  The legacy loop decodes its rows at one position, and an MoE layer
routes the global batch as one group, as the reference's serve step does
(jitted over the whole batch): every host's rows enter the one capacity.
The engine's paged step routes each slot as its own group, as the
reference's (a ``vmap`` of a B=1 decode), so nothing is dropped there.
Both must give the one-rank launcher's tokens.

At ``(data 2, model 1)`` a decode of one row (one slot), which the hosts
do not divide, is replicated over them (the reference's ``fit_specs``
drops the batch's data axis): each rank's tokens equal one rank's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh
from repro_torch.launch import serve as launch_serve

import _torch_dist_workers as W

FAMILIES = ("qwen2-1.5b", "rwkv6-7b", "llama4-scout-17b-16e",
            "deepseek-v2-lite-16b", "zamba2-2.7b", "llama-3.2-vision-11b",
            "whisper-medium")
DENSE = "qwen2-1.5b"
MESHES = {"d2": ((2, 1), ("data", "model")),
          "d2m2": ((2, 2), ("data", "model")),
          "p2d2": ((2, 2, 1), ("pod", "data", "model"))}
BATCH, PROMPT, GEN = 4, 6, 5
#: the MoE families served where capacity binds, and their requests
BIND = ("llama4-scout-17b-16e", "deepseek-v2-lite-16b")
LOOPS = {"engine": [], "legacy": ["--legacy-loop"]}
BIND_ROWS = {"engine": 16, "legacy": 32}
#: a batch (slots) that data 2 does not divide: replicated over the hosts
REPLICATED_ROWS = 1


def argv(arch: str, name: str = None, rows: int = BATCH,
         loop: str = "engine") -> list:
    out = ["--arch", arch, "--reduced", "--device", "cpu", "--batch",
           str(rows), "--slots", str(rows), "--prompt-len", str(PROMPT),
           "--gen", str(GEN), "--block-size", "4", "--prefill-chunk", "4",
           "--check"] + LOOPS[loop]
    if name is not None:
        ranks = mesh.RankMesh(*MESHES[name])
        out += ["--model-parallel", str(ranks.span("model"))]
    return out


@functools.cache
def reference_params() -> dict:
    return jax.tree.map(np.asarray, jget_model(
        JARCHS[DENSE].reduced()).init(jax.random.PRNGKey(0)))


@functools.cache
def reference_tokens() -> list:
    """The reference's greedy loop on the launcher's prompts: the first
    token after the prompt, then ``GEN`` more, one row a request."""
    jm = jget_model(JARCHS[DENSE].reduced())
    jp = reference_params()
    prompts = launch_serve.make_prompts(ARCHS[DENSE].reduced(), BATCH,
                                        PROMPT).numpy().astype(np.int32)
    cache = jm.init_cache(BATCH, PROMPT + GEN + 1)
    for pos in range(PROMPT):
        logits, cache = jm.decode_step(
            jp, {"tokens": jnp.asarray(prompts[:, pos:pos + 1]),
                 "pos": jnp.asarray(pos, jnp.int32)}, cache)
    nxt = jnp.argmax(logits[:, -1], axis=-1)
    out = [np.asarray(nxt)]
    for i in range(GEN):
        logits, cache = jm.decode_step(
            jp, {"tokens": nxt[:, None],
                 "pos": jnp.asarray(PROMPT + i, jnp.int32)}, cache)
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        out.append(np.asarray(nxt))
    return np.stack(out, axis=1).tolist()


def _params(arch: str):
    return reference_params() if arch == DENSE else None


@functools.cache
def one_rank(arch: str) -> list:
    params = _params(arch)
    if params is not None:
        params = params_from_jax(params, ARCHS[arch].reduced(), device="cpu")
    return launch_serve._serve(launch_serve.build_parser().parse_args(
        argv(arch)), ARCHS[arch].reduced(), params=params)


@functools.cache
def one_rank_bound(arch: str, loop: str) -> tuple:
    """The one-rank launcher's tokens at :data:`BIND_ROWS` requests, and
    the share of the MoE assignments it dropped."""
    from repro_torch.models import moe
    args = launch_serve.build_parser().parse_args(
        argv(arch, rows=BIND_ROWS[loop], loop=loop))
    with moe.record_routing() as calls:
        tokens = launch_serve._serve(args, ARCHS[arch].reduced())
    return tokens, moe.dropped_share(calls)


@functools.cache
def one_rank_rows(loop: str) -> list:
    """The one-rank launcher's tokens of the dense family at
    :data:`REPLICATED_ROWS` requests."""
    args = launch_serve.build_parser().parse_args(
        argv(DENSE, rows=REPLICATED_ROWS, loop=loop))
    return launch_serve._serve(args, ARCHS[DENSE].reduced())


@functools.cache
def port(name: str) -> list:
    spec = {"mesh": MESHES[name],
            "archs": {a: {"argv": argv(a, name), "params": _params(a)}
                      for a in FAMILIES},
            "bound": {(a, loop): argv(a, name, BIND_ROWS[loop], loop)
                      for a in BIND for loop in LOOPS}}
    if name == "d2":
        spec["bound"].update({
            ("replicated", loop): argv(DENSE, name, REPLICATED_ROWS, loop)
            for loop in LOOPS})
    return mesh.spawn(W.serve_data_rank, mesh.RankMesh(*MESHES[name]).size,
                      "cpu", args=(spec,))


def check_tokens(name: str, arch: str, replicated: bool) -> None:
    want = one_rank(arch)
    assert len(want) == BATCH and all(len(t) == GEN + 1 for t in want)
    for rank in port(name):
        assert rank[arch, replicated] == want
    if arch == DENSE:
        assert want == reference_tokens()


def check_bound(name: str, arch: str, loop: str) -> None:
    """The tokens at :data:`BIND_ROWS` requests equal one rank's; the
    legacy loop's capacity binds there (some assignments dropped), the
    engine's per-slot routing drops none."""
    want, dropped = one_rank_bound(arch, loop)
    assert len(want) == BIND_ROWS[loop]
    assert (dropped > 0) == (loop == "legacy")
    for rank in port(name):
        assert rank[arch, loop] == want


def check_replicated(name: str, loop: str) -> None:
    """A batch of :data:`REPLICATED_ROWS` (one row, one slot), which the
    hosts do not divide, is replicated over them: every rank decodes the
    whole batch, routed as one host's, and its tokens equal one rank's."""
    want = one_rank_rows(loop)
    assert len(want) == REPLICATED_ROWS
    for rank in port(name):
        assert rank["replicated", loop] == want
