"""World 4 of ``tests/test_torch_tp_train_hybrid_media.py``: the reduced
zamba2-2.7b, llama-3.2-vision-11b and whisper-medium trained on 4 gloo
ranks under every psum mode, with that file's checks.  At 4 ranks the
vlm's and whisper's 2 KV heads are each shared by two ranks, in
self-attention and in cross-attention, so their gradients sum in
``GradSync``'s KV bucket; zamba2's shared block holds one of its 4 heads
a rank and Mamba2 two of its 8.

* The loss and every gradient leaf against the reference's unsharded
  ``jax.value_and_grad`` (loss rtol 1e-5, each leaf rtol 1e-4 plus atol
  1e-5 of its largest).
* Two AdamW steps against the groupless one-rank step, the whole leaves,
  Mamba2's B and C segments and the shared KV heads bit-equal across
  ranks after them (to AdamW's bound under ``eject_inject``), and a
  step's collective calls by kind.
* The gradient under the sequence-sharded stream (``ina+rs_seq``) against
  the reference's, and its collective calls.

And, on a spawn of its own at world 2, whisper's head over a vocabulary
no world divides.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.models.api import get_model as jget_model

from repro_torch.configs import ARCHS
from repro_torch.launch import mesh
from repro_torch.parallel import sharding

import _torch_dist_workers as W
import test_torch_tp_train_hybrid_media as base

CASE_IDS, IDS = base.case_ids((4,))
RS_IDS, RS_NAMES = base.case_ids((4,), base.rs_cases)


@pytest.mark.parametrize("world,case,arch", CASE_IDS + RS_IDS,
                         ids=IDS + RS_NAMES)
def test_loss_and_grads_match_unsharded_reference(world, case, arch):
    base.check_loss_and_grads(world, case, arch)


@pytest.mark.parametrize("world,case,arch", RS_IDS, ids=RS_NAMES)
def test_rs_seq_gradient_calls(world, case, arch):
    base.check_rs_gradient_calls(world, case, arch)


@pytest.mark.parametrize("world,case,arch", CASE_IDS, ids=IDS)
def test_two_adamw_steps_match_one_rank(world, case, arch):
    base.check_two_adamw_steps(world, case, arch)


@pytest.mark.parametrize("world,case,arch", CASE_IDS, ids=IDS)
def test_replicated_leaves_stay_bit_equal_across_ranks(world, case, arch):
    base.check_replicated_leaves(world, case, arch)


@pytest.mark.parametrize("world,case,arch", CASE_IDS, ids=IDS)
def test_collective_calls_per_step(world, case, arch):
    base.check_collective_calls(world, case, arch)


def test_whisper_head_over_an_odd_vocabulary_stays_whole():
    """whisper-medium's vocabulary (51865) divides over no world, so its
    embedding and tied head stay whole on every rank and the head's input
    takes no ``f`` (a sum there would count the head's gradient twice):
    the reduced whisper at a vocabulary of 255, at world 2, against the
    reference's unsharded gradient at that vocabulary, with one all-reduce
    fewer a gradient than at 256 and no logits gather."""
    cfg = dataclasses.replace(JARCHS[base.ENCDEC].reduced(), vocab=255)
    jm = jget_model(cfg)
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(1)
    pair = base._batch(rng, cfg)
    batch = dict(zip(("tokens", "labels", "media"), pair))
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, batch))(jp)
    spec = {"arch": base.ENCDEC, "config": {"vocab": 255},
            "params": jax.tree.map(np.asarray, jp), "grad_batch": pair,
            "step_batches": [], "cases": {"ina": {"psum_mode": "ina"}},
            "schedule": base.SCHEDULE}
    ranks = mesh.spawn(W.tp_train_rank, 2, "cpu", args=(spec,))
    port_cfg = dataclasses.replace(ARCHS[base.ENCDEC].reduced(), vocab=255)
    for r in ranks:
        np.testing.assert_allclose(r["ina"]["loss"], float(jloss), rtol=1e-5)
        assert r["ina"]["grads"]["embed"].shape == (255, cfg.d_model)
    got = base._named(sharding.unshard_params(
        [r["ina"]["grads"] for r in ranks], port_cfg, 2))
    base._assert_leaves_close(got, base._named(jgrads))
    want = base.expected_calls(base.ENCDEC)
    assert ranks[0]["ina"]["grad_calls"] == {
        "psum": want["psum"] - 1, "all_reduce": want["all_reduce"] - 2}
