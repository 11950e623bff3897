"""FSDP training of the ssm, moe and mla_moe families with each checkpointed
unit's weights gathered inside its checkpointed body and its gradient
reduce-scattered in its backward, on gloo ranks as ``(data 2, model 1)``
and ``(pod 2, data 2, model 1)`` (``tests/_torch_fsdp_cases.py``): the loss
and gradient against the reference's unsharded ``jax.value_and_grad``, two
AdamW steps against the one-rank step, and the gathers and the most
gathered bytes alive at once."""
import pytest

import _torch_fsdp_cases as F

FAMILIES = ("rwkv6-7b", "llama4-scout-17b-16e", "deepseek-v2-lite-16b")
CASES = [(m, a) for m in F.MESHES for a in FAMILIES]
IDS = [f"{m}-{a}" for m, a in CASES]


@pytest.mark.parametrize("name,arch", CASES, ids=IDS)
def test_loss_and_grads_match_unsharded_reference(name, arch):
    F.check_grads(name, FAMILIES, arch)


@pytest.mark.parametrize("name,arch", CASES, ids=IDS)
def test_two_adamw_steps_match_one_rank(name, arch):
    F.check_steps(name, FAMILIES, arch)


@pytest.mark.parametrize("name,arch", CASES, ids=IDS)
def test_gathers_stay_within_two_units(name, arch):
    F.check_gathers(name, FAMILIES, arch)
