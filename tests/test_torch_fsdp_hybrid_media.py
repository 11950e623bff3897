"""FSDP training of the hybrid, vlm and encdec families with each checkpointed
unit's weights gathered inside its checkpointed body and its gradient
reduce-scattered in its backward, on gloo ranks as ``(data 2, model 1)``
and ``(pod 2, data 2, model 1)`` (``tests/_torch_fsdp_cases.py``): the loss
and gradient against the reference's unsharded ``jax.value_and_grad``, two
AdamW steps against the one-rank step, and the gathers and the most
gathered bytes alive at once."""
import pytest

import _torch_fsdp_cases as F

FAMILIES = ("zamba2-2.7b", "llama-3.2-vision-11b", "whisper-medium")
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


def test_a_leaf_cut_on_its_stacked_dim_is_gathered_whole():
    """zamba2's ``inv_norms`` [G, D] at the reduced config: ``data`` 2
    cuts its stacked G (each group's row on one data rank), so the step
    keeps it unsplit beside the leaves outside the units and gathers every
    owner's rows once a step (``fsdp.layer_pieces``); the gradient the
    ranks rebuild for it is the reference's
    (``test_loss_and_grads_match_unsharded_reference[d2-zamba2-2.7b]``)."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models.api import get_model
    from repro_torch.parallel import fsdp, sharding

    cfg = ARCHS["zamba2-2.7b"].reduced()
    assert sharding.data_cut(("inv_norms",), cfg, (2, 1)) == 0
    params = get_model(cfg).init(device="cpu", masters=True)
    pieces = sharding.shard_params(params, cfg, (1, 0), (2, 1))
    tree, dims = fsdp.layer_pieces(pieces, cfg, (2, 1))
    assert torch.is_tensor(tree["inv_norms"]) and \
        dims[id(tree["inv_norms"])] == 0
    assert torch.equal(tree["inv_norms"], params["inv_norms"][1:])
    assert isinstance(tree["groups"]["mamba"]["w_in"], list)
    grads = F.port("d2", FAMILIES)[0]["zamba2-2.7b"][F.MODE]["grads"]
    assert grads["inv_norms"].shape == (1, params["inv_norms"].shape[1])
