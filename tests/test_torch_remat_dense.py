"""The ``dots`` and ``dots_nb`` remat policies of the dense family
(qwen2-1.5b reduced) against ``nothing`` and against the JAX package
(``tests/_torch_remat_cases.py``): the loss and every gradient within 1e-4
of ``jax.value_and_grad`` of the reference under the same policy, bit-equal
(``torch.equal``) to the port's ``nothing`` step, the step's kernel calls
as ``chip_smoke.train_launches`` derives them and the recompute's product
calls as derived; an unknown policy name raises."""
import dataclasses

import pytest

from repro_torch.configs import ARCHS
from repro_torch.models.api import get_model
from repro_torch.parallel.steps import loss_and_grads

import _torch_remat_cases as R

FAMILIES = ("qwen2-1.5b",)


@pytest.mark.parametrize("policy", R.POLICIES)
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_reference_under_policy(name, policy):
    R.check_matches_reference(name, policy)


@pytest.mark.parametrize("policy", R.POLICIES)
@pytest.mark.parametrize("name", FAMILIES)
def test_policy_is_bit_equal_to_nothing(name, policy):
    R.check_bit_equal_to_nothing(name, policy)


@pytest.mark.parametrize("policy", ("nothing",) + R.POLICIES)
@pytest.mark.parametrize("name", FAMILIES)
def test_calls_as_derived(name, policy):
    R.check_calls_as_derived(name, policy)


def test_unknown_policy_raises():
    """A policy name the reference's dict lacks raises its ``KeyError``."""
    cfg = dataclasses.replace(ARCHS["qwen2-1.5b"].reduced(),
                              remat_policy="everything")
    m = get_model(cfg)
    params = m.init(device="cpu", masters=True)
    batch = R._torch_batch(R.batch(cfg))
    with pytest.raises(KeyError, match="everything"):
        loss_and_grads(m, params, batch)
