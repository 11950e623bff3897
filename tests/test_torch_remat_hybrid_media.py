"""The ``dots`` and ``dots_nb`` remat policies of the hybrid, vlm and encdec
families (zamba2-2.7b, llama-3.2-vision-11b, whisper-medium, reduced)
against ``nothing`` and against the JAX package
(``tests/_torch_remat_cases.py``): the loss and every gradient within 1e-4
of ``jax.value_and_grad`` of the reference under the same policy, bit-equal
(``torch.equal``) to the port's ``nothing`` step, the step's kernel calls
as ``chip_smoke.train_launches`` derives them and the recompute's product
calls as derived."""
import pytest

import _torch_remat_cases as R

FAMILIES = ("zamba2-2.7b", "llama-3.2-vision-11b", "whisper-medium")


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

