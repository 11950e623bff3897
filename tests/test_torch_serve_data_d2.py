"""Serving every family at ``(data 2, model 1)`` on gloo ranks
(``tests/_torch_serve_data_cases.py``): each rank's tokens equal the
one-rank launcher's under ``serve_replicated_params`` off and on, and
the dense family's the reference's greedy loop; the MoE families' at
enough requests that capacity binds; a batch of one row, which data 2
does not divide, replicated over the hosts, one rank's tokens."""
import pytest

import _torch_serve_data_cases as D

CASES = [(a, r) for a in D.FAMILIES for r in (False, True)]
IDS = [f"{a}-{'replicated' if r else 'fsdp'}" for a, r in CASES]


@pytest.mark.parametrize("arch,replicated", CASES, ids=IDS)
def test_tokens_equal_one_rank(arch, replicated):
    D.check_tokens("d2", arch, replicated)


@pytest.mark.parametrize("loop", list(D.LOOPS))
@pytest.mark.parametrize("arch", D.BIND)
def test_moe_routing_where_capacity_binds_equals_one_rank(arch, loop):
    D.check_bound("d2", arch, loop)


@pytest.mark.parametrize("loop", list(D.LOOPS))
def test_a_batch_the_data_ranks_do_not_divide_is_replicated(loop):
    """A decode at batch 1 over data 2 (the ranks' ``serve_rank``, below
    the launcher's refusal): every rank runs the row, and its tokens equal
    one rank's, on the engine and on the legacy loop."""
    D.check_replicated("d2", loop)


@pytest.mark.parametrize("legacy", [False, True])
def test_slots_the_data_ranks_do_not_divide_raise(legacy):
    """``--ranks 4`` (``(data 4, model 1)``) with 2 slots (the legacy
    loop: 2 rows) raises before any rank starts: nothing serves at data 1
    in place of the mesh asked for."""
    from repro_torch.launch import serve as launch_serve
    argv = D.argv(D.DENSE) + ["--ranks", "4", "--slots", "2", "--batch",
                              "2"] + (["--legacy-loop"] if legacy else [])
    with pytest.raises(ValueError, match="do not divide over the 4"):
        launch_serve.main(argv)
