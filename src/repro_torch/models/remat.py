"""Activation-checkpoint policies (the reference's ``remat_policy``,
``repro.models.transformer``).

The reference checkpoints each scanned layer with ``jax.checkpoint(body,
policy=...)``; ``cfg.remat_policy`` picks the policy:

  * ``nothing`` (``nothing_saveable``): every activation is recomputed;
  * ``dots`` (``checkpoint_dots``): every ``dot_general``'s output is kept;
  * ``dots_nb`` (``dots_with_no_batch_dims_saveable``): the outputs of the
    dots without batch dimensions are kept.

The port checkpoints a layer with ``torch.utils.checkpoint`` (non-reentrant,
:func:`repro_torch.models.transformer.remat`) and gives it the pair of
contexts of one :class:`repro_torch.core.remat.Tape` holding the kinds
:func:`remat_policy` names: in the first forward each product of those
kinds records its output; in the recompute it returns that output, in
order, and computes nothing.

Each product of a checkpointed layer is classified by the reference dot it
stands for (:data:`KINDS`):

  * ``"nb"``, no batch dimensions: every INA projection
    (:func:`repro_torch.kernels.ops.matmul`; each ``column_linear`` /
    ``row_linear`` einsum of the reference), the MoE router, RWKV6's two
    LoRA products;
  * ``"batched"``: the experts' three ``torch.bmm`` (``ecd,edf->ecf``),
    the MoE combine (``tkd,tk->td``, batched over the tokens ``t``; the
    port sums it as a weighted reduction, whose sum is the kept output),
    MLA's plain attention einsums and Mamba2's SSD einsums;
  * ``"fused"``, a kernel that fuses batched dots: flash attention (the
    reference's score and PV einsums) and ``wkv6`` (``_wkv_chunk``'s
    einsums).  Under ``dots`` the kernel's output is kept, since every dot
    it fuses is kept there; under ``dots_nb`` it is recomputed.  The
    scores such a kernel never forms are kept under neither policy: this
    is the port's one deliberate difference from the reference.

Serving never checkpoints, so no policy is looked up on its path.
"""
from __future__ import annotations

#: the product kinds (module docstring)
KINDS = ("nb", "batched", "fused")
#: the reference's policy names -> the kinds whose outputs a layer keeps
POLICIES = {"nothing": frozenset(),
            "dots_nb": frozenset({"nb"}),
            "dots": frozenset(KINDS)}


def remat_policy(cfg) -> frozenset:
    """The product kinds a checkpointed layer of ``cfg`` keeps
    (:data:`POLICIES`).  A name the reference lacks raises ``KeyError``,
    as the reference's dict lookup does."""
    return POLICIES[cfg.remat_policy]
