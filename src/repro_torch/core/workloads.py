"""CNN workload definitions used by the paper: AlexNet, VGG-16, ResNet-50 (a
copy of ``repro.core.workloads``).

Layer shapes follow the papers the INA paper cites:
  * AlexNet ("one weird trick" single-tower variant, arXiv:1404.5997) — the
    R/C/F/O values match the INA paper's Table I exactly.
  * VGG-16 (ICLR'15) — matches Table II exactly.
  * ResNet-50 (CVPR'16) — the INA paper gives no table; we enumerate every
    CONV layer of the standard v1 bottleneck network.

Beyond the paper (the mapper's front-end, see DESIGN.md S9): the FC layers
the paper's tables omit (:data:`ALEXNET_FC` / :data:`VGG16_FC`, as
:class:`~repro_torch.core.ops.GemmLayer` shapes) and transformer projection/MLP
GEMMs derived from the ``configs/`` model registry
(:func:`mapper_workloads`).  ``WORKLOADS`` itself stays CONV-only — the
fig7-12 pins depend on it.
"""
from __future__ import annotations

from .ina_model import ConvLayer
from .ops import GemmLayer, LayerShape, transformer_gemms

# --------------------------------------------------------------------------- #
# AlexNet (Table I)
# --------------------------------------------------------------------------- #
ALEXNET = [
    ConvLayer("CONV1", R=11, C=3,   F=64,  O=55, stride=4),
    ConvLayer("CONV2", R=5,  C=64,  F=192, O=27),
    ConvLayer("CONV3", R=3,  C=192, F=384, O=13),
    ConvLayer("CONV4", R=3,  C=384, F=256, O=13),
    ConvLayer("CONV5", R=3,  C=256, F=256, O=13),
]

# --------------------------------------------------------------------------- #
# VGG-16 (Table II)
# --------------------------------------------------------------------------- #
VGG16 = [
    ConvLayer("CONV1",  R=3, C=3,   F=64,  O=224),
    ConvLayer("CONV2",  R=3, C=64,  F=64,  O=224),
    ConvLayer("CONV3",  R=3, C=64,  F=128, O=112),
    ConvLayer("CONV4",  R=3, C=128, F=128, O=112),
    ConvLayer("CONV5",  R=3, C=128, F=256, O=56),
    ConvLayer("CONV6",  R=3, C=256, F=256, O=56),
    ConvLayer("CONV7",  R=3, C=256, F=256, O=56),
    ConvLayer("CONV8",  R=3, C=256, F=512, O=28),
    ConvLayer("CONV9",  R=3, C=512, F=512, O=28),
    ConvLayer("CONV10", R=3, C=512, F=512, O=28),
    ConvLayer("CONV11", R=3, C=512, F=512, O=14),
    ConvLayer("CONV12", R=3, C=512, F=512, O=14),
    ConvLayer("CONV13", R=3, C=512, F=512, O=14),
]


# --------------------------------------------------------------------------- #
# ResNet-50 v1 (bottleneck blocks)
# --------------------------------------------------------------------------- #
def _bottleneck(stage: str, idx: int, c_in: int, width: int, c_out: int,
                o: int, first_stride: int) -> list[ConvLayer]:
    """One bottleneck block: 1x1 reduce, 3x3, 1x1 expand (+ projection on idx 0)."""
    tag = f"{stage}_{idx}"
    layers = [
        ConvLayer(f"{tag}_1x1a", R=1, C=c_in,  F=width, O=o, stride=first_stride),
        ConvLayer(f"{tag}_3x3",  R=3, C=width, F=width, O=o),
        ConvLayer(f"{tag}_1x1b", R=1, C=width, F=c_out, O=o),
    ]
    if idx == 0:
        layers.append(ConvLayer(f"{tag}_proj", R=1, C=c_in, F=c_out, O=o,
                                stride=first_stride))
    return layers


def _resnet50() -> list[ConvLayer]:
    layers = [ConvLayer("CONV1", R=7, C=3, F=64, O=112, stride=2)]
    c_in = 64
    for stage, (blocks, width, c_out, o) in {
        "conv2": (3, 64, 256, 56),
        "conv3": (4, 128, 512, 28),
        "conv4": (6, 256, 1024, 14),
        "conv5": (3, 512, 2048, 7),
    }.items():
        for idx in range(blocks):
            stride = 2 if (idx == 0 and stage != "conv2") else 1
            layers.extend(_bottleneck(stage, idx, c_in, width, c_out, o, stride))
            c_in = c_out
    return layers


RESNET50 = _resnet50()

WORKLOADS: dict[str, list[ConvLayer]] = {
    "alexnet": ALEXNET,
    "vgg16": VGG16,
    "resnet50": RESNET50,
}


# --------------------------------------------------------------------------- #
# FC layers (single-image GEMMs the paper's tables leave out)
# --------------------------------------------------------------------------- #
ALEXNET_FC = [
    GemmLayer("FC6", M=1, K=256 * 6 * 6, N=4096),
    GemmLayer("FC7", M=1, K=4096, N=4096),
    GemmLayer("FC8", M=1, K=4096, N=1000),
]

VGG16_FC = [
    GemmLayer("FC14", M=1, K=512 * 7 * 7, N=4096),
    GemmLayer("FC15", M=1, K=4096, N=4096),
    GemmLayer("FC16", M=1, K=4096, N=1000),
]

FC_LAYERS: dict[str, list[GemmLayer]] = {
    "alexnet": ALEXNET_FC,
    "vgg16": VGG16_FC,
}


def full_workload(name: str) -> list[LayerShape]:
    """CONV stack plus the FC tail (where the network has one)."""
    return list(WORKLOADS[name]) + list(FC_LAYERS.get(name, []))


def mapper_workloads(conv: tuple[str, ...] = ("alexnet", "vgg16", "resnet50"),
                     transformers: tuple[str, ...] = ("llama3-8b",
                                                      "qwen2-1.5b"),
                     tokens: int = 256) -> dict[str, list[LayerShape]]:
    """The mapper's workload set: FC-complete CNNs + transformer GEMM blocks.

    ``transformers`` are ``configs/`` registry names; each contributes one
    decoder block's q/k/v/o + gate/up/down GEMMs under the key
    ``"<name>:gemm"`` (ratios are depth-invariant, see ``core.ops``).
    """
    out: dict[str, list[LayerShape]] = {n: full_workload(n) for n in conv}
    if transformers:
        from repro_torch.configs import ARCHS
        for t in transformers:
            out[f"{t}:gemm"] = list(transformer_gemms(ARCHS[t], tokens))
    return out
