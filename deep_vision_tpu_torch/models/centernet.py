"""CenterNet ("Objects as Points") on the hourglass backbone.

Port of ``deep_vision_tpu/models/centernet.py`` (``CENTERNET_FILTERS``,
``DetectionHead``, ``CenterNet``).  The stem is a 7×7/2 conv with flax's
"SAME" padding — at an even input that pads (2, 3), not torch's
symmetric 3 — then BatchNorm + ReLU, a pre-activation bottleneck and a
2×2 pool (H → H/4).  Each stack is an hourglass module, a 3×3 conv +
BatchNorm + ReLU, and three BatchNorm-free heads (class heatmap logits,
wh, offset); between stacks a 1×1 conv of the stack's features is added
back to its input (re-injection).  Every conv has a bias.

``forward`` takes the reference's NHWC layout and returns one
``(heat, wh, offset)`` triple per stack, each float32 NHWC
``(B, H/4, W/4, ·)``.

The pipeline split (``parallel/pipelined.py``), as for the Stacked
Hourglass (``models/hourglass.py``): ``CenterNetStem`` is the stem alone
(``conv``, ``bn``, ``block``: the monolithic ``stem_conv``, ``stem_bn``,
``stem_block``), ``CenterNetStack`` one stack that always re-injects,
and ``merge_/split_centernet_variables`` rename a pipelined
``state_dict`` to the monolithic one and back, the last stage's
re-injection conv dropped by the merge and taken from a template by the
split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deep_vision_tpu_torch.models.common import (
    BatchNorm2d,
    Conv2d,
    conv_kernel_init,
    lecun_conv_init,
    same_pad,  # noqa: F401 (re-exported for the tests)
)
from deep_vision_tpu_torch.models.hourglass import (
    HourglassModule,
    PreActBottleneck,
    hourglass_stem,
    merge_stage_layout,
    num_stages,
    split_stage_layout,
)

#: depth-indexed filters of the order-5 module
CENTERNET_FILTERS = (256, 256, 384, 384, 384, 512)
#: the heatmap head's bias: sigmoid(-2.19) ≈ 0.1 at init
HEAT_BIAS = -2.19


class DetectionHead(nn.Module):
    """3×3 conv + ReLU → 3×3 conv to ``out_features``, no BatchNorm;
    the output leaves as float32 NHWC."""

    def __init__(self, in_ch: int, out_features: int, features: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, features, 3, 1, 1, dtype, bias=True)
        self.out = Conv2d(features, out_features, 3, 1, 1, dtype, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.out(F.relu(self.conv(x)))
        return y.permute(0, 2, 3, 1).to(torch.float32)


class CenterNetStack(nn.Module):
    """One stack: hourglass → 3×3 conv + BN + ReLU → the three heads,
    and with ``reinject`` (all but the last stack of the monolithic
    network, every pipeline stage) the 1×1 re-injection conv of the
    features, added to the stack's input for the next stack."""

    def __init__(self, num_classes: int, order: int = 5,
                 filters=CENTERNET_FILTERS, reinject: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        base = filters[0]
        self.compute_dtype = dtype
        self.hourglass = HourglassModule(base, order, list(filters), 1,
                                         dtype)
        self.conv = Conv2d(base, base, 3, 1, 1, dtype, bias=True)
        self.bn = BatchNorm2d(base, dtype)
        self.heat = DetectionHead(base, num_classes, base, dtype)
        self.wh = DetectionHead(base, 2, base, dtype)
        self.offset = DetectionHead(base, 2, base, dtype)
        self.reinject = Conv2d(base, base, 1, dtype=dtype, bias=True) \
            if reinject else None

    def forward(self, x: torch.Tensor):
        """``(next stack's input, (heat, wh, offset))``."""
        y = F.relu(self.bn(self.conv(self.hourglass(x))))
        heads = (self.heat(y), self.wh(y), self.offset(y))
        if self.reinject is not None:
            x = x + self.reinject(y)
        return x, heads


class CenterNetStem(nn.Module):
    """The stem of :class:`CenterNet` alone: NHWC ``(N, H, W, 3)`` → the
    first stack's input, NCHW ``(N, filters[0], H/4, W/4)``."""

    def __init__(self, filters=CENTERNET_FILTERS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        base = filters[0]
        self.compute_dtype = dtype
        self.conv = Conv2d(3, base // 2, 7, 2, 0, dtype, bias=True)
        self.bn = BatchNorm2d(base // 2, dtype)
        self.block = PreActBottleneck(base // 2, base, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hourglass_stem(x, self.conv, self.bn, (self.block,),
                              self.compute_dtype)


class CenterNet(nn.Module):
    """256²×3 → per stack (heatmap logits (64², C), wh (64², 2), offset
    (64², 2)).  ``order``/``filters`` default to the reference's order-5
    table; ``2**order`` must divide ``input_size / 4``."""

    def __init__(self, num_classes: int = 80, num_stack: int = 2,
                 order: int = 5, filters=CENTERNET_FILTERS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.num_stack = num_stack
        self.order = order
        self.filters = tuple(filters)
        self.compute_dtype = dtype
        base = self.filters[0]
        self.stem_conv = Conv2d(3, base // 2, 7, 2, 0, dtype, bias=True)
        self.stem_bn = BatchNorm2d(base // 2, dtype)
        self.stem_block = PreActBottleneck(base // 2, base, dtype)
        self.stacks = nn.ModuleList(
            CenterNetStack(num_classes, order, self.filters,
                           s < num_stack - 1, dtype)
            for s in range(num_stack))

    def set_compute_dtype(self, dtype: torch.dtype) -> "CenterNet":
        for m in self.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype
        return self

    def forward(self, x: torch.Tensor):
        """NHWC ``(N, H, W, 3)`` float input → a tuple of ``num_stack``
        ``(heat, wh, offset)`` float32 NHWC triples."""
        x = hourglass_stem(x, self.stem_conv, self.stem_bn,
                           (self.stem_block,), self.compute_dtype)
        outputs = []
        for stack in self.stacks:
            x, heads = stack(x)
            outputs.append(heads)
        return tuple(outputs)

    def reset_parameters(self, generator: torch.Generator) -> "CenterNet":
        """The reference's init (:func:`reset_centernet_parameters`)."""
        reset_centernet_parameters(self, generator)
        return self


def reset_centernet_parameters(module: nn.Module,
                               generator: torch.Generator) -> None:
    """The reference's init, in module order: He normal over fan-out for
    the convs that name ``conv_kernel_init``, flax's default LeCun normal
    (truncated at two standard deviations) for the heads' last conv and
    the re-injection conv; biases 0 but the heatmap head's −2.19;
    BatchNorm scale 1 and bias 0, running mean 0 and variance 1.  The
    pipeline split draws what the monolithic network draws, the last
    stage's re-injection conv last."""
    stacks = [m for m in module.modules() if isinstance(m, CenterNetStack)]
    lecun = set()
    for stack in stacks:
        lecun.update(id(h.out) for h in (stack.heat, stack.wh, stack.offset))
        if stack.reinject is not None:
            lecun.add(id(stack.reinject))
    for m in module.modules():
        if isinstance(m, Conv2d):
            if id(m) in lecun:
                lecun_conv_init(m.weight, generator)
            else:
                conv_kernel_init(m.weight, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm2d):
            m.reset_parameters()
    with torch.no_grad():
        for stack in stacks:
            stack.heat.out.bias.fill_(HEAT_BIAS)


#: the re-injection conv a pipeline stage has and the monolithic
#: network's last stack does not
CENTERNET_LAST_ONLY = ("reinject.",)


def merge_centernet_variables(state_dict: dict, num_stack: int) -> dict:
    """A pipelined CenterNet ``state_dict`` (``CenterNetStem`` and
    ``num_stack`` ``CenterNetStack`` stages) → the monolithic
    :class:`CenterNet` one; the last stage's re-injection conv is
    dropped."""
    return merge_stage_layout(state_dict, num_stack, CENTERNET_LAST_ONLY)


def split_centernet_variables(state_dict: dict, template: dict) -> dict:
    """The inverse of :func:`merge_centernet_variables`; the last
    stage's re-injection conv comes from ``template``."""
    return split_stage_layout(state_dict, template, num_stages(template),
                              CENTERNET_LAST_ONLY)
