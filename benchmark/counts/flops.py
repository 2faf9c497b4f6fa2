"""Model operations of a ResNet-C4 detector step, counted from shapes.

A convolution of C_in -> C_out channels with a k_h x k_w kernel costs
2 * C_in * C_out * k_h * k_w operations per output pixel (a multiply and an
add per weight).  Backward costs the data gradient (where the input needs
one) and the weight gradient (where the weight trains), each as much as the
forward.  No recompute is counted.  The backbone is counted at each image's
own resized size (not the padded canvas); the Res5 heads at their ROI
counts.  Linear heads, poolings and elementwise work are left out: they are
under 0.5% of a step's operations at these widths."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def conv_flops(cin: int, cout: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * cin * cout * k * k * h_out * w_out


class Layer(tuple):
    """(forward operations, needs a data gradient, trains its weight)."""


def bottleneck(cin: int, cout: int, mid: int, stride: int, h: int, w: int,
               trains: bool, input_grad: bool) -> Tuple[List[tuple], int, int]:
    """A bottleneck block with the stride in its first 1x1 conv (MSRA):
    ([(fwd ops, data grad, weight grad)], h_out, w_out)."""
    h1, w1 = conv_out(h, 1, stride, 0), conv_out(w, 1, stride, 0)
    layers = [(conv_flops(cin, mid, 1, h1, w1), input_grad and trains, trains),
              (conv_flops(mid, mid, 3, h1, w1), trains, trains),
              (conv_flops(mid, cout, 1, h1, w1), trains, trains)]
    if cin != cout or stride != 1:
        layers.append((conv_flops(cin, cout, 1, h1, w1), input_grad and trains, trains))
    return layers, h1, w1


def backbone_layers(depth: int, h: int, w: int, freeze_at: int = 2,
                    res2_out: int = 256) -> Tuple[List[tuple], int, int]:
    """Stem + res2..res4 of ResNet-``depth`` on an h x w image; stages below
    ``freeze_at`` (the stem = 1, res2 = 2) have no gradient."""
    layers = []
    h, w = conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3)
    layers.append((conv_flops(3, 64, 7, h, w), False, freeze_at < 1))
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    cin = 64
    input_grad = False
    for stage, blocks in enumerate(STAGE_BLOCKS[depth][:3]):
        cout = res2_out * 2 ** stage
        mid = cout // 4
        trains = stage + 2 > freeze_at
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            lay, h, w = bottleneck(cin, cout, mid, stride, h, w, trains, input_grad)
            layers += lay
            cin = cout
            input_grad = input_grad or trains
    return layers, h, w


def res5_layers(rois: int, cin: int = 1024, pooled: int = 14, trains: bool = True,
                input_grad: bool = True) -> List[tuple]:
    """The Res5 head (3 blocks, stride 2 in the first) over ``rois`` pooled
    maps of pooled x pooled."""
    layers, h, w = [], pooled, pooled
    for b in range(3):
        lay, h, w = bottleneck(cin if b == 0 else 2048, 2048, 512, 2 if b == 0 else 1, h, w,
                               trains, input_grad or b > 0)
        layers += [(f * rois, dg, wg) for f, dg, wg in lay]
    return layers


def step_ops(layers: Iterable[tuple], backward: bool = True) -> float:
    """Forward plus, with ``backward``, the data and weight gradients."""
    total = 0.0
    for fwd, data_grad, weight_grad in layers:
        total += fwd
        if backward:
            total += fwd * (int(data_grad) + int(weight_grad))
    return total


def train_step_flops(arch: dict, sizes: Sequence[Tuple[int, int]], strong_rois: int,
                     weak_rois: int, mask_rois: int = 0) -> float:
    """Operations of one training step of ``arch`` (depth, freeze_at,
    rpn_dim, num_classes, multi_box_head, mask_on) over images of content
    ``sizes`` (strong and weak together): the backbone and the RPN head on
    each image, the box head (with gradient) over the strong ROIs, the weak
    head over the strong ROIs without gradient where the model has two Res5
    heads, the weak stream's head (with gradient) over the weak ROIs, and the
    mask head over its foreground slots."""
    depth, freeze_at = arch["depth"], arch["freeze_at"]
    total = 0.0
    for h, w in sizes:
        layers, fh, fw = backbone_layers(depth, int(h), int(w), freeze_at)
        total += step_ops(layers)
        a = arch["rpn_anchors"]
        rpn = [(conv_flops(1024, arch["rpn_dim"], 3, fh, fw), True, True),
               (conv_flops(arch["rpn_dim"], a, 1, fh, fw), True, True),
               (conv_flops(arch["rpn_dim"], 4 * a, 1, fh, fw), True, True)]
        total += step_ops(rpn)
    total += step_ops(res5_layers(strong_rois))
    if arch["multi_box_head"]:
        total += step_ops(res5_layers(strong_rois), backward=False)
    total += step_ops(res5_layers(weak_rois))
    if arch.get("mask_on"):
        c = arch["num_classes"]
        mask = [(2.0 * 2048 * 256 * 4 * 7 * 7 * mask_rois, True, True),
                (conv_flops(256, c, 1, 14, 14) * mask_rois, True, True)]
        total += step_ops(mask)
    return total
