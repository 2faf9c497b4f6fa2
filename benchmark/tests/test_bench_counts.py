"""The benchmark's operation and byte counters against hand counts."""

import bench_testlib  # noqa: F401  (import paths)
from counts import bytes as cbytes
from counts import flops


def test_conv_output_and_flops():
    assert flops.conv_out(800, 7, 2, 3) == 400
    assert flops.conv_out(400, 3, 2, 1) == 200
    assert flops.conv_out(7, 1, 2, 0) == 4
    # 2 operations a multiply-add: 3 -> 64 channels, 7x7, 2x2 outputs
    assert flops.conv_flops(3, 64, 7, 2, 2) == 2 * 3 * 64 * 49 * 4


def test_bottleneck_by_hand():
    layers, h, w = flops.bottleneck(256, 512, 128, 2, 8, 8, trains=True, input_grad=False)
    assert (h, w) == (4, 4)
    fwd = [f for f, _, _ in layers]
    assert fwd == [2 * 256 * 128 * 16, 2 * 128 * 128 * 9 * 16, 2 * 128 * 512 * 16,
                   2 * 256 * 512 * 16]
    # the block's input needs no gradient: its first conv and the shortcut
    # train their weights only
    assert [(d, g) for _, d, g in layers] == [(False, True), (True, True), (True, True),
                                              (False, True)]
    assert flops.step_ops(layers) == (fwd[0] * 2 + fwd[1] * 3 + fwd[2] * 3 + fwd[3] * 2)


def test_frozen_stages_cost_forward_only():
    layers, h, w = flops.backbone_layers(50, 64, 64, freeze_at=2)
    assert (h, w) == (4, 4)
    # stem + res2 (3 blocks, 4 convs in the first) are frozen
    frozen = layers[: 1 + 4 + 3 + 3]
    assert all(not d and not g for _, d, g in frozen)
    assert all(g for _, _, g in layers[len(frozen):])
    stem = 2 * 3 * 64 * 49 * 32 * 32
    assert layers[0][0] == stem


def test_res5_rois_scale_linearly():
    one = flops.step_ops(flops.res5_layers(1))
    assert flops.step_ops(flops.res5_layers(10)) == 10 * one
    fwd = flops.step_ops(flops.res5_layers(1), backward=False)
    # block 0 at 7x7: 1024->512 (1x1), 512->512 (3x3), 512->2048, shortcut 1024->2048
    b0 = 2 * 49 * (1024 * 512 + 512 * 512 * 9 + 512 * 2048 + 1024 * 2048)
    b12 = 2 * 49 * (2048 * 512 + 512 * 512 * 9 + 512 * 2048)
    assert fwd == b0 + 2 * b12


def test_epilogue_and_roi_align_bytes():
    shape = (2, 4, 3, 5)
    n = 2 * 4 * 3 * 5
    assert cbytes.bn_act_forward_bytes(shape, 2, True) == 6 * n
    assert cbytes.bn_act_forward_bytes(shape, 2, False) == 4 * n
    assert cbytes.bn_act_backward_bytes(shape, 2, True, True, True) == 8 * n
    assert cbytes.bn_act_backward_bytes(shape, 2, False, True, False) == 4 * n
    # PERF.md's K2 bound: g [2,512,14,14,1024] + map [2,50,84,1024] in bf16
    b = cbytes.roi_align_backward_bytes((2, 512, 14, 14, 1024), 2, (2, 50, 84, 1024), 2)
    assert round(b / 1e6, 1) == 428.2
