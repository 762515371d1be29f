"""The work counts: the flop counter against hand counts, and the two
kernels' roofline counts against the bounds the kernel table records
(chip_smoke.py's bound_ms: bytes at 3.35 TB/s or operations at 989
TFLOP/s, at PERF.md section 6's shapes)."""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.reference import model as ref


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_flop_counter_counts_a_conv_and_an_attention_as_by_hand():
    x, w = torch.empty(2, 64, 40, 72, device="meta"), torch.empty(128, 64, 3, 3, device="meta")
    assert _flops(lambda: F.conv2d(x, w, padding=1)) == 2 * 2 * 128 * 40 * 72 * 64 * 9
    q = torch.empty(3, 300, 4 * 64, device="meta")
    assert _flops(lambda: ref.Ops().attention(q, q, q, 4)) == 4 * 3 * 4 * 300 * 300 * 64


@pytest.mark.parametrize("kernel, args, bound_ms", [
    ("mlp", (258048, 320), 0.641),           # kernel B, rows 258048, K 320, hidden 1280 (operations)
    ("attn", (28, 5, 9216, 9216, 64), 3.078),  # C's core (28, 5, 9216, 64) (operations)
    ("attn", (28, 5, 2880, 2880, 64), 0.3006),
])
def test_roofline_counts_match_the_kernel_table(kernel, args, bound_ms):
    counts = work.geglu_ff(*args) if kernel == "mlp" else work.attention_core(*args)
    assert work.least_s(*counts) * 1e3 == pytest.approx(bound_ms, rel=2e-3)


def test_a_step_has_69_feed_forwards_and_23_attention_cores():
    from benchmark import config

    cfg = config.load("benchmark/configs/svd14-cn-base.json")
    counts = work.transformers_per_level(cfg["unet"])
    assert counts == [7, 7, 7, 2]
    assert 3 * sum(counts) == 69
