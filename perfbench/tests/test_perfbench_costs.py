"""The frozen cost arithmetic against hand-reckoned values and against
the port's own counts (a test may import the port; the harness may not)."""

import pytest

from perfbench.costs import flops, k1, peaks
from perfbench.harness import spec

YI = spec.load_config("yi9b-pair")
DANUBE = spec.load_config("danube-pair")


def test_yi9b_useful_flops():
    a = YI["arch"]
    assert flops.token_flops(a, 512) == pytest.approx(16.81e9, rel=1e-3)
    per_forward = 2 * 16 * flops.row_flops(a, 512)
    assert per_forward == pytest.approx(275e12, rel=2e-3)


def test_danube_useful_flops():
    a = DANUBE["arch"]
    assert flops.token_flops(a, 8192) == pytest.approx(4.09e9, rel=1e-3)
    per_forward = 2 * 4 * flops.row_flops(a, 8192)
    assert per_forward == pytest.approx(268e12, rel=2e-3)


def test_keys_seen_matches_a_loop():
    for S, w in ((512, None), (100, 30), (64, 64), (64, 200), (8192, 4096)):
        loop = sum(min(q + 1, w or q + 1) for q in range(S))
        assert flops.keys_seen(S, w) == loop


@pytest.mark.parametrize("shape", [
    (16, 512, 512, 32, 4, 128, 2, True, None),
    (4, 8192, 8192, 32, 8, 80, 2, True, 4096),
    (2, 300, 300, 8, 2, 64, 4, True, 100),
    (1, 64, 200, 4, 4, 32, 2, False, None),
])
def test_k1_count_is_the_ports(shape):
    from repro_torch.kernels.flash_attention.ops import flash_attention_cost
    B, S, Skv, H, K, hd, item, causal, window = shape
    ours = k1.launch_cost(B, S, Skv, H, K, hd, item, causal=causal,
                          window=window)
    theirs = flash_attention_cost(B, S, Skv, H, K, hd, item, causal=causal,
                                  window=window)
    assert ours == (theirs.flops, theirs.nbytes)


def test_peaks_are_the_ports():
    from repro_torch.analysis import roofline
    assert peaks.BF16_FLOPS == roofline.PEAK_FLOPS
    assert peaks.TF32_FLOPS == roofline.PEAK_TF32
    assert peaks.FP32_FLOPS == roofline.PEAK_FP32
    assert peaks.HBM_BYTES_PER_S == roofline.HBM_BW


def test_k1_bound_is_the_larger_term():
    b = k1.launch_bound_s(16, 512, 32, 4, 128, 2)
    f, n = k1.launch_cost(16, 512, 512, 32, 4, 128, 2)
    assert b == max(f / peaks.BF16_FLOPS, n / peaks.HBM_BYTES_PER_S)
