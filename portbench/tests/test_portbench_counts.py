"""The FLOP and byte counts against hand counts."""

import pytest

from counts import mlp, peaks


def test_forward_flops_by_hand():
    # walker: [24 + 6] -> 50 -> 50 -> 24
    assert mlp.macs(24, 6, 50) == 30 * 50 + 50 * 50 + 50 * 24 == 5200
    assert mlp.forward_flops(17, 6, 50) == 2 * (23 * 50 + 2500 + 850)


@pytest.mark.parametrize('sd, ms', [(24, 2.58), (17, 2.24)])
def test_sampler_flop_bound_at_4096(sd, ms):
    flops = mlp.sampler_flops(4096, 1000, 30, sd, 6, 50)
    assert flops / peaks.PEAK_FLOPS['float32'] * 1e3 == pytest.approx(
        ms, abs=0.005)


def test_sampler_bytes_by_hand():
    B, K, H, sd, ad, hid = 4096, 1000, 30, 24, 6, 50
    weights = 5200 + 2 * 50 + 24
    by_hand = 4 * (B * sd + 2 * B * H * ad + weights + 2 * sd
                   + B * K + B * H * ad * K)
    assert mlp.sampler_bytes(B, K, H, sd, ad, hid) == by_hand
    assert by_hand / peaks.PEAK_BYTES_PER_S * 1e3 == pytest.approx(
        0.89, abs=0.005)


def test_plan_flops():
    assert mlp.plan_flops(2, 3, 4, 3, 24, 6, 50) == 3 * 2 * 3 * 4 * 10400
