"""The port's dispatch-amortized timers (beam_slam_tpu_torch.utils.timing)
on the CPU: both return positive finite medians; ``inner`` is chosen as the
reference's rule chooses it (a pilot chain of 16, then a ~0.5 s chain of
16–2048 calls unless that is ≤ 24); a ``perturb`` that is given is called
with the chain's carry on every call."""

import math

import pytest
import torch

from beam_slam_tpu_torch.utils import timing

torch.set_num_threads(2)


def test_amortized_median_is_positive_and_finite():
    a = torch.randn(64, 64)
    ms = timing.amortized_median_ms(torch.matmul, a, a, n_rep=3, inner=8)
    assert math.isfinite(ms) and ms > 0


def test_chained_median_is_positive_and_finite():
    ms = timing.chained_median_ms(lambda s: s * 0.5 + 1.0, torch.ones(16),
                                  n_rep=3, inner=8)
    assert math.isfinite(ms) and ms > 0
    lengths = []
    timing.chained_median_ms(lambda s: lengths.append(1) or s,
                             torch.ones(1), n_rep=3, inner=5)
    assert len(lengths) == 5 * (1 + 3)      # the warm chain, then 3


def _chain_lengths(monkeypatch, pilot_ms):
    """The chain lengths the adaptive rule asks for when every chain
    reports ``pilot_ms`` a call."""
    seen = []

    def fake(run_chain, length, device):
        seen.append(length)
        return pilot_ms / 1e3
    monkeypatch.setattr(timing, "_time_chain", fake)
    ms = timing.amortized_median_ms(lambda x: x, torch.zeros(1), n_rep=8)
    return seen, ms


@pytest.mark.parametrize("pilot_ms, length", [
    (50.0, None),      # 500 / 50 = 10 → 16 ≤ 24: the pilot's number stands
    (25.0, 20),        # 20 calls: still ≤ 24
    (5.0, 100),        # 500 / 5
    (1e-4, 2048),      # capped
])
def test_inner_is_chosen_as_in_the_reference(monkeypatch, pilot_ms, length):
    seen, ms = _chain_lengths(monkeypatch, pilot_ms)
    assert seen[:3] == [16, 16, 16]          # the pilot: median of 3
    if length is None or length <= 24:
        assert seen == [16, 16, 16]
    else:
        assert seen[3:] == [length] * 5      # min(n_rep, 5) chains
    assert ms == pytest.approx(pilot_ms)


def test_given_perturb_is_called_with_the_carry():
    calls = []

    def perturb(args, acc):
        calls.append(float(acc))
        return (args[0] + acc,)
    x = torch.arange(4.0)
    outs = []
    timing.amortized_median_ms(lambda t: outs.append(t.clone()) or t * 2, x,
                               perturb=perturb, n_rep=2, inner=3)
    assert len(calls) == 3 * (1 + 2)
    assert all(c == 0.0 for c in calls)
    assert all(torch.equal(o, x) for o in outs)   # inert, as the reference's
