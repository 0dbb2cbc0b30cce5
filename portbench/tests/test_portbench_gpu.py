"""The benchmark's small cells and controls on the card (skip without one)."""

import pytest

from portbench import control, harness
from portbench.tests.conftest import TINY

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", list(TINY))
def test_a_small_cell_on_the_card(spec, workload, trace, cuda):
    config_over, mix_over = TINY[workload]
    result, checks = harness.run_cell(spec, workload, 2**31 + 17, 1.0, trace, str(cuda), config_over=config_over,
                                      mix_over=mix_over, log=lambda *_: None)
    assert result["correct"] is True, checks
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]


@pytest.mark.parametrize("workload", list(TINY))
def test_the_control_on_the_card_is_not_correct(spec, workload, cuda):
    config_over, mix_over = TINY[workload]
    numbers, limits = control.control_numbers(spec, workload, 21, str(cuda), config_over, dict(mix_over, sample=128))
    assert any(numbers[name] > limits[name] for name in limits), numbers
