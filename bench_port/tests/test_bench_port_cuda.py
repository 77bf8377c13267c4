"""On the card (``cuda`` marker; skipped without one): a sound run of each
configuration at 128^3 is correct, and each configuration's control at that
size fails the comparison.  On the chip:

    python -m pytest --noconftest -m cuda bench_port/tests/test_bench_port_cuda.py
"""

import dataclasses
import time

import pytest
import torch

from bench_port import calibrate, check, harness, spec

pytestmark = pytest.mark.cuda
SHAPE = [128, 128, 128]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cell(name):
    cell = spec.load_cell(name)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, shape=SHAPE))


@pytest.mark.parametrize("workload", ["ved512", "mad512", "ved512-gd"])
def test_a_sound_run_is_correct(card, workload):
    result = harness.run(_cell(workload), 2**32 + 11, 2.0, False, card, time.perf_counter())
    assert result["correct"], result["check"]


@pytest.mark.parametrize("workload", ["ved512", "mad512", "ved512-gd"])
def test_the_control_fails(card, workload):
    cell = _cell(workload)
    for seed in (41, 42, 43):
        (values,) = calibrate.readings(cell, [seed], True, card, lambda line: None)
        assert not check.verdict(values, cell.traffic["check"]["limits"]), values
