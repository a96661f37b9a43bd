"""The least time's counts against a hand count at both configurations."""

import math

import pytest

from fxbench import roofline


def test_effex2_block_by_hand():
    # 2 channels x 2^18 samples; 4 taps, 4096 bins, 64 frames, 1 baseline
    ops, nbytes = roofline.step_work(nchan=2, num_samp=2**18, nbins=4096,
                                     ntaps=4, n_baselines=1, k=1,
                                     int8=False, continuum=False)
    samples = 2 * 2**18
    assert ops == samples * (2 + 16 + 60) + 8 * 1 * 64 * 4096
    assert nbytes == (8 * samples + 2 * (2 * 3 * 4096 * 8) + 4 * 4 * 4096
                      + 8 * 4096)


def test_array8_call_by_hand():
    # 8 channels of 8 bits, 36 baselines, 32 blocks a call
    ops, nbytes = roofline.step_work(nchan=8, num_samp=2**18, nbins=4096,
                                     ntaps=4, n_baselines=36, k=32,
                                     int8=True, continuum=False)
    samples = 32 * 8 * 2**18
    assert ops == samples * 78 + 8 * 32 * 36 * 64 * 4096
    assert ops / samples == pytest.approx(114.0)
    history = 8 * 3 * 4096 * 2 + 8 * 8
    assert nbytes == 2 * samples + 2 * history + 16 * 4096 + 8 * 32 * 36 * 4096
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    least = roofline.least_time_s(ops, nbytes, peak)
    assert least == ops / 67e12          # bound by its operations
    assert least / 32 == pytest.approx(3.57e-6, rel=1e-2)


def test_continuum_writes_a_value_a_baseline():
    _, spec = roofline.step_work(nchan=2, num_samp=2**18, nbins=4096,
                                 ntaps=4, n_baselines=1, k=8, int8=False,
                                 continuum=False)
    _, cont = roofline.step_work(nchan=2, num_samp=2**18, nbins=4096,
                                 ntaps=4, n_baselines=1, k=8, int8=False,
                                 continuum=True)
    assert spec - cont == 8 * 8 * (4096 - 1)
    assert roofline.peaks("a CPU") is None
    assert math.isclose(roofline.peaks("h100")["hbm_bytes_per_s"], 3.35e12)
