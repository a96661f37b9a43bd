"""The reference against the program's CPU route at a small size: the
same function (float64 against float32), the same calibration; and the
control's rounding."""

import numpy as np
import pytest
import torch

from fxbench import streams
from fxbench.reference import calibrate, fx, judge


@pytest.fixture
def stream():
    x = streams.stream(2**31 + 3, 3, 4 * 4096, [0.0, 2.6, -1.3], 10.0,
                       0.25, "cpu")
    return x.reshape(3, 4, 4096).permute(1, 0, 2).contiguous()


def test_reference_matches_the_program_s_cpu_route(stream):
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops.xengine import pack_delays
    cfg = CorrelatorConfig(nchan=3, num_samp=4096, nbins=256,
                           include_autos=True, device="cpu")
    eng = FxEngine(cfg)
    delays = np.array([0.0, 1.1e-6, -0.5e-6])
    packed = torch.as_tensor(pack_delays(delays, cfg.frequency))
    w2d = fx.prototype(4, 256)
    pairs = fx.baselines(3, True)
    np.testing.assert_array_equal(pairs, eng.pairs)
    hist = eng.fresh_history()
    for j in range(4):
        vis, hist = eng.step(eng.prepare_block(stream[j].numpy()), packed,
                             hist)
        want = fx.fx_block(stream[j], stream[j - 1] if j else None, w2d,
                           pairs, delays, cfg.bandwidth, cfg.frequency)
        assert judge.spectrum_gap(vis.numpy(), want.numpy()) < 2e-5


def test_calibration_matches_the_program_s(stream):
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    cfg = CorrelatorConfig(nchan=3, num_samp=4096, nbins=256, device="cpu")
    eng = FxEngine(cfg)
    got = eng.calibrate_block(eng.prepare_block(stream[0].numpy()),
                              4096).numpy().astype(np.float64)
    want = calibrate.estimate_delays(stream[0], cfg.bandwidth, 4096)
    assert judge.delay_gap_samples(got, want, cfg.bandwidth) < 0.02
    np.testing.assert_allclose(want * cfg.bandwidth, [0.0, 2.6, -1.3],
                               atol=0.25)


def test_the_control_rounds_to_bfloat16(stream):
    x = torch.tensor([1.0 + 1.0 / 512, 3.0], dtype=torch.float64)
    assert fx.bf16(x).tolist() == [1.0, 3.0]
    w2d = fx.prototype(4, 256)
    pairs = fx.baselines(3, False)
    args = (stream[1], stream[0], w2d, pairs, [0.0, 1e-6, 2e-6], 2.4e6,
            1.42e9)
    want = fx.fx_block(*args).numpy()
    ctl = fx.fx_block(*args, rnd=fx.bf16).numpy()
    assert 1e-3 < judge.spectrum_gap(ctl, want) < 1e-1
    q = streams.quantize(stream[0], 1 / 32)
    np.testing.assert_array_equal(fx.dequantize(q, 1 / 32, fx.bf16).numpy(),
                                  fx.dequantize(q, 1 / 32).numpy())
