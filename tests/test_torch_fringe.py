"""TEST mode's fringe sweep through the port's engine, held to ``fxtpu``'s
(``tests/test_fringe.py``): the same blocks go through both packages'
engines (each calibrates its first block, then sweeps the delay 200
steps), the port's sweep stays within 2e-5 of its peak of ``fxtpu``'s
(the fused-against-unfused bound, tests/test_planes.py:318-321) and its
calibration within 0.01 sample, and the port's post-processing recovers
the envelope as ``fxtpu``'s does."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
jnp = pytest.importorskip("jax.numpy")   # absent on the card's machine

from fxtpu.config import CorrelatorConfig as JConfig  # noqa: E402
from fxtpu.fx import FxEngine as JEngine  # noqa: E402
from fxtpu.ops.cplx import to_complex  # noqa: E402
from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine  # noqa: E402
from fxtpu_torch.post_process import (fit_fringe_envelope,  # noqa: E402
                                      fit_interferometer_model,
                                      fringe_envelope, post_process)
from fxtpu_torch.sources import NoiseSource  # noqa: E402

BW = 2.4e6
CFG = dict(mode="TEST", num_samp=2**14, nbins=256, bandwidth=BW,
           clamp_num_samp=False, test_sweep_step=(1 / BW) / 50,
           test_offset_steps=100)


def _sweep(eng, blocks, cfg, to_dev, vis_of):
    """The reference's TEST schedule: calibrate on block 0, subtract the
    sweep offset (effex.py:578-579), then step the delay once a block
    (effex.py:403-404).  Returns (visibilities, calibration residual)."""
    hist = eng.fresh_history()
    d = np.asarray(eng.calibrate(eng.prepare_block(blocks[0])), np.float64)
    cal_err = float(d[1])
    d[1:] -= cfg.test_delay_offset
    vis = []
    for blk in blocks[1:]:
        d[1:] += cfg.test_delay_sweep_step
        v, hist = eng.step(eng.prepare_block(blk), to_dev(d), hist)
        vis.append(vis_of(v))
    return np.asarray(vis), cal_err


@pytest.fixture(scope="module")
def sweep():
    src = NoiseSource(nchan=2, sample_rate=BW, snr=100, seed=3)
    blocks = [src.read_block(CFG["num_samp"]) for _ in range(201)]
    cfg = CorrelatorConfig(**CFG, device="cpu")
    vis, cal_err = _sweep(FxEngine(cfg), blocks, cfg,
                          lambda d: torch.tensor(d, dtype=torch.float32),
                          lambda v: complex(v[0]))
    jcfg = JConfig(**CFG)
    jvis, jcal = _sweep(JEngine(jcfg), blocks, jcfg,
                        lambda d: jnp.asarray(d, dtype=np.float32),
                        lambda v: complex(to_complex(v)[0]))
    assert abs(cal_err - jcal) * BW < 0.01
    np.testing.assert_allclose(vis, jvis, atol=2e-5 * np.abs(jvis).max())
    return cfg, vis, cal_err


def test_fringe_peak_at_sweep_zero(sweep):
    cfg, vis, _ = sweep
    assert abs(int(np.argmax(np.abs(vis))) - (cfg.test_offset_steps - 1)) <= 2


def test_fringe_envelope_recovers_bandwidth(sweep):
    cfg, vis, cal_err = sweep
    pfit, _ = fit_fringe_envelope(vis, cfg.test_delay_sweep_step,
                                  cfg.bandwidth,
                                  offset_steps=cfg.test_offset_steps)
    amp_fit, tau0, dnu = pfit
    assert abs(dnu - cfg.bandwidth) / cfg.bandwidth < 0.02
    assert abs(tau0 - cal_err) < cfg.test_delay_sweep_step
    assert abs(tau0) < 3 * cfg.test_delay_sweep_step
    tau = ((np.arange(len(vis)) + 1 - cfg.test_offset_steps)
           * cfg.test_delay_sweep_step)
    resid = np.abs(vis) - fringe_envelope(tau, *pfit)
    assert np.max(np.abs(resid)) < 0.1 * np.abs(vis).max()


def test_first_null_position(sweep):
    cfg, vis, _ = sweep
    amp = np.abs(vis)
    k0 = int(np.argmax(amp))
    null_steps = int(round((1 / cfg.bandwidth) / cfg.test_delay_sweep_step))
    assert amp[k0 + null_steps - 3: k0 + null_steps + 4].min() < 0.05 * amp[k0]


def test_reference_parity_fit_converges(sweep):
    cfg, vis, _ = sweep
    pfit, _ = fit_interferometer_model(vis, cfg.test_delay_sweep_step,
                                       cfg.bandwidth, cfg.frequency,
                                       tau0_seed=0.0, show=False)
    assert np.all(np.isfinite(pfit))


def test_post_process_driver_test_mode(sweep, tmp_path):
    cfg, vis, _ = sweep
    pfit = post_process(vis, cfg.bandwidth, cfg.frequency, cfg.nbins, "test",
                        omit_plot=False,
                        test_delay_sweep_step=cfg.test_delay_sweep_step,
                        save=str(tmp_path / "fig.png"), show=False)
    assert pfit is not None
    assert (tmp_path / "fig.png").exists()
    assert (tmp_path / "fig_fit.png").exists()
