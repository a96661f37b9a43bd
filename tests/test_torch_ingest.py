"""8-bit ingest on the host: fxtpu_torch's int8 data-plane helpers and
QuantizedSource against fxtpu's on the same numpy samples (CPU), with the
native loops of native/libfxring.so and with their numpy fallbacks.
Quantized samples are integers, so everything is compared exactly."""

import numpy as np
import pytest

pytest.importorskip("jax")   # the reference; absent on the card's machine

from fxtpu import sources as jsources  # noqa: E402
from fxtpu.runtime import native as jnative  # noqa: E402
from fxtpu_torch import sources as tsources  # noqa: E402
from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.runtime import native as tnative  # noqa: E402

STEP = 1.0 / 32


def _samples(shape, seed=3):
    """Complex samples that also hit the clip (|x| > 127 steps) and exact
    half steps (round half to even)."""
    rng = np.random.default_rng(seed)
    x = (5 * rng.normal(size=shape) + 5j * rng.normal(size=shape))
    x.flat[:4] = [4.5 + 0.5j, -1.5 - 2.5j, 9.0 - 9.0j, (0.5 + 3.5j) * STEP]
    return x.astype(np.complex64)


@pytest.fixture(params=["native", "numpy"])
def data_plane(request, monkeypatch):
    """Both implementations of each helper: the native loop when the
    library is built, and the numpy fallback."""
    if request.param == "native":
        if tnative._dataplane() is None:
            pytest.skip("native/libfxring.so is not built")
    else:
        monkeypatch.setattr(tnative, "_dataplane", lambda: None)
    return request.param


def test_quantize_c64_matches_fxtpu(data_plane):
    x = _samples((2, 4096))
    want = jnative.quantize_c64(x, STEP)
    got = tnative.quantize_c64(x, STEP)
    assert got.dtype == np.int8 and got.shape == (2, 4096, 2)
    np.testing.assert_array_equal(got, want)
    assert abs(got).max() == 127
    # straight into a ring slot (the zero-copy producer)
    slot = np.empty((4096, 2), np.int8)
    assert tnative.quantize_c64(x[1], STEP, out=slot) is slot
    np.testing.assert_array_equal(slot, want[1])
    with pytest.raises(ValueError, match="out"):
        tnative.quantize_c64(x[1], STEP, out=np.empty((4096, 2), np.int16))


def test_split_planes_i8_matches_fxtpu(data_plane):
    q = jnative.quantize_c64(_samples((3, 1024)), STEP)
    for got, want in zip(tnative.split_planes_i8(q),
                         jnative.split_planes_i8(q)):
        assert got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)


def test_quantized_source_blocks_match_fxtpu():
    kw = dict(nchan=2, delays=[0.0, 2e-6], seed=9)
    jsrc = jsources.QuantizedSource(jsources.NoiseSource(**kw), STEP)
    tsrc = tsources.QuantizedSource(tsources.NoiseSource(**kw), STEP)
    for _ in range(2):
        got, want = tsrc.read_block(4096), jsrc.read_block(4096)
        assert got.dtype == np.int8 and got.shape == (2, 4096, 2)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsrc.read_block_span(4096, 100, 300),
                                  jsrc.read_block_span(4096, 100, 300))
    # the tuning setters reach the wrapped source
    tsrc.sample_rate, tsrc.center_freq, tsrc.gain = 2.0e6, 1.0e9, 20.0
    assert (tsrc.inner.sample_rate, tsrc.inner.center_freq,
            tsrc.inner.gain) == (2.0e6, 1.0e9, 20.0)


def test_quantized_replay_splits_quantize_into_ring_slots(tmp_path):
    rec = tsources.save_recording(tsources.NoiseSource(nchan=2, seed=1),
                                  str(tmp_path / "rec.npy"), 2048, 3)
    whole = tsources.QuantizedSource(tsources.ReplaySource(rec), STEP)
    splits = tsources.QuantizedSource(tsources.ReplaySource(rec),
                                      STEP).split_channels()
    assert len(splits) == 2 and all(s.nchan == 1 for s in splits)
    state = splits[0].snapshot_state()
    for _ in range(3):
        want = whole.read_block(2048)
        for c, s in enumerate(splits):
            slot = np.empty((2048, 2), np.int8)
            assert s.read_block_into(slot, 2048)
            np.testing.assert_array_equal(slot, want[c])
    assert not splits[0].read_block_into(np.empty((2048, 2), np.int8), 2048)
    splits[0].restore_state(state)
    assert splits[0].read_block_into(np.empty((2048, 2), np.int8), 2048)
    with pytest.raises(ValueError, match="1-channel"):
        whole.read_block_into(np.empty((2048, 2), np.int8), 2048)


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_make_source_wraps_int8_ingest_like_fxtpu(tmp_path, ingest):
    from fxtpu.config import CorrelatorConfig as JConfig
    rtl = tmp_path / "cap.iq"
    np.random.default_rng(2).integers(0, 256, 2 * 4096, dtype=np.uint8
                                      ).tofile(rtl)
    cases = [dict(source="synthetic", synthetic_delay=1e-6),
             dict(source="replay", replay_file=",".join([str(rtl)] * 2))]
    for kw in cases:
        common = dict(kw, ingest_dtype=ingest, num_samp=4096, nbins=256,
                      quant_step=STEP)
        tsrc = tsources.make_source(CorrelatorConfig(**common, device="cpu"))
        jsrc = jsources.make_source(JConfig(**common))
        assert type(tsrc).__name__ == type(jsrc).__name__
        got, want = tsrc.read_block(4096), jsrc.read_block(4096)
        assert got.dtype == (np.int8 if ingest == "int8" else np.complex64)
        np.testing.assert_array_equal(got, want)


def test_config_rejects_unknown_ingest():
    with pytest.raises(ValueError, match="ingest_dtype"):
        CorrelatorConfig(ingest_dtype="int16", device="cpu")
