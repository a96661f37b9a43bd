"""The single pass's wide route (the X stage over spectra in device
memory, for channel counts whose spectra of a frame do not fit in one
CTA's shared memory) against the JAX package and against the port's
shared-memory route, on the CPU through the plain versions; its CUDA
kernels against those plain versions on a card (marked ``cuda``).

fxtpu_torch.ops.fx_fused.fx_fused_parts(..., x_stage="global") and its
int8 twin against fxtpu.ops.pfb_pallas.fx_pallas_parts (interpret mode,
as fxtpu's own tests run it) at 8 channels with autos (36 pairs); the
engine at nchan=8 against fxtpu's engine; the wide route against the
shared route where both take the shape; K blocks in one call against
chained calls; the routing, the caps and the CLI at --nchan 8.

Tolerances, as tests/test_torch_dc_posthoc.py: xp and T 2e-5*scale (3e-5
for 8-bit samples and at deep taps; fxtpu's bounds, tests/test_planes.py:
318,485,558) with the DC bin held on its own scale, GJ by what it moves in
the corrected cross power, mu and the tail 1e-6; autos' imaginary parts
exactly 0, as fxtpu's kernel skips them (pfb_pallas.py:1093-1103); the
wide route against the shared route 2e-6*scale (the same spectra, the
frames summed in another order only where a CTA holds several); K blocks
in one call 1e-5*scale (tests/test_planes.py:576); the engine 2e-5*scale.
"""

import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine, _resolve_fused  # noqa: E402
from fxtpu_torch.ops import fx_fused  # noqa: E402
from fxtpu_torch.ops.dc_posthoc import (block_mu_prev,  # noqa: E402
                                        dc_constants, dc_correct)
from fxtpu_torch.ops.fx_fused import (MAX_FUSED_NCHAN,  # noqa: E402
                                      MAX_WIDE_NCHAN,
                                      fx_fused_parts, fx_fused_parts_i8,
                                      max_blocks_parts, pairs_tensor,
                                      supported, supported_parts,
                                      svd_tensors, x_route)
from fxtpu_torch.ops.fx_xstage import (fx_xstage,  # noqa: E402
                                       fx_xstage_reference, xstage_plan)
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs  # noqa: E402

NBINS, NSAMP = 256, 2**13
S = NSAMP // NBINS
STEP = 1.0 / 32
NCH8 = 8


def _window(ntaps, nbins=NBINS):
    return pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)


def _blocks(nch, k, seed, s=S, nbins=NBINS, offset=0.04 - 0.03j):
    """K framed blocks ``[nch, k, s, nbins]`` with a small DC offset that
    differs per channel and block."""
    rng = np.random.default_rng(seed)
    grade = (np.arange(1, nch + 1)[:, None]
             + 0.5 * np.arange(k)[None, :])[..., None, None]
    return (rng.normal(size=(nch, k, s, nbins))
            + 1j * rng.normal(size=(nch, k, s, nbins))
            + offset * grade).astype(np.complex64)


def _blocks_i8(nch, k, seed, s=S, nbins=NBINS):
    rng = np.random.default_rng(seed)
    dc = (np.array([3.0, -2.0]) * (1 + np.arange(nch) % 3)[:, None])[
        :, None, None, None, :] * (1 + 0.5 * np.arange(k))[
        None, :, None, None, None]
    return np.clip(np.rint(30 * rng.normal(size=(nch, k, s, nbins, 2)) + dc),
                   -127, 127).astype(np.int8)


def _off_dc(got, want, tol, what):
    """Bins 1.. on their own scale, the DC bin on its own."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(
        got[..., 1:], want[..., 1:], rtol=0,
        atol=tol * np.abs(want[..., 1:]).max(), err_msg=f"{what}, off DC")
    np.testing.assert_allclose(
        got[..., 0], want[..., 0], rtol=0,
        atol=tol * np.abs(want[..., 0]).max(), err_msg=f"{what}, DC bin")


def _gj(got, want, mu, xp, tol, what):
    """GJ held by what it moves in the corrected cross power, ``|mu|
    |dGJ|`` against the off-DC scale of xp, and on its own scale at a
    hundred times the tolerance (test_torch_dc_posthoc's rule)."""
    got, want, xp = np.asarray(got), np.asarray(want), np.asarray(xp)
    err = np.abs(got - want).max()
    assert err * np.abs(np.asarray(mu)).max() <= tol * np.abs(
        xp[..., 1:]).max(), what
    assert err <= 100 * tol * np.abs(want).max(), what


def _autos_exact(xp, pairs, what):
    """The autos' imaginary parts are exactly 0."""
    autos = pairs[:, 0] == pairs[:, 1]
    assert autos.any()
    np.testing.assert_array_equal(np.asarray(xp)[:, autos].imag, 0.0,
                                  err_msg=what)


# --- the wide route's plain version against fxtpu's kernel ----------------

@pytest.mark.parametrize("ntaps,s", [(4, S), (32, 64)])
def test_wide_parts_match_fx_pallas_parts_8ch(ntaps, s):
    """Two chained one-block calls of 8 channels with autos (36 pairs) in
    complex64, from a zero history and then from the carried corrected
    tail; at 32 taps on 64-frame blocks fxtpu's kernel runs its SVD-FIR
    mode, the port's plain version the direct loop."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, from_complex, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_parts
    w2d, pairs = _window(ntaps), baseline_pairs(NCH8, True)
    assert len(pairs) == 36
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, NCH8, "cpu")
    x = _blocks(NCH8, 2, seed=ntaps + 8, s=s)
    z = jnp.zeros((NCH8, ntaps - 1, NBINS), jnp.float32)
    hj, ht = Cplx(z, z), torch.zeros((NCH8, ntaps - 1, NBINS),
                                     dtype=torch.complex64)
    tol = 2e-5 if ntaps < 16 else 3e-5
    for k in range(2):
        blk = x[:, k]
        jx, jt, jg, jmu, hj, _ = fx_pallas_parts(
            from_complex(blk[None]), jnp.asarray(w2d), NBINS, hj, pairs)
        tx, tt, tg, tmu, ht = fx_fused_parts(
            torch.from_numpy(blk[:, None].copy()), ht, wt, pt,
            x_stage="global")
        for name, got, want in (("xp", tx, jx), ("T", tt, jt)):
            _off_dc(got.numpy(), to_complex(want), tol, f"{name} block {k}")
        _gj(tg.numpy(), to_complex(jg), tmu, tx, tol, f"GJ block {k}")
        _autos_exact(tx, pairs, f"port block {k}")
        _autos_exact(to_complex(jx), pairs, f"fxtpu block {k}")
        np.testing.assert_allclose(tmu.numpy(), to_complex(jmu), atol=1e-6)
        np.testing.assert_allclose(ht.numpy(), to_complex(hj), atol=1e-6)


def test_wide_i8_parts_match_fx_pallas_parts_8ch():
    """8-bit samples of 8 channels with autos at 32 taps (fxtpu's
    int8-native SVD-FIR mode), K = 2 blocks in one call, twice; then the
    raw tail fxtpu carries (its packed int32 words) imported into an
    8-channel int8 engine (``import_fxtpu_state``) is the port's own."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_parts
    from fxtpu.runtime.native import pack_planes_i8
    ntaps, s, k = 32, 64, 2
    w2d, pairs = _window(ntaps), baseline_pairs(NCH8, True)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, NCH8, "cpu")
    svd = svd_tensors(w2d, "cpu")
    z = jnp.zeros((NCH8, ntaps - 1, NBINS // 4), jnp.int32)
    hj = Cplx(z, z)
    ht = torch.zeros((NCH8, ntaps - 1, NBINS, 2), dtype=torch.int8)
    for call in range(2):
        x = _blocks_i8(NCH8, k, seed=call, s=s)
        planes = [pack_planes_i8(x[:, j].reshape(NCH8, -1, 2), NBINS)
                  for j in range(k)]
        xj = Cplx(jnp.stack([jnp.asarray(p[0]) for p in planes]),
                  jnp.stack([jnp.asarray(p[1]) for p in planes]))
        jx, jt, jg, jmu, _, _ = fx_pallas_parts(
            xj, jnp.asarray(w2d), NBINS, hj, pairs, quant_step=STEP)
        tx, tt, tg, tmu, ttail = fx_fused_parts_i8(
            torch.from_numpy(x), ht, wt, pt, STEP, svd, x_stage="global")
        for name, got, want in (("xp", tx, jx), ("T", tt, jt)):
            _off_dc(got.numpy(), to_complex(want), 3e-5,
                    f"{name} call {call}")
        _gj(tg.numpy(), to_complex(jg), tmu, tx, 3e-5, f"GJ call {call}")
        _autos_exact(tx, pairs, f"port call {call}")
        np.testing.assert_allclose(tmu.numpy(), to_complex(jmu) * STEP,
                                   atol=1e-6)
        assert torch.equal(ttail, torch.from_numpy(x[:, -1, s - ntaps + 1:]))
        hj = Cplx(xj.re[-1, :, -(ntaps - 1):], xj.im[-1, :, -(ntaps - 1):])
        ht = ttail
    # fxtpu's carried state, in its form, into the port's 8-channel engine
    cfg = CorrelatorConfig(nchan=NCH8, include_autos=True, num_samp=s * NBINS,
                           nbins=NBINS, ntaps=ntaps, clamp_num_samp=False,
                           ingest_dtype="int8", quant_step=STEP,
                           device="cpu")
    eng = FxEngine(cfg, fused=True)
    assert eng.int8_native
    mu = to_complex(jmu)[-1] * STEP
    state = {"tail": (np.asarray(hj.re), np.asarray(hj.im)),
             "mu_prev": (mu.real, mu.imag)}
    hist, _ = eng.import_fxtpu_state(w2d, pairs, state, np.zeros(NCH8))
    assert torch.equal(hist["tail"], ttail)
    np.testing.assert_allclose(hist["mu_prev"].numpy(), tmu[-1].numpy(),
                               atol=1e-6)


# --- the wide route against the shared route -----------------------------

@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("nch,ntaps,fir", [(3, 4, "direct"), (4, 4, "direct"),
                                           (3, 32, "svd")])
def test_wide_route_matches_shared_route(nch, ntaps, fir, ingest):
    """Both routes' plain versions at a shape both take, the X stage
    forced: the same spectra, the X stage composed apart."""
    s, k = (64, 2) if ntaps == 32 else (S, 3)
    w2d, pairs = _window(ntaps), baseline_pairs(nch, True)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    svd = svd_tensors(w2d, "cpu") if fir == "svd" else None
    rank = 0 if svd is None else svd[0].shape[1]
    assert x_route(NBINS, ntaps, nch, rank) == "shared"
    consts = dc_constants(w2d, NBINS, s)
    if ingest == "int8":
        x = torch.from_numpy(_blocks_i8(nch, k, seed=nch, s=s))
        hist = torch.from_numpy(_blocks_i8(nch, 1, seed=50, s=ntaps - 1)[:, 0])
        run = [fx_fused_parts_i8, x, hist, wt, pt, STEP, svd, consts]
    else:
        x = torch.from_numpy(_blocks(nch, k, seed=nch, s=s))
        hist = torch.from_numpy(_blocks(nch, 1, seed=50, s=ntaps - 1)[:, 0])
        run = [fx_fused_parts, x, hist, wt, pt, svd, consts]
    wide = run[0](*run[1:], x_stage="global")
    shared = run[0](*run[1:], x_stage="shared")
    for name, g, w in zip(("xp", "T"), wide, shared):
        _off_dc(g.numpy(), w.numpy(), 2e-6, name)
    _gj(wide[2].numpy(), shared[2].numpy(), wide[3], wide[0], 2e-6, "GJ")
    assert torch.equal(wide[3], shared[3])
    assert torch.equal(wide[4], shared[4])
    _autos_exact(wide[0], pairs, "wide")


def test_wide_route_is_the_default_where_shared_memory_is_short():
    """At 4096 bins 8 channels do not fit in one CTA's shared memory:
    'auto' takes the wide route on the CPU too (the route the card takes),
    and the result is the forced wide route's."""
    nch, nbins, s = NCH8, 4096, 4
    w2d, pairs = _window(4, nbins), baseline_pairs(nch, True)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    assert x_route(nbins, 4, nch) == "global"
    x = torch.from_numpy(_blocks(nch, 2, seed=3, s=s, nbins=nbins))
    hist = torch.zeros((nch, 3, nbins), dtype=torch.complex64)
    consts = dc_constants(w2d, nbins, s)
    auto = fx_fused_parts(x, hist, wt, pt, None, consts)
    forced = fx_fused_parts(x, hist, wt, pt, None, consts, x_stage="global")
    assert all(torch.equal(a, b) for a, b in zip(auto, forced))
    _autos_exact(auto[0], pairs, "auto")
    with pytest.raises(ValueError, match="x_stage='shared'"):
        fx_fused_parts(x, hist, wt, pt, None, consts, x_stage="shared")
    with pytest.raises(ValueError, match="x_stage must be"):
        fx_fused_parts(x, hist, wt, pt, None, consts, x_stage="smem")


def test_xstage_reference_contract():
    """The X stage's plain version against a literal loop over frames:
    cross power per pair, T and GJ per channel, autos real."""
    rng = np.random.default_rng(4)
    k, nch, s, nbins, halo = 2, 5, 6, 64, 3
    spec = (rng.normal(size=(k, nch, s, nbins))
            + 1j * rng.normal(size=(k, nch, s, nbins))).astype(np.complex64)
    da = (rng.normal(size=(halo, nbins))
          + 1j * rng.normal(size=(halo, nbins))).astype(np.complex64)
    pairs = baseline_pairs(nch, True)
    got = fx_xstage(torch.from_numpy(spec), torch.from_numpy(pairs),
                    torch.from_numpy(da)).numpy()
    assert got.shape == (k, len(pairs) + 2 * nch, nbins)
    s64 = spec.astype(np.complex128)
    want = np.concatenate([
        np.stack([sum(s64[:, p, f] * np.conj(s64[:, q, f]) for f in range(s))
                  for p, q in pairs], axis=1),
        s64.sum(axis=2),
        sum(s64[:, :, f] * np.conj(da[f]) for f in range(halo))], axis=1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    _autos_exact(got[:, :len(pairs)], pairs, "fx_xstage")


# --- K blocks in one call ---------------------------------------------------

@pytest.mark.parametrize("ingest,ntaps,fir", [
    ("complex64", 4, "direct"), ("complex64", 32, "svd"),
    ("int8", 4, "direct"), ("int8", 32, "svd")])
def test_wide_three_blocks_in_one_call_match_three_chained_calls(
        ingest, ntaps, fir):
    """K = 3 in one wide call (blocks 1 and 2 corrected for the raw rows
    of the block before) against three chained one-block wide calls,
    within fxtpu's bound for its multi kernel, 1e-5*scale."""
    nch, s, k = 4, 64, 3
    w2d, pairs = _window(ntaps), baseline_pairs(nch, True)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    svd = svd_tensors(w2d, "cpu") if fir == "svd" else None
    consts = dc_constants(w2d, NBINS, s)

    def corrected(x, hist, mu_first):
        if ingest == "int8":
            xp, t, gj, mu, tail = fx_fused_parts_i8(
                x, hist, wt, pt, STEP, svd, consts, x_stage="global")
        else:
            xp, t, gj, mu, tail = fx_fused_parts(x, hist, wt, pt, svd, consts,
                                                 x_stage="global")
        return (dc_correct(xp, t, gj, mu, pt, consts,
                           mu_prev=block_mu_prev(mu, mu_first)), tail, mu)

    if ingest == "int8":
        x = torch.from_numpy(_blocks_i8(nch, k, seed=21, s=s))
        hist = torch.zeros((nch, ntaps - 1, NBINS, 2), dtype=torch.int8)
        first = torch.zeros((nch,), dtype=torch.complex64)
    else:
        x = torch.from_numpy(_blocks(nch, k, seed=21, s=s))
        hist = torch.zeros((nch, ntaps - 1, NBINS), dtype=torch.complex64)
        first = None
    multi, tail_m, mu_m = corrected(x, hist, first)
    singles = []
    for j in range(k):
        one, hist, mu = corrected(x[:, j:j + 1], hist, first)
        first = mu[-1] if ingest == "int8" else None
        singles.append(one[0])
    singles = torch.stack(singles)
    assert multi.shape == singles.shape == (k, len(pairs), NBINS)
    assert (multi - singles).abs().max() <= 1e-5 * singles.abs().max()
    if ingest == "int8":
        assert torch.equal(tail_m, hist)
    else:
        np.testing.assert_allclose(tail_m.numpy(), hist.numpy(), atol=1e-6)
    np.testing.assert_allclose(mu_m[-1].numpy(), mu[-1].numpy(), atol=1e-6)


# --- the engine and the CLI at 8 channels -----------------------------------

@pytest.mark.parametrize("entry", ["unit_phasor", "finish", "fstc_rotate"])
def test_cpu_rotation_takes_its_trig_on_the_calling_thread(monkeypatch,
                                                          entry):
    """The delay rotation on the CPU at the 8-channel engine's shape (36
    baselines with autos, 4096 bins): its cosine and sine come from numpy
    in float64, rounded once, and never from torch's threaded CPU
    ``cos``/``sin``, whose first call in a process under load returned a
    chunk of the 8-channel engine test's rotation 1.5e-4 off (that test's
    unsteady failures)."""
    from fxtpu_torch.ops import xengine
    from fxtpu_torch.ops.fx_epilogue import FinishTables, finish

    def refused(*a, **k):
        raise AssertionError("torch trig on the CPU")

    nbins, bw, fc = 4096, 2.4e6, 1.42e9
    pairs = baseline_pairs(NCH8, include_autos=True)
    d = xengine.pack_delays(1e-7 * np.arange(NCH8), fc)
    tables = FinishTables(pairs, nbins, bw, fc, "cpu")
    dd = torch.from_numpy(d[pairs[:, 0], 0] - d[pairs[:, 1], 0])
    frac = torch.from_numpy(d[pairs[:, 0], 1] - d[pairs[:, 1], 1])
    phase = xengine.rotation_phase(tables.fbase, dd, frac)
    want = np.exp(1j * phase.numpy().astype(np.float64))
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=(len(pairs), nbins))
                          + 1j * rng.normal(size=(len(pairs), nbins))
                          ).astype(np.complex64))
    monkeypatch.setattr(torch, "cos", refused)
    monkeypatch.setattr(torch, "sin", refused)
    if entry == "unit_phasor":
        got, ref = xengine.unit_phasor(phase), want
    elif entry == "finish":
        got = finish(x, torch.from_numpy(d), tables, 1, bw, False)
        ref = np.fft.fftshift(x.numpy() * want, axes=-1)
    else:
        spec = x[:NCH8, None]                        # [nch, 1, nbins]
        got = xengine.fstc_rotate(spec, d, bw, fc)[:, 0]
        freqs = xengine.rf_freqs(nbins, bw, fc, True, "cpu")
        ph = xengine.rotation_phase(freqs, torch.from_numpy(d[:, 0]),
                                    torch.from_numpy(d[:, 1]))
        ref = spec[:, 0].numpy() * np.exp(1j * ph.numpy().astype(np.float64))
    assert got.dtype == torch.complex64
    # one rounding of the phasor, then float32 products
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2.5e-7 * np.abs(ref).max())


def test_engine_nchan8_matches_fxtpu_engine():
    """fused=True, 8 channels with autos at 4096 bins, where the wide
    route is the engine's own choice, against fxtpu's fused engine over 3
    chained blocks of 8 frames; then fxtpu's carried state imported
    (``import_fxtpu_state``) and one more block from it in both."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.fx import FxEngine as JEngine
    from fxtpu.ops.cplx import to_complex
    from fxtpu.ops.planes import pack_delays
    nbins, nsamp = 4096, 8 * 4096
    kw = dict(num_samp=nsamp, nbins=nbins, clamp_num_samp=False,
              mode="SPECTRUM", nchan=NCH8, include_autos=True)
    jeng = JEngine(JConfig(**kw), fused=True)
    teng = FxEngine(CorrelatorConfig(**kw, device="cpu"), fused=True)
    assert jeng.fused_active and teng.fused_active
    assert not teng.kernel_active and teng.x_stage == "global"
    assert len(teng.pairs) == 36
    rng = np.random.default_rng(31)
    jh, th = jeng.fresh_history(), teng.fresh_history()
    for k in range(4):
        blk = (rng.normal(size=(NCH8, nsamp)) + 1j
               * rng.normal(size=(NCH8, nsamp)) + 0.02 - 0.01j
               ).astype(np.complex64)
        d = pack_delays(1e-7 * np.arange(NCH8) * (1 + k),
                        jeng.cfg.frequency)
        if k == 3:   # continue from fxtpu's state, in fxtpu's form
            th, td = teng.import_fxtpu_state(jeng.window2d, jeng.pairs, jh,
                                             d)
            np.testing.assert_array_equal(th.real.numpy(), np.asarray(jh.re))
            np.testing.assert_array_equal(td.numpy(), d)
        jv, jh = jeng.step(jeng.prepare_block(blk), jnp.asarray(d), jh)
        tv, th = teng.step(teng.prepare_block(blk), torch.from_numpy(d), th)
        want = to_complex(jv)
        assert tv.shape == want.shape == (36, nbins)
        np.testing.assert_allclose(tv.numpy(), want,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=f"block {k}")
        np.testing.assert_allclose(th.numpy(), to_complex(jh), atol=1e-6)


def test_cli_nchan8_on_cpu_writes_fxtpu_products(tmp_path):
    """``--nchan 8`` through the CLI on the CPU: 28 baselines a block in
    the CSV, whose header and frequency row are what fxtpu.products
    writes for the same configuration, and every channel calibrated."""
    pytest.importorskip("jax")
    from fxtpu import products as jproducts
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu_torch.cli import main as cli_main
    out = str(tmp_path / "vis8.csv")
    cor = cli_main(["--time", "1", "--mode", "spectrum", "--num_samp",
                    "8192", "--resolution", "256", "--nchan", "8",
                    "--true_delay", "2e-6", "--no_keyboard", "--omit_plot",
                    "--output", out, "--device", "cpu", "-L", "WARNING"])
    cfg = cor.config
    assert cfg.nchan == 8 and cfg.n_baselines == 28
    md, data = jproducts.load_products(out)
    assert md["nchan"] == "8" and md["mode"] == "SPECTRUM"
    assert data.shape == (cor.blocks_processed * 28, NBINS)
    assert cor.blocks_processed >= 1 and np.isfinite(data).all()
    names = {f.name for f in dataclasses.fields(JConfig)}
    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg) if f.name in names})
    with open(out) as fh:
        header, freqs = fh.readline(), fh.readline()
    assert header == jproducts.metadata_line(jcfg.metadata())
    np.testing.assert_allclose(
        np.array(freqs.split(","), float),
        jproducts.shifted_rf_freqs(NBINS, cfg.bandwidth, cfg.frequency))
    err = np.abs(cor.calibrated_delays[1:] - 2e-6) * cfg.bandwidth
    assert cor.calibrated_delays[0] == 0 and (err < 0.5).all(), err


# --- routing and caps -------------------------------------------------------

@pytest.mark.parametrize("nbins", [256, 512, 1024, 2048, 4096, 8192])
def test_supported_parts_takes_up_to_64_channels(nbins):
    """Every channel count up to the shared route's 64 and on to the
    wide route's 512 (past 64 on the wide route alone); none past 512."""
    for nch in (1, 2, 7, 8, 33, MAX_FUSED_NCHAN, MAX_FUSED_NCHAN + 1,
                MAX_WIDE_NCHAN):
        assert supported_parts(nbins, 4, nch, 64)
        assert supported_parts(nbins, 32, nch, 64, rank=6)
    assert x_route(nbins, 4, MAX_FUSED_NCHAN + 1) == "global"
    assert not supported_parts(nbins, 4, MAX_WIDE_NCHAN + 1, 64)
    assert not supported_parts(nbins, 4, 8, 2)        # S < ntaps-1
    assert not supported_parts(nbins, 1, 8, 64)       # ntaps < 2


@pytest.mark.parametrize("nbins,nch,route", [
    (4096, 6, "shared"), (4096, 7, "global"), (4096, 8, "global"),
    (8192, 2, "shared"), (8192, 3, "global"), (256, 64, "shared"),
    (512, 64, "global")])
def test_x_route_by_shape(nbins, nch, route):
    """'auto' keeps the shared route wherever it fits (the two-pass
    entries' ``supported``, unchanged) and takes the wide route
    elsewhere."""
    assert x_route(nbins, 4, nch) == route
    assert supported(nbins, 4, nch) == (route == "shared")
    assert x_route(nbins, 4, nch, x_stage="global") == "global"
    if route == "global":
        with pytest.raises(ValueError, match="supported"):
            x_route(nbins, 4, nch, x_stage="shared")


def test_two_pass_supported_is_unchanged():
    """The two-pass entries keep their shared-memory bound."""
    assert supported(4096, 4, 6) and not supported(4096, 4, 7)
    assert supported(8192, 32, 2, 6) and not supported(8192, 32, 3, 6)
    assert not fx_fused.supported_i8(4096, 4, 8, 256)


def test_max_blocks_parts_counts_the_spectra_scratch():
    """bench.py's nchan8 block (8 x 2^20 samples, 4096 bins, 36 pairs):
    64 MiB of spectra a block plus its groups' sample sums under the 1
    GiB launch bound: 15 blocks; the shared route's shapes keep their
    bound."""
    s_rows = 2**20 // 4096
    per_block = 8 * s_rows * 4096 * 8 + min(s_rows, fx_fused.MAX_GROUPS) * 8 * 16
    assert per_block > 64 << 20
    most = max_blocks_parts(s_rows, 4096, 8, 36)
    assert most == fx_fused.MAX_LAUNCH_PARTIAL_BYTES // per_block == 15
    assert max_blocks_parts(s_rows, 4096, 8, 36, x_stage="global") == most
    assert max_blocks_parts(512, 4096, 2, 3) == 18      # shared, unchanged
    assert max_blocks_parts(512, 4096, 2, 3, x_stage="global") == (
        fx_fused.MAX_LAUNCH_PARTIAL_BYTES // (2 * 512 * 4096 * 8 + 256 * 32))


def test_engine_caps_k_at_the_scratch_bound(caplog, tmp_path):
    """The Correlator at bench.py's nchan8 shape asks for 64 blocks per
    call and gets 15, with its warning; the engine's route is the wide
    one."""
    from fxtpu_torch.correlator import Correlator
    cfg = CorrelatorConfig(nchan=8, include_autos=True, nbins=4096,
                           num_samp=2**20, clamp_num_samp=False, fused=True,
                           device="cpu", blocks_per_dispatch=64,
                           buffer_chunks=2,
                           output_file=str(tmp_path / "k.csv"))
    with caplog.at_level("WARNING", logger="fxtpu_torch.correlator"):
        cor = Correlator(config=cfg)
    try:
        assert cor.engine.x_stage == "global"
        assert cor.engine.dispatch_batch_for(64) == cor._dispatch_batch == 15
        assert "15 blocks per call" in caplog.text
    finally:
        cor.close()


def test_engine_routes_and_counters_at_8_channels():
    """The engine's route, X stage and counter names at 8 channels: the
    wide route at 4096 bins (both ingests, both FIR modes), the shared one
    where it fits; the counters named per route, the epilogue's pair-tiled
    instance's too (36 pairs)."""
    for ingest in ("complex64", "int8"):
        for nbins, ntaps, num_samp, stage, fir in (
                (4096, 4, 2**20, "global", "direct"),
                (8192, 32, 2**18, "global", "svd"),
                (256, 4, 2**13, "shared", "direct")):
            cfg = CorrelatorConfig(nchan=8, include_autos=True, nbins=nbins,
                                   ntaps=ntaps, num_samp=num_samp,
                                   clamp_num_samp=False, ingest_dtype=ingest,
                                   device="cpu")
            eng = FxEngine(cfg, fused=True)
            assert eng.x_stage == stage and eng.fir_mode == fir
            name = "fx_fused_parts_i8" if ingest == "int8" else "fx_fused_parts"
            attr = "launches" if fir == "direct" else "svd_launches"
            keys = [name, "parts_reduce"] if stage == "shared" else [
                f"{name}.wide_{attr}", "fx_xstage", "fx_xstage.ctas",
                "fx_xstage.spectra_reads", "fx_xstage.tiled"]
            if ntaps >= 16:
                keys.append("fir_rows")     # the deep-tap FIR's launch
            assert list(eng.launch_counts()) == [*keys, "fx_finish",
                                                 "fx_finish.tiled"]
            assert FxEngine(cfg).x_stage is None     # 'auto' on the CPU
    cfg = CorrelatorConfig(nchan=3, nbins=8192, ntaps=32, num_samp=2**18,
                           clamp_num_samp=False, device="cpu")
    assert FxEngine(cfg, fused=True).x_stage == "global"


def test_resolve_fused_routes_8_channels_and_warns_on_a_refused_shape(caplog):
    """'auto' on a CUDA device takes the single pass for every nch up to
    512 at the bin counts the kernels take, and says at WARNING when it
    falls to plain torch (nch > 512, a bin count the FFT does not take);
    on the CPU 'auto' stays plain and says nothing.  The device is a
    torch.device: no card is needed to decide the route."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    with caplog.at_level(logging.WARNING, logger="fxtpu_torch.fx"):
        assert _resolve_fused("auto", cuda, 4096, 4, 8, s_rows=256)
        assert _resolve_fused("auto", cuda, 4096, 4, 8, int8=True,
                              s_rows=256)
        assert _resolve_fused("auto", cuda, 8192, 32, 3, s_rows=32, rank=6)
        assert _resolve_fused("auto", cuda, 4096, 4, 64, s_rows=256)
        assert _resolve_fused("auto", cuda, 4096, 4, 65, s_rows=256)
        assert _resolve_fused("auto", cuda, 4096, 4, 128, int8=True,
                              s_rows=64)
        assert _resolve_fused("auto", cuda, 4096, 4, 512, int8=True,
                              s_rows=64)
        assert _resolve_fused("auto", cuda, 3072, 4, 2, s_rows=85)
        assert not caplog.records
        assert not _resolve_fused("auto", cpu, 4096, 4, 8, s_rows=256)
        assert not _resolve_fused("auto", cpu, 384, 4, 2)
        assert not caplog.records
        assert not _resolve_fused("auto", cuda, 4096, 4, 513, s_rows=256)
        assert not _resolve_fused("auto", cuda, 1000, 4, 2, s_rows=64)
    warned = [r.getMessage() for r in caplog.records]
    assert len(warned) == 2
    assert "nch=513" in warned[0] and "supported_parts" in warned[0]
    assert "nbins=1000" in warned[1] and "multiple of 128" in warned[1]
    with pytest.raises(ValueError, match="nch=513"):
        _resolve_fused(True, cpu, 4096, 4, 513, s_rows=256)


def test_wide_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the wrappers run their plain versions and count no
    launch, on either route."""
    nch, ntaps = 3, 4
    w2d, pairs = _window(ntaps), baseline_pairs(nch, True)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    x = torch.from_numpy(_blocks(nch, 2, seed=1))
    hist = torch.zeros((nch, ntaps - 1, NBINS), dtype=torch.complex64)
    counters = ("launches", "svd_launches", "wide_launches",
                "wide_svd_launches")
    before = [getattr(fx_fused_parts, c) for c in counters]
    got = fx_fused_parts(x, hist, wt, pt, x_stage="global")
    want = fx_fused.fx_fused_parts_wide_reference(x, hist, wt, pt)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [getattr(fx_fused_parts, c) for c in counters] == before
    spec = torch.from_numpy(_blocks(nch, 2, seed=2)).transpose(0, 1)
    da = torch.from_numpy(_blocks(1, 1, seed=3, s=ntaps - 1)[0, 0])
    n = fx_xstage.launches
    assert torch.equal(fx_xstage(spec.contiguous(), pt, da),
                       fx_xstage_reference(spec.contiguous(), pt, da))
    assert fx_xstage.launches == n


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _card_inputs(nch, k, s, nbins, ntaps, int8, fir, device, seed):
    w2d, pairs = _window(ntaps, nbins), baseline_pairs(nch, True)
    wt = torch.from_numpy(w2d).to(device)
    pt = pairs_tensor(pairs, nch, device)
    svd = svd_tensors(w2d, device) if fir == "svd" else None
    consts = dc_constants(w2d, nbins, s, device)
    if int8:
        x = torch.from_numpy(_blocks_i8(nch, k, seed, s, nbins)).to(device)
        hist = torch.from_numpy(
            _blocks_i8(nch, 1, seed + 1, ntaps - 1, nbins)[:, 0]).to(device)
    else:
        x = torch.from_numpy(_blocks(nch, k, seed, s, nbins)).to(device)
        hist = torch.from_numpy(
            _blocks(nch, 1, seed + 1, ntaps - 1, nbins)[:, 0]).to(device)
    return x, hist, wt, pt, svd, consts


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nch,k,s,nbins,ntaps,fir", [
    (4, 1, 32, 256, 4, "direct"), (4, 3, 32, 256, 4, "direct"),
    (8, 2, 16, 4096, 4, "direct"), (4, 2, 64, 256, 32, "svd"),
    (64, 1, 8, 256, 4, "direct"), (55, 1, 8, 512, 4, "direct"),
    (48, 2, 8, 256, 4, "direct"), (2, 1, 16, 16384, 4, "direct"),
    (3, 2, 16, 16256, 4, "direct"), (2, 1, 40, 6144, 32, "svd")])
def test_cuda_wide_parts_match_plain_and_shared(cuda_device, nch, k, s, nbins,
                                                ntaps, fir, int8):
    """The wide route's kernels against their plain version (2e-5 of
    scale, 3e-5 for 8-bit samples and deep taps; mu and the complex64
    tail 1e-6, the int8 tail exact, autos' imaginary parts 0) and, where
    the shared route takes the shape, against its kernels (2e-6 of
    scale); each call counts one wide launch and one X kernel launch."""
    x, hist, wt, pt, svd, consts = _card_inputs(
        nch, k, s, nbins, ntaps, int8, fir, cuda_device, seed=nch + k)
    fn = fx_fused_parts_i8 if int8 else fx_fused_parts
    args = (x, hist, wt, pt, STEP, svd, consts) if int8 else (
        x, hist, wt, pt, svd, consts)
    ref = (fx_fused.fx_fused_parts_i8_wide_reference if int8
           else fx_fused.fx_fused_parts_wide_reference)
    attr = "wide_" + ("svd_launches" if svd is not None else "launches")
    before, xs_before = getattr(fn, attr), fx_xstage.launches
    got = fn(*args, x_stage="global")
    want = ref(*args)
    torch.cuda.synchronize()
    assert getattr(fn, attr) == before + 1
    assert fx_xstage.launches == xs_before + 1
    tol = 3e-5 if (int8 or ntaps >= 16) else 2e-5
    for name, g, w in zip(("xp", "T"), got, want):
        _off_dc(g.cpu().numpy(), w.cpu().numpy(), tol, name)
    _gj(got[2].cpu().numpy(), want[2].cpu().numpy(), got[3].cpu(),
        got[0].cpu().numpy(), tol, "GJ")
    _autos_exact(got[0].cpu(), pt.cpu().numpy(), "kernel")
    assert (got[3] - want[3]).abs().max() <= 1e-6 * max(
        1.0, want[3].abs().max().item())
    if int8:
        assert torch.equal(got[4], want[4])
    else:
        assert (got[4] - want[4]).abs().max() <= 1e-6
    rank = 0 if svd is None else svd[0].shape[1]
    if x_route(nbins, ntaps, nch, rank) == "shared":
        shared = fn(*args, x_stage="shared")
        torch.cuda.synchronize()
        for name, g, w in zip(("xp", "T"), got, shared):
            _off_dc(g.cpu().numpy(), w.cpu().numpy(), 2e-6, name)
        assert torch.equal(got[3], shared[3])


@pytest.mark.cuda
def test_cuda_xstage_kernel_matches_plain_version(cuda_device):
    rng = np.random.default_rng(5)
    k, nch, s, nbins, halo = 2, 8, 20, 512, 3
    spec = torch.from_numpy(
        (rng.normal(size=(k, nch, s, nbins))
         + 1j * rng.normal(size=(k, nch, s, nbins))).astype(np.complex64)
    ).to(cuda_device)
    da = torch.from_numpy((rng.normal(size=(halo, nbins)) + 1j * rng.normal(
        size=(halo, nbins))).astype(np.complex64)).to(cuda_device)
    pt = pairs_tensor(baseline_pairs(nch, True), nch, cuda_device)
    n = fx_xstage.launches
    got = fx_xstage(spec, pt, da)
    want = fx_xstage_reference(spec, pt, da)
    torch.cuda.synchronize()
    assert fx_xstage.launches == n + 1
    assert (got - want).abs().max() <= 2e-5 * want.abs().max()
    _autos_exact(got[:, :pt.shape[0]].cpu(), pt.cpu().numpy(), "fx_xstage")
    with pytest.raises(ValueError, match="multiple of 32"):
        fx_xstage(spec[..., :48].contiguous(), pt, da[:, :48].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_cuda_engine_nchan8_step_is_three_launches(cuda_device, ingest):
    """The engine at 8 channels and 4096 bins takes the wide route on the
    card: each step adds one wide launch (the frame kernel), one launch
    of the X kernel and one of the epilogue, on its pair-tiled instance
    (36 pairs), and agrees
    with the plain route within 2e-5 of scale (3e-5 for 8-bit samples)."""
    cfg = CorrelatorConfig(nchan=8, include_autos=True, num_samp=2**15,
                           nbins=4096, clamp_num_samp=False,
                           ingest_dtype=ingest, quant_step=STEP,
                           device="cuda")
    one, plain = FxEngine(cfg), FxEngine(cfg, fused=False)
    assert one.kernel_active and one.x_stage == "global"
    rng = np.random.default_rng(8)
    d = torch.zeros(8, device=cuda_device)
    h1, h2 = one.fresh_history(), plain.fresh_history()
    tol = 3e-5 if ingest == "int8" else 2e-5
    for k in range(2):
        blk = (rng.normal(size=(8, 2**15, 2)) @ np.array([1.0, 1j])
               + 0.02).astype(np.complex64)
        before = one.launch_counts()
        v1, h1 = one.step(one.prepare_block(blk), d, h1)
        after = one.launch_counts()
        moved = {n: after[n] - before[n] for n in after}
        assert [v for n, v in moved.items()
                if not n.startswith("fx_xstage.")] == [1, 1, 1, 1]
        assert moved["fx_xstage.tiled"] == 0     # a row instance
        assert moved["fx_xstage.ctas"] == xstage_plan(
            8, 36, 8, 4096).ctas(4096, 1)
        v2, h2 = plain.step(plain.prepare_block(blk), d, h2)
        assert (v1 - v2).abs().max() <= tol * v2.abs().max(), f"block {k}"
