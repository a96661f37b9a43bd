"""The post-hoc DC "parts" API of the port against the JAX package's:
fxtpu_torch.ops.dc_posthoc (dc_constants, dc_correct) against
fxtpu.ops.pfb_pallas._dc_constants / _dc_correct, and the single pass's
plain versions (fx_fused_parts_reference, fx_fused_parts_i8_reference)
against fx_pallas_parts, run as fxtpu's own tests run it on the CPU
(interpret mode).

Tolerances: constants and the correction's algebra 1e-6 of each array's
max; the parts 2e-5*scale (3e-5 for 8-bit samples and at deep taps,
fxtpu's bounds, tests/test_planes.py:318,485,558), mu and the tail 1e-6;
K blocks in one call against K chained calls 1e-5*scale
(tests/test_planes.py:576).  The raw cross power's DC bin holds |mu|^2
|Abar(0)|^2 S, far above every other bin, and the correction cancels it:
off-DC bins are held on the off-DC scale, the DC bin on its own, and the
corrected DC bin to what fxtpu's own kernel gives on the same input."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.ops import fx_fused  # noqa: E402
from fxtpu_torch.ops.dc_posthoc import (block_mu_prev,  # noqa: E402
                                        dc_constants, dc_correct)
from fxtpu_torch.ops.fx_fused import (fx_fused_parts,  # noqa: E402
                                      fx_fused_parts_i8,
                                      fx_fused_parts_i8_reference,
                                      fx_fused_parts_reference,
                                      fx_fused_raw_i8_reference,
                                      fx_fused_raw_reference, pairs_tensor,
                                      supported_parts, svd_tensors)
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs  # noqa: E402

NBINS, NSAMP = 256, 2**13
S = NSAMP // NBINS
STEP = 1.0 / 32


def _window(ntaps):
    return pfb_window(ntaps, NBINS).reshape(ntaps, NBINS).astype(np.float32)


def _blocks(nch, k, seed, s=S, offset=0.04 - 0.03j):
    """K framed blocks ``[nch, k, s, nbins]`` with a small DC offset that
    differs per channel and block."""
    rng = np.random.default_rng(seed)
    grade = (np.arange(1, nch + 1)[:, None]
             + 0.5 * np.arange(k)[None, :])[..., None, None]
    return (rng.normal(size=(nch, k, s, NBINS))
            + 1j * rng.normal(size=(nch, k, s, NBINS))
            + offset * grade).astype(np.complex64)


def _blocks_i8(nch, k, seed, s=S):
    rng = np.random.default_rng(seed)
    dc = (np.array([3.0, -2.0]) * np.arange(1, nch + 1)[:, None])[
        :, None, None, None, :] * (1 + 0.5 * np.arange(k))[
        None, :, None, None, None]
    return np.clip(np.rint(30 * rng.normal(size=(nch, k, s, NBINS, 2)) + dc),
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
    """GJ is a sum of spectra times dA, far above its own value at the DC
    bin, where the first frames nearly cancel: it is held by what it moves
    in the corrected cross power, ``|mu| |dGJ|`` against the off-DC scale
    of xp, and on its own scale at a hundred times the tolerance."""
    got, want, xp = np.asarray(got), np.asarray(want), np.asarray(xp)
    err = np.abs(got - want).max()
    assert err * np.abs(np.asarray(mu)).max() <= tol * np.abs(
        xp[..., 1:]).max(), what
    assert err <= 100 * tol * np.abs(want).max(), what


@pytest.mark.parametrize("ntaps,s_rows", [(4, 32), (32, 64), (2, 1)])
def test_dc_constants_match_fxtpu(ntaps, s_rows):
    pytest.importorskip("jax")
    from fxtpu.ops.cplx import to_complex
    from fxtpu.ops.pfb_pallas import _dc_constants
    w2d = _window(ntaps)
    want = _dc_constants(tuple(w2d.astype(np.float64).ravel()), NBINS, s_rows)
    got = dc_constants(w2d, NBINS, s_rows)
    assert [tuple(g.shape) for g in got] == [
        (NBINS,), (ntaps - 1, NBINS), (NBINS,), (NBINS,), (NBINS,)]
    assert [g.dtype for g in got] == [torch.complex64, torch.complex64,
                                      torch.float32, torch.complex64,
                                      torch.float32]
    for name, g, w in zip(("abar", "dA", "cs", "cab", "cbb"), got, want):
        w = np.asarray(w) if isinstance(w, np.ndarray) else to_complex(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)
    # cached per window: the same host arrays serve a second call
    again = dc_constants(w2d.astype(np.float64), NBINS, s_rows)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_dc_constants_reject_short_blocks():
    with pytest.raises(ValueError, match="S >= ntaps-1"):
        dc_constants(_window(4), NBINS, 2)
    with pytest.raises(ValueError, match="whole tap rows"):
        dc_constants(np.ones(NBINS + 1), NBINS, 8)


@pytest.mark.parametrize("raw_tail", [False, True])
@pytest.mark.parametrize("ntaps", [4, 32])
def test_dc_correct_matches_fxtpu(ntaps, raw_tail):
    """Random parts through both packages' algebra, in both history
    contracts."""
    pytest.importorskip("jax")
    from fxtpu.ops.cplx import from_complex, to_complex
    from fxtpu.ops.pfb_pallas import _dc_constants, _dc_correct
    nch, k = 3, 2
    pairs = baseline_pairs(nch, True)
    w2d = _window(ntaps)
    rng = np.random.default_rng(ntaps)

    def cplx(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
                ).astype(np.complex64)

    xp, t, gj = cplx(k, len(pairs), NBINS), cplx(k, nch, NBINS), cplx(
        k, nch, NBINS)
    mu, mu_prev = 0.1 * cplx(k, nch), 0.1 * cplx(k, nch)
    jc = _dc_constants(tuple(w2d.astype(np.float64).ravel()), NBINS, 64)
    want = to_complex(_dc_correct(
        from_complex(xp), from_complex(t), from_complex(gj),
        from_complex(mu), pairs, jc, 64,
        mu_prev=from_complex(mu_prev) if raw_tail else None))
    got = dc_correct(*map(torch.from_numpy, (xp, t, gj, mu)),
                     torch.from_numpy(pairs), dc_constants(w2d, NBINS, 64),
                     mu_prev=torch.from_numpy(mu_prev) if raw_tail else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_block_mu_prev():
    mu = torch.arange(6, dtype=torch.float32).reshape(3, 2).to(
        torch.complex64)
    assert torch.equal(block_mu_prev(mu), torch.cat(
        [torch.zeros(1, 2, dtype=torch.complex64), mu[:2]]))
    first = torch.tensor([5 + 1j, 7 - 2j], dtype=torch.complex64)
    assert torch.equal(block_mu_prev(mu, first)[0], first)
    assert torch.equal(block_mu_prev(mu, first)[1:], mu[:2])


@pytest.mark.parametrize("nch,autos,ntaps", [(2, False, 4), (3, True, 4),
                                             (2, False, 32)])
def test_parts_reference_matches_fx_pallas_parts(nch, autos, ntaps):
    """Two chained one-block calls in complex64, from a zero history and
    then from the carried corrected tail.  At 32 taps fxtpu's kernel runs
    its SVD-FIR mode, the port's plain version the direct loop."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, from_complex, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_parts
    s = 64 if ntaps == 32 else S
    w2d, pairs = _window(ntaps), baseline_pairs(nch, autos)
    x = _blocks(nch, 2, seed=ntaps + nch, s=s)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    z = jnp.zeros((nch, ntaps - 1, NBINS), jnp.float32)
    hj, ht = Cplx(z, z), torch.zeros((nch, ntaps - 1, NBINS),
                                     dtype=torch.complex64)
    tol = 2e-5 if ntaps < 16 else 3e-5
    for k in range(2):
        blk = x[:, k]
        jx, jt, jg, jmu, hj, s_rows = fx_pallas_parts(
            from_complex(blk[None]), jnp.asarray(w2d), NBINS, hj, pairs)
        assert s_rows == s
        tx, tt, tg, tmu, ht = fx_fused_parts_reference(
            torch.from_numpy(blk[:, None].copy()), ht, wt, pt)
        for name, got, want in (("xp", tx, jx), ("T", tt, jt)):
            _off_dc(got.numpy(), to_complex(want), tol, f"{name} block {k}")
        _gj(tg.numpy(), to_complex(jg), tmu, tx, tol, f"GJ block {k}")
        np.testing.assert_allclose(tmu.numpy(), to_complex(jmu), atol=1e-6)
        np.testing.assert_allclose(ht.numpy(), to_complex(hj), atol=1e-6)


def test_parts_i8_reference_matches_fx_pallas_parts():
    """8-bit samples at 32 taps (fxtpu's int8-native mode needs the
    SVD-FIR window), K = 2 blocks in one call, twice: both packages read
    block k-1's rows raw.  fxtpu's mu leaves in quant units."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_parts
    from fxtpu.runtime.native import pack_planes_i8
    nch, ntaps, s, k = 2, 32, 64, 2
    w2d, pairs = _window(ntaps), baseline_pairs(nch)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    svd = svd_tensors(w2d, "cpu")
    assert svd is not None
    z = jnp.zeros((nch, ntaps - 1, NBINS // 4), jnp.int32)
    hj = Cplx(z, z)
    ht = torch.zeros((nch, ntaps - 1, NBINS, 2), dtype=torch.int8)
    for call in range(2):
        x = _blocks_i8(nch, k, seed=call, s=s)
        planes = [pack_planes_i8(x[:, j].reshape(nch, -1, 2), NBINS)
                  for j in range(k)]
        xj = Cplx(jnp.stack([jnp.asarray(p[0]) for p in planes]),
                  jnp.stack([jnp.asarray(p[1]) for p in planes]))
        jx, jt, jg, jmu, jtail, _ = fx_pallas_parts(
            xj, jnp.asarray(w2d), NBINS, hj, pairs, quant_step=STEP)
        assert jtail is None
        tx, tt, tg, tmu, ttail = fx_fused_parts_i8_reference(
            torch.from_numpy(x), ht, wt, pt, STEP, svd)
        for name, got, want in (("xp", tx, jx), ("T", tt, jt)):
            _off_dc(got.numpy(), to_complex(want), 3e-5,
                    f"{name} call {call}")
        _gj(tg.numpy(), to_complex(jg), tmu, tx, 3e-5, f"GJ call {call}")
        np.testing.assert_allclose(tmu.numpy(), to_complex(jmu) * STEP,
                                   atol=1e-6)
        assert torch.equal(ttail, torch.from_numpy(x[:, -1, s - ntaps + 1:]))
        hj = Cplx(xj.re[-1, :, -(ntaps - 1):], xj.im[-1, :, -(ntaps - 1):])
        ht = ttail


def _corrected(x, hist, wt, pt, svd=None, mu_first=None, step=None):
    """dc_correct of the port's parts of the merged x -> (xp, tail), with
    the constants of the window the FIR applies (the engine's)."""
    consts = dc_constants(wt.numpy(), NBINS, x.shape[2], svd=svd)
    if step is None:
        xp, t, gj, mu, tail = fx_fused_parts(x, hist, wt, pt, svd, consts)
    else:
        xp, t, gj, mu, tail = fx_fused_parts_i8(x, hist, wt, pt, step, svd,
                                                consts)
    return dc_correct(xp, t, gj, mu, pt, consts,
                      mu_prev=block_mu_prev(mu, mu_first)), tail, mu


@pytest.mark.parametrize("ntaps,fir", [(4, "direct"), (32, "direct"),
                                       (32, "svd")])
def test_corrected_parts_match_the_two_pass_reference(ntaps, fir):
    """dc_correct of the single pass's parts against the two-pass plain
    version (the mean subtracted before the FIR) over two chained blocks,
    off the DC bin within fxtpu's bounds; the DC bin is printed beside
    fxtpu's own kernel's and held to it."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, from_complex, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_raw
    nch, s = 2, 64 if ntaps == 32 else S
    w2d, pairs = _window(ntaps), baseline_pairs(nch, True)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    svd = svd_tensors(w2d, "cpu") if fir == "svd" else None
    x = _blocks(nch, 2, seed=7, s=s)
    tol = 2e-5 if ntaps < 16 else 3e-5
    z = jnp.zeros((nch, ntaps - 1, NBINS), jnp.float32)
    hj = Cplx(z, z)
    hp = hr = torch.zeros((nch, ntaps - 1, NBINS), dtype=torch.complex64)
    for k in range(2):
        blk = torch.from_numpy(x[:, k].copy())
        got, hp, _ = _corrected(blk[:, None], hp, wt, pt, svd)
        want, hr = fx_fused_raw_reference(blk, hr, wt, pt, svd)
        jx, hj = fx_pallas_raw(from_complex(x[:, k]), jnp.asarray(w2d), NBINS,
                               hj, pairs)
        scale = want.abs().max().item()
        err = (got[0] - want).abs().numpy()
        jerr = np.abs(to_complex(jx) - want.numpy())
        print(f"block {k}: off DC {err[:, 1:].max() / scale:.3g} "
              f"(fxtpu {jerr[:, 1:].max() / scale:.3g}), DC bin "
              f"{err[:, 0].max() / scale:.3g} (fxtpu "
              f"{jerr[:, 0].max() / scale:.3g}) of max|xp|")
        assert err[:, 1:].max() <= tol * scale
        assert err[:, 0].max() <= max(3 * jerr[:, 0].max(), tol * scale)
        np.testing.assert_allclose(hp.numpy(), hr.numpy(), atol=1e-6)


def test_corrected_i8_parts_match_the_two_pass_reference():
    nch, ntaps, s = 2, 32, 64
    w2d, pairs = _window(ntaps), baseline_pairs(nch, True)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    svd = svd_tensors(w2d, "cpu")
    x = torch.from_numpy(_blocks_i8(nch, 3, seed=3, s=s))
    hr = {"tail": torch.zeros((nch, ntaps - 1, NBINS, 2), dtype=torch.int8),
          "mu_prev": torch.zeros((nch,), dtype=torch.complex64)}
    tail, mu_first = hr["tail"], hr["mu_prev"]
    for k in range(3):
        got, tail, mu = _corrected(x[:, k:k + 1], tail, wt, pt, svd,
                                   mu_first, STEP)
        mu_first = mu[-1]
        want, hr = fx_fused_raw_i8_reference(x[:, k].contiguous(), hr, wt,
                                             pt, STEP, svd)
        scale = want.abs().max().item()
        err = (got[0] - want).abs()
        assert err[:, 1:].max() <= 3e-5 * scale, f"block {k}"
        # the DC bin: eps of the raw |mu|^2 |Abar(0)|^2 S that cancels there
        assert err[:, 0].max() <= 5e-4 * scale, f"block {k}, DC"
        assert torch.equal(tail, hr["tail"])
        assert (mu_first - hr["mu_prev"]).abs().max() <= 1e-7


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_svd_correction_leaves_no_residue_of_the_mean(ingest):
    """In the SVD-FIR mode the FIR applies the window ``u v``, so the
    correction takes the constants of ``u v``: with a receiver's offset of
    0.4 sigma in every block, the corrected single pass equals the
    two-pass plain version (the mean removed before the same FIR) within
    2e-6 of max|xp| off the DC bin, over K = 4 blocks in one call.
    Constants of the window itself would leave ``mu (A(u v) - A(w))`` in
    every frame, several times that."""
    nch, ntaps, s, k = 2, 32, 64, 4
    w2d, pairs = _window(ntaps), baseline_pairs(nch, True)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    svd = svd_tensors(w2d, "cpu")
    rng = np.random.default_rng(11)
    if ingest == "int8":
        dc = np.array([[12.0, -9.0], [-9.0, 12.0]])[:, None, None, None, :]
        x = torch.from_numpy(np.clip(np.rint(
            30 * rng.normal(size=(nch, k, s, NBINS, 2)) + dc), -127,
            127).astype(np.int8))
        hist = {"tail": torch.zeros((nch, ntaps - 1, NBINS, 2),
                                    dtype=torch.int8),
                "mu_prev": torch.zeros((nch,), dtype=torch.complex64)}
        got, _, _ = _corrected(x, hist["tail"], wt, pt, svd,
                               hist["mu_prev"], STEP)
        want, _ = fx_fused.fx_fused_raw_i8_multi_reference(x, hist, wt, pt,
                                                           STEP, svd)
    else:
        x = torch.from_numpy(
            (rng.normal(size=(nch, k, s, NBINS))
             + 1j * rng.normal(size=(nch, k, s, NBINS))
             + np.array([0.4 - 0.3j, -0.3 + 0.4j])[:, None, None, None]
             ).astype(np.complex64))
        hist = torch.zeros((nch, ntaps - 1, NBINS), dtype=torch.complex64)
        got, _, _ = _corrected(x, hist, wt, pt, svd)
        want, _ = fx_fused.fx_fused_raw_multi_reference(x, hist, wt, pt,
                                                        svd)
    err = (got - want).abs()
    scale = want.abs().max().item()
    print(f"off DC {err[..., 1:].max().item() / scale:.3g} of max|xp|")
    assert err[..., 1:].max().item() <= 2e-6 * scale


@pytest.mark.parametrize("ntaps", [4, 32])
def test_parts_of_two_halves_add_up(ntaps):
    """The parts are sums over frames: those of a block's two halves, the
    second with the first's raw last rows as its history and its GJ
    masked (its first frames are not the block's first), add up to the
    whole block's; what a frame-sharded step reduces across ranks
    (fxtpu/parallel/sharded.py)."""
    nch, s = 2, 64
    w2d, pairs = _window(ntaps), baseline_pairs(nch, True)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    x = torch.from_numpy(_blocks(nch, 1, seed=11, s=s))
    rng = np.random.default_rng(12)
    hist = torch.from_numpy((rng.normal(size=(nch, ntaps - 1, NBINS)) + 1j
                             * rng.normal(size=(nch, ntaps - 1, NBINS))
                             ).astype(np.complex64))
    consts = dc_constants(w2d, NBINS, s)
    whole = fx_fused_parts_reference(x, hist, wt, pt, consts=consts)
    half = s // 2
    first = fx_fused_parts_reference(x[:, :, :half].contiguous(), hist, wt,
                                     pt, consts=consts)
    raw_tail = x[:, 0, half - (ntaps - 1):half]
    second = fx_fused_parts_reference(x[:, :, half:].contiguous(), raw_tail,
                                      wt, pt, consts=consts)
    for i, name in enumerate(("xp", "T")):
        _off_dc(first[i] + second[i], whole[i], 1e-6, name)
    _gj(first[2], whole[2], whole[3], whole[0], 1e-6, "GJ")
    np.testing.assert_allclose(((first[3] + second[3]) / 2).numpy(),
                               whole[3].numpy(), atol=1e-6)
    # the whole block's corrected tail is its last rows minus its mean
    np.testing.assert_allclose(
        whole[4].numpy(),
        (x[:, 0, s - ntaps + 1:] - whole[3][0][:, None, None]).numpy(),
        atol=1e-6)


@pytest.mark.parametrize("ingest,ntaps,fir", [
    ("complex64", 4, "direct"), ("complex64", 32, "svd"),
    ("int8", 4, "direct"), ("int8", 32, "svd")])
def test_three_blocks_in_one_call_match_three_chained_calls(ingest, ntaps,
                                                            fir):
    """K = 3 in one single-pass call (blocks 1 and 2 corrected for the raw
    rows of the block before) against three chained one-block calls,
    within fxtpu's bound for its multi kernel, 1e-5*scale."""
    nch, s, k = 2, 64, 3
    w2d, pairs = _window(ntaps), baseline_pairs(nch, True)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    svd = svd_tensors(w2d, "cpu") if fir == "svd" else None
    if ingest == "int8":
        x = torch.from_numpy(_blocks_i8(nch, k, seed=21, s=s))
        hist = torch.zeros((nch, ntaps - 1, NBINS, 2), dtype=torch.int8)
        first, step = torch.zeros((nch,), dtype=torch.complex64), STEP
    else:
        x = torch.from_numpy(_blocks(nch, k, seed=21, s=s))
        hist = torch.zeros((nch, ntaps - 1, NBINS), dtype=torch.complex64)
        first, step = None, None
    multi, tail_m, mu_m = _corrected(x, hist, wt, pt, svd, first, step)
    singles = []
    for j in range(k):
        one, hist, mu = _corrected(x[:, j:j + 1], hist, wt, pt, svd, first,
                                   step)
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


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_parts_wrappers_take_plain_versions_on_cpu(ingest):
    nch, ntaps = 2, 4
    w2d, pairs = _window(ntaps), baseline_pairs(nch)
    wt, pt = torch.from_numpy(w2d), pairs_tensor(pairs, nch, "cpu")
    if ingest == "int8":
        x = torch.from_numpy(_blocks_i8(nch, 2, seed=1))
        hist = torch.zeros((nch, ntaps - 1, NBINS, 2), dtype=torch.int8)
        fn, ref, arg = fx_fused_parts_i8, fx_fused_parts_i8_reference, (STEP,)
    else:
        x = torch.from_numpy(_blocks(nch, 2, seed=1))
        hist = torch.zeros((nch, ntaps - 1, NBINS), dtype=torch.complex64)
        fn, ref, arg = fx_fused_parts, fx_fused_parts_reference, ()
    before = (fn.launches, fn.svd_launches)
    got, want = fn(x, hist, wt, pt, *arg), ref(x, hist, wt, pt, *arg)
    assert (fn.launches, fn.svd_launches) == before   # no kernel launched
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [tuple(g.shape) for g in got[:4]] == [
        (2, 1, NBINS), (2, nch, NBINS), (2, nch, NBINS), (2, nch)]


@pytest.mark.parametrize("nbins,ntaps,nch,s_rows,rank,ok", [
    (4096, 4, 2, 64, 0, True), (256, 4, 2, 3, 0, True),
    (256, 4, 2, 2, 0, False),        # a block shorter than the halo
    (8192, 32, 2, 32, 6, True),      # the CLI's deep-tap block
    (8192, 32, 2, 30, 6, False), (4096, 4, 6, 64, 0, True),
    (4096, 4, 7, 64, 0, True),       # the wide route (x_stage "global")
    (384, 4, 2, 64, 0, True),        # 3 x 128 bins: the mixed-radix FFT
    (1000, 4, 2, 64, 0, False),      # not a multiple of 128
])
def test_supported_parts_shapes(nbins, ntaps, nch, s_rows, rank, ok):
    assert supported_parts(nbins, ntaps, nch, s_rows, rank) is ok


@pytest.mark.parametrize("s_rows,nbins,nch,nbl,most", [
    (512, 4096, 2, 1, 25),     # bench_pipeline: 5 rows of partials a CTA
    (512, 4096, 2, 3, 18),
    (64, 4096, 2, 1, 102),     # the flagship
    (32, 256, 2, 1, 3276),
])
def test_max_blocks_parts(s_rows, nbins, nch, nbl, most):
    assert fx_fused.max_blocks_parts(s_rows, nbins, nch, nbl) == most


# --- the single pass on the card: the frame kernel's cluster split ----------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _card_parts_inputs(nch, k, s, nbins, ntaps, int8, device, seed):
    """Merged blocks with a small DC offset per channel and block, a
    random history, the window, pairs with autos and the constants."""
    w2d = pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)
    rng = np.random.default_rng(seed)
    grade = np.arange(1, nch + 1)[:, None] + 0.5 * np.arange(k)[None, :]
    if int8:
        dc = np.array([3.0, -2.0]) * grade[..., None, None, None]
        x = np.clip(np.rint(30 * rng.normal(size=(nch, k, s, nbins, 2)) + dc),
                    -127, 127).astype(np.int8)
        hist = np.clip(np.rint(30 * rng.normal(
            size=(nch, ntaps - 1, nbins, 2))), -127, 127).astype(np.int8)
    else:
        x = (rng.normal(size=(nch, k, s, nbins))
             + 1j * rng.normal(size=(nch, k, s, nbins))
             + (0.04 - 0.03j) * grade[..., None, None]).astype(np.complex64)
        hist = (rng.normal(size=(nch, ntaps - 1, nbins)) + 1j * rng.normal(
            size=(nch, ntaps - 1, nbins))).astype(np.complex64)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(hist, device=device),
            torch.as_tensor(w2d, device=device),
            pairs_tensor(baseline_pairs(nch, True), nch, device),
            dc_constants(w2d, nbins, s, device))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nbins,s,ntaps,nch,k", [
    (256, 32, 4, 3, 1),       # odd: CTA 1 of a cluster has one channel fewer
    (256, 32, 4, 5, 2),       # odd, five channels, two blocks
    (4096, 8, 4, 6, 1),       # six at 4096 bins: the shared route's most
    (256, 16, 4, 2, 8),       # K = 8 blocks in one launch
    (8192, 8, 4, 2, 2),       # the largest bin count (16 x 16 x 32)
    (256, 8, 4, 1, 2),        # one channel: a cluster of one CTA
    (384, 16, 3, 2, 1),       # 3 x 128 bins: halves of 192, mixed radix
    (3072, 8, 4, 3, 2),       # 3 x 1024, three channels, two blocks
    (12288, 8, 4, 1, 1),      # above 8192 bins: two halves and a radix 2
])
def test_cuda_parts_cluster_split_matches_plain_version(cuda_device, nbins,
                                                        s, ntaps, nch, k,
                                                        int8):
    """The single pass's shared route, a frame group on a cluster of two
    CTAs (each CTA's own channels' T, GJ and sample sums, every pair's
    cross power over its half of the bins), against its plain version:
    xp and T off the DC bin and at it on their own scales, GJ, 2e-5 of
    scale (3e-5 for 8-bit samples), mu and the tail 1e-6 (the int8 tail
    exact); bit for bit from run to run."""
    x, hist, wt, pt, consts = _card_parts_inputs(
        nch, k, s, nbins, ntaps, int8, cuda_device, seed=80 + nch)
    if int8:
        fn, ref, args = (fx_fused_parts_i8, fx_fused_parts_i8_reference,
                         (x, hist, wt, pt, STEP, None, consts))
    else:
        fn, ref, args = (fx_fused_parts, fx_fused_parts_reference,
                         (x, hist, wt, pt, None, consts))
    before = fn.launches
    got = fn(*args, x_stage="shared")
    want = ref(*args)
    again = fn(*args, x_stage="shared")
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    tol = 3e-5 if int8 else 2e-5
    for name, g, w in zip(("xp", "T"), got, want):
        _off_dc(g.cpu().numpy(), w.cpu().numpy(), tol, name)
    assert (got[2] - want[2]).abs().max() <= tol * want[2].abs().max()
    assert (got[3] - want[3]).abs().max() <= 1e-6 * max(
        1.0, want[3].abs().max().item())
    if int8:
        assert torch.equal(got[4], want[4])
    else:
        assert (got[4] - want[4]).abs().max() <= 1e-6
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_parts_refused_launch_raises(cuda_device, int8):
    """A cluster launch the card refuses (eight spectra of 8192 bins on
    the shared route, more shared memory than a CTA has) returns its
    error and the launch raises: no other grid, no plain version.  The
    planner never takes that route there, so the plan is the wide
    route's, moved onto the shared one with the shared route's scratch."""
    nch, nbins, ntaps = 8, 8192, 4
    x, hist, wt, pt, consts = _card_parts_inputs(
        nch, 1, 4, nbins, ntaps, int8, cuda_device, seed=89)
    assert fx_fused.frame_shared_bytes(
        nbins, nch, chan_slots=fx_fused.PARTS_CHAN_SLOTS) > (
        fx_fused.MAX_SHARED_BYTES)
    wide = fx_fused.plan_parts(x, hist, wt, pt, None, consts,
                               STEP if int8 else None, "global")
    sums, _, parts = wide.buffers
    scratch = ("scratch", (1, wide.n_groups, wide.nbl + 2 * nch, nbins),
               torch.complex64)
    plan = dataclasses.replace(wide, route="shared", xplan=None, rowmap=None,
                               buffers=(sums, scratch, parts))
    with pytest.raises(RuntimeError, match="CUDA error"):
        fx_fused.launch_parts(plan, fx_fused.parts_buffers(plan))
        torch.cuda.synchronize()
