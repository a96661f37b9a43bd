"""The mesh-sharded FX step of fxtpu_torch against fxtpu's, on the same
numpy inputs: fxtpu on its 8 virtual CPU devices (tests/conftest.py), the
port on 8 shards of the CPU (``[torch.device("cpu")] * 8``), each on its
own route as fxtpu's tests take them (fused=True: the single pass on every
shard, through the plain versions here, fxtpu's Pallas kernel in interpret
mode; otherwise the plain step with the corner turn).

Tolerances, as tests/test_sharded.py: the fused step 2e-5*scale with the
history to 1e-6 (the raw int8 tails exactly, mu_prev rtol 1e-5); the plain
step rtol 5e-4, atol 5e-7 (history rtol 1e-5, atol 1e-7); 8-bit samples
against the float mesh fed the same values 3e-5*scale; the K-block calls
3e-5*scale with the history to 1e-5; the plain K-block call rtol 5e-5,
atol 1e-7.  Card tests (marked ``cuda``) hold the shards' kernels on one
card to the single-device engine there.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine, _unpack_i8_words  # noqa: E402
from fxtpu_torch.ops import fx_epilogue, fx_fused  # noqa: E402
from fxtpu_torch.parallel import (make_correlator_mesh,  # noqa: E402
                                  validate_shapes)
from fxtpu_torch.parallel.mesh import Shard, all_shards  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


def _kw(**kw):
    kw.setdefault("num_samp", 2**14)
    kw.setdefault("nbins", 256)
    kw.setdefault("clamp_num_samp", False)
    return kw


def _engines(t, f, fused="auto", **kw):
    """fxtpu's mesh engine and the port's on a (t, f) mesh of each."""
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.fx import FxEngine as JEngine
    from fxtpu.parallel import make_correlator_mesh as jmesh
    kw = _kw(**kw)
    jeng = JEngine(JConfig(**kw), mesh=jmesh(t, f), fused=fused)
    peng = FxEngine(CorrelatorConfig(**kw, device="cpu"), fused=fused,
                    mesh=make_correlator_mesh(t, f, devices=CPU8))
    return jeng, peng


def _blocks(nch, num_samp, k, seed, int8=False):
    rng = np.random.default_rng(seed)
    if int8:
        return [rng.integers(-127, 128, size=(nch, num_samp, 2)
                             ).astype(np.int8) for _ in range(k)]
    return [(rng.normal(size=(nch, num_samp))
             + 1j * rng.normal(size=(nch, num_samp))).astype(np.complex64)
            for _ in range(k)]


def _c(x):
    from fxtpu.ops.cplx import Cplx, to_complex
    return to_complex(x) if isinstance(x, Cplx) else np.asarray(x)


def _jstep(jeng, block, delays, hist):
    import jax.numpy as jnp
    return jeng.step(jeng.prepare_block(block), jnp.asarray(delays), hist)


def _pstep(peng, block, delays, hist):
    return peng.step(peng.prepare_block(block), torch.as_tensor(delays),
                     hist)


def _assert_i8_history(ph, jh):
    """A raw-tail history against fxtpu's (packed words): the tails
    exactly, mu_prev rtol 1e-5."""
    tail = np.stack([_unpack_i8_words(np.asarray(w)) for w in jh["tail"]],
                    axis=-1)
    np.testing.assert_array_equal(ph["tail"].numpy(), tail)
    np.testing.assert_allclose(ph["mu_prev"].numpy(), _c(jh["mu_prev"]),
                               rtol=1e-5, atol=1e-8)


# --------------------------------------------------------------------------
# The fused frame-sharded step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t,f", [(4, 2), (8, 1)])
@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM"])
def test_fused_sharded_matches_single_device(t, f, mode):
    """Every shard's single pass behind the halo, the parts summed, one
    epilogue: fxtpu's fused mesh step over two chained blocks, and the
    port's single-device fused engine on the first."""
    jeng, peng = _engines(t, f, fused=True, mode=mode)
    assert jeng.step.fused_kernel and peng.step.fused_kernel
    assert peng.fused_active and not peng.kernel_active
    delays = np.asarray([0.0, 3.3e-7], np.float32)
    jh, ph = jeng.fresh_history(), peng.fresh_history()
    scale = None
    for k, blk in enumerate(_blocks(2, 2**14, 2, seed=0)):
        jv, jh = _jstep(jeng, blk, delays, jh)
        pv, ph = _pstep(peng, blk, delays, ph)
        want = _c(jv)
        scale = scale or np.abs(want).max()   # block 0's, as fxtpu's test
        np.testing.assert_allclose(pv.numpy(), want, atol=2e-5 * scale,
                                   err_msg=f"block {k}")
        np.testing.assert_allclose(ph.numpy(), _c(jh), atol=1e-6)
        if k == 0:
            one = FxEngine(CorrelatorConfig(**_kw(mode=mode), device="cpu"),
                           fused=True)
            v1, h1 = _pstep(one, blk, delays, one.fresh_history())
            np.testing.assert_allclose(pv.numpy(), v1.numpy(),
                                       atol=2e-5 * scale)
            np.testing.assert_allclose(ph.numpy(), h1.numpy(), atol=1e-6)


def test_fused_sharded_nchan8_wide_route():
    """8 channels with autos at 4096 bins, where every shard's single pass
    takes the wide route, on a (2, 1) mesh over two chained blocks of 8
    frames with a mean offset, against fxtpu's single-device fused engine
    (the contract fxtpu's sharded tests hold its mesh to: fxtpu's own
    fused mesh step differs from it by 2.2e-4 of scale at this shape,
    baseline 19, bin 1669, with or without the offset)."""
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.fx import FxEngine as JEngine
    kw = _kw(nchan=8, include_autos=True, nbins=4096, num_samp=8 * 4096)
    jeng = JEngine(JConfig(**kw), fused=True)
    peng = FxEngine(CorrelatorConfig(**kw, device="cpu"), fused=True,
                    mesh=make_correlator_mesh(2, 1, devices=CPU8))
    assert peng.x_stage == "global" and len(peng.pairs) == 36
    delays = (1e-7 * np.arange(8)).astype(np.float32)
    jh, ph = jeng.fresh_history(), peng.fresh_history()
    for k, blk in enumerate(_blocks(8, 8 * 4096, 2, seed=31)):
        blk = (blk + np.complex64(0.02 - 0.01j)).astype(np.complex64)
        jv, jh = _jstep(jeng, blk, delays, jh)
        pv, ph = _pstep(peng, blk, delays, ph)
        want = _c(jv)
        np.testing.assert_allclose(pv.numpy(), want,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=f"block {k}")
        np.testing.assert_allclose(ph.numpy(), _c(jh), atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_fused_sharded_deep_taps_at_a_shard_boundary(int8):
    """32 taps on a (2, 1) mesh of 32 rows a shard: shard 1's FIR reads
    31 rows of shard 0 through the halo; against the port's single-device
    fused engine (the same plain versions) over two chained blocks, a mean
    offset in the samples."""
    kw = _kw(ntaps=32, mode="SPECTRUM",
             ingest_dtype="int8" if int8 else "complex64")
    cfg = CorrelatorConfig(**kw, device="cpu")
    peng = FxEngine(cfg, fused=True,
                    mesh=make_correlator_mesh(2, 1, devices=CPU8))
    one = FxEngine(cfg, fused=True)
    assert peng.fir_mode == one.fir_mode == "svd"
    assert fx_fused.deep_fir(32, 2**14 // 256 // 2)
    delays = np.asarray([0.0, 2e-7], np.float32)
    ph, h1 = peng.fresh_history(), one.fresh_history()
    for blk in _blocks(2, 2**14, 2, seed=5, int8=int8):
        if not int8:
            blk = (blk + np.complex64(0.03)).astype(np.complex64)
        pv, ph = _pstep(peng, blk, delays, ph)
        v1, h1 = _pstep(one, blk, delays, h1)
        tol = (3e-5 if int8 else 2e-5) * v1.abs().max().item()
        np.testing.assert_allclose(pv.numpy(), v1.numpy(), atol=tol)
    if int8:
        assert torch.equal(ph["tail"], h1["tail"])
    else:
        np.testing.assert_allclose(ph.numpy(), h1.numpy(), atol=1e-6)


@pytest.mark.parametrize("t,f", [(4, 2), (8, 1)])
@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM"])
def test_int8_native_sharded_matches_single_device(t, f, mode):
    """8-bit samples through the mesh as they arrived: frame-sharded int8
    rows, the raw int8 halo, the summed parts corrected for mu and
    mu_prev once; fxtpu's int8-native mesh step over two chained blocks
    (its packed tails unpacked), raw tails exactly."""
    jeng, peng = _engines(t, f, fused=True, mode=mode, ingest_dtype="int8")
    assert jeng.int8_native and peng.int8_native
    assert peng.step.int8_native
    blocks = _blocks(2, 2**14, 2, seed=3, int8=True)
    iq = peng.prepare_block(blocks[0])
    assert sorted(iq) == list(range(8))
    assert all(x.dtype == torch.int8 and x.shape == (2, 8, 256, 2)
               for x in iq.values())
    delays = np.asarray([0.0, 3.3e-7], np.float32)
    jh, ph = jeng.fresh_history(), peng.fresh_history()
    for k, blk in enumerate(blocks):
        jv, jh = _jstep(jeng, blk, delays, jh)
        pv, ph = _pstep(peng, blk, delays, ph)
        want = _c(jv)
        np.testing.assert_allclose(pv.numpy(), want,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=f"block {k}")
        _assert_i8_history(ph, jh)


def test_int8_sharded_matches_f32_mesh_within_quant():
    """The int8 mesh against fxtpu's float mesh fed the same quantized
    values: the same arithmetic on the same values, so a float
    tolerance."""
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.fx import FxEngine as JEngine
    from fxtpu.parallel import make_correlator_mesh as jmesh
    raw = _blocks(2, 2**14, 1, seed=5, int8=True)[0]
    step = 1.0 / 32
    cplx = ((raw[..., 0].astype(np.float32)
             + 1j * raw[..., 1].astype(np.float32)) * step
            ).astype(np.complex64)
    delays = np.asarray([0.0, 1e-7], np.float32)
    jeng = JEngine(JConfig(**_kw(mode="SPECTRUM")), mesh=jmesh(4, 2),
                   fused=True)
    peng = FxEngine(CorrelatorConfig(**_kw(mode="SPECTRUM", quant_step=step,
                                           ingest_dtype="int8"),
                                     device="cpu"),
                    fused=True, mesh=make_correlator_mesh(4, 2, CPU8))
    vf, _ = _jstep(jeng, cplx, delays, jeng.fresh_history())
    v8, _ = _pstep(peng, raw, delays, peng.fresh_history())
    want = _c(vf)
    np.testing.assert_allclose(v8.numpy(), want,
                               atol=3e-5 * np.abs(want).max())


# --------------------------------------------------------------------------
# The plain step with the corner turn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t,f", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)])
@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM"])
def test_sharded_matches_single_device(t, f, mode):
    """DC removal over the block, the halo, the corner turn over freq and
    the psum over time: fxtpu's plain mesh step (its XLA path)."""
    jeng, peng = _engines(t, f, mode=mode)
    assert not peng.fused_active and not peng.step.fused_kernel
    blk = _blocks(2, 2**14, 1, seed=0)[0]
    delays = np.asarray([0.0, 3.3e-7], np.float32)
    jv, jh = _jstep(jeng, blk, delays, jeng.fresh_history())
    pv, ph = _pstep(peng, blk, delays, peng.fresh_history())
    np.testing.assert_allclose(pv.numpy(), _c(jv), rtol=5e-4, atol=5e-7)
    np.testing.assert_allclose(ph.numpy(), _c(jh), rtol=1e-5, atol=1e-7)


def test_sharded_nchan8_baselines():
    jeng, peng = _engines(4, 2, nchan=8, mode="SPECTRUM", include_autos=True)
    blk = _blocks(8, 2**14, 1, seed=7)[0]
    delays = np.asarray([0.0] + [3.3e-7] * 7, np.float32)
    jv, _ = _jstep(jeng, blk, delays, jeng.fresh_history())
    pv, _ = _pstep(peng, blk, delays, peng.fresh_history())
    assert pv.shape == (36, 256)   # 8 inputs -> 36 baselines with autos
    np.testing.assert_allclose(pv.numpy(), _c(jv), rtol=5e-4, atol=5e-7)


def test_sharded_streaming_history():
    """The history the sharded step carries feeds the next block as
    fxtpu's does, over three blocks."""
    jeng, peng = _engines(4, 2)
    delays = np.asarray([0.0, 1e-7], np.float32)
    jh, ph = jeng.fresh_history(), peng.fresh_history()
    for blk in _blocks(2, 2**14, 3, seed=11):
        jv, jh = _jstep(jeng, blk, delays, jh)
        pv, ph = _pstep(peng, blk, delays, ph)
        np.testing.assert_allclose(pv.numpy(), _c(jv), rtol=5e-4, atol=5e-7)


def test_validate_shapes():
    """The three errors and the shard sizes, as fxtpu's."""
    from fxtpu.parallel import make_correlator_mesh as jmesh
    from fxtpu.parallel import validate_shapes as jvalidate
    mesh = make_correlator_mesh(4, 2, CPU8)
    assert validate_shapes(2**14, 256, mesh) == (8, 128)
    assert jvalidate(2**14, 256, jmesh(4, 2)) == (8, 128)
    with pytest.raises(ValueError):
        validate_shapes(2**14, 100, mesh)      # bins not divisible by freq
    with pytest.raises(ValueError):
        validate_shapes(256 * 12, 256, mesh)   # rows not divisible by 8
    with pytest.raises(ValueError, match="halo"):
        validate_shapes(256 * 16, 256, mesh, ntaps=4)


def test_mesh_construction():
    mesh = make_correlator_mesh(0, 2, devices=CPU8)   # all devices
    assert mesh.shape["time"] * mesh.shape["freq"] == 8
    assert mesh.local == list(range(8)) and mesh.process_count == 1
    assert all(s == Shard(0, torch.device("cpu")) for s in mesh.shards)
    assert len(all_shards(4, "cpu")) == 4
    with pytest.raises(ValueError):
        make_correlator_mesh(16, 2, devices=CPU8)


def test_single_tap_pfb_sharded():
    """ntaps=1 (a windowed FFT) has no halo; sharded all the same."""
    jeng, peng = _engines(4, 2, ntaps=1)
    blk = _blocks(2, 2**14, 1, seed=0)[0]
    delays = np.asarray([0.0, 3.3e-7], np.float32)
    jv, _ = _jstep(jeng, blk, delays, jeng.fresh_history())
    pv, _ = _pstep(peng, blk, delays, peng.fresh_history())
    np.testing.assert_allclose(pv.numpy(), _c(jv), rtol=5e-4, atol=5e-7)


# --------------------------------------------------------------------------
# K blocks a call
# --------------------------------------------------------------------------

def _delays_k(k, nch, d):
    out = np.zeros((k, nch), np.float32)
    out[:, 1] = d
    return out


@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM"])
def test_sharded_multi_step_fused_f32(mode):
    """Block-parallel K-block call (each shard the single-device engine's
    K-block entry on K/n whole blocks, the boundary history from the raw
    rows) against fxtpu's sharded multi_step and against the port's own
    K chained sharded steps."""
    import jax.numpy as jnp
    jeng, peng = _engines(4, 2, fused=True, mode=mode)
    assert peng.batch_merged
    k = peng.dispatch_batch_for(16)
    assert k == 16 == jeng.dispatch_batch_for(16)
    blocks = _blocks(2, 2**14, k, seed=13)
    delays = _delays_k(k, 2, 2e-7)
    jv, jh = jeng.multi_step(jeng.prepare_batch(blocks), jnp.asarray(delays),
                             jeng.fresh_history())
    pv, ph = peng.multi_step(peng.prepare_batch(blocks),
                             torch.from_numpy(delays), peng.fresh_history())
    want = _c(jv)
    scale = np.abs(want[0]).max()
    np.testing.assert_allclose(pv.numpy(), want, atol=3e-5 * scale)
    np.testing.assert_allclose(ph.numpy(), _c(jh), atol=1e-5)
    h = peng.fresh_history()
    for i, b in enumerate(blocks):
        v, h = _pstep(peng, b, delays[i], h)
        np.testing.assert_allclose(pv[i].numpy(), v.numpy(), atol=3e-5 * scale)
    np.testing.assert_allclose(ph.numpy(), h.numpy(), atol=1e-5)


def test_sharded_multi_step_int8_native():
    import jax.numpy as jnp
    jeng, peng = _engines(2, 4, fused=True, mode="SPECTRUM",
                          ingest_dtype="int8")
    assert peng.batch_merged and peng.int8_native
    k = 8
    blocks = _blocks(2, 2**14, k, seed=13, int8=True)
    delays = _delays_k(k, 2, 1e-7)
    jv, jh = jeng.multi_step(jeng.prepare_batch(blocks), jnp.asarray(delays),
                             jeng.fresh_history())
    pv, ph = peng.multi_step(peng.prepare_batch(blocks),
                             torch.from_numpy(delays), peng.fresh_history())
    want = _c(jv)
    np.testing.assert_allclose(pv.numpy(), want,
                               atol=3e-5 * np.abs(want[0]).max())
    _assert_i8_history(ph, jh)


def test_sharded_multi_step_xla_scan():
    """The plain mesh path takes K blocks as the per-block step in turn:
    any K, the stacked layout."""
    import jax.numpy as jnp
    jeng, peng = _engines(4, 2, fused=False, mode="SPECTRUM")
    assert not peng.batch_merged
    k = peng.dispatch_batch_for(5)
    assert k == 5
    blocks = _blocks(2, 2**14, k, seed=21)
    delays = _delays_k(k, 2, 3e-7)
    jv, jh = jeng.multi_step(jeng.prepare_batch(blocks), jnp.asarray(delays),
                             jeng.fresh_history())
    pv, ph = peng.multi_step(peng.prepare_batch(blocks),
                             torch.from_numpy(delays), peng.fresh_history())
    np.testing.assert_allclose(pv.numpy(), _c(jv), rtol=5e-4, atol=5e-7)
    h = peng.fresh_history()
    for i, b in enumerate(blocks):
        v, h = _pstep(peng, b, delays[i], h)
        np.testing.assert_allclose(pv[i].numpy(), v.numpy(), rtol=5e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(ph.numpy(), h.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ph.numpy(), _c(jh), rtol=1e-5, atol=1e-7)


def test_dispatch_batch_for_rounds_to_shard_multiple():
    jeng, peng = _engines(4, 2, fused=True)
    for want, req in ((16, 21), (8, 8), (1, 7), (1, 1)):
        assert peng.dispatch_batch_for(req) == want
        assert jeng.dispatch_batch_for(req) == want
    one = FxEngine(CorrelatorConfig(**_kw(), device="cpu"), fused=True)
    assert one.dispatch_batch_for(21) == 21   # single device: any K
    with pytest.raises(ValueError, match="K % 8"):
        peng.prepare_batch(_blocks(2, 2**14, 4, seed=1))


# --------------------------------------------------------------------------
# The package stands alone
# --------------------------------------------------------------------------

def test_parallel_modules_import_no_jax():
    """No module of fxtpu_torch.parallel imports jax or fxtpu (the card's
    machine has no JAX)."""
    mods = ("fxtpu_torch.parallel", "fxtpu_torch.parallel.mesh",
            "fxtpu_torch.parallel.collectives", "fxtpu_torch.parallel.ingest",
            "fxtpu_torch.parallel.sharded", "fxtpu_torch.parallel.multihost",
            "fxtpu_torch.parallel.accounting")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'fxtpu' "
            "or m.startswith(('jax.', 'fxtpu.'))]\n"
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _counts():
    return (fx_fused.fx_fused_parts.launches,
            fx_fused.fx_fused_parts_i8.launches,
            fx_fused.parts_reduce.launches, fx_epilogue.fx_finish.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_sharded_step_launches_the_kernels_on_every_shard(cuda_device,
                                                               int8):
    """Four shards on one card at 2 channels, 2^16 samples, 1024 bins:
    each block launches the single pass once a shard and one epilogue,
    and agrees with the single-device engine on the card."""
    kw = _kw(num_samp=2**16, nbins=1024, mode="SPECTRUM",
             ingest_dtype="int8" if int8 else "complex64")
    cfg = CorrelatorConfig(**kw, device="cuda")
    peng = FxEngine(cfg, fused=True,
                    mesh=make_correlator_mesh(2, 2, [cuda_device] * 4))
    one = FxEngine(cfg, fused=True)
    assert peng.kernel_active
    delays = torch.tensor([0.0, 2e-7], device=cuda_device)
    ph, h1 = peng.fresh_history(), one.fresh_history()
    for blk in _blocks(2, 2**16, 2, seed=9, int8=int8):
        before = _counts()
        pv, ph = peng.step(peng.prepare_block(blk), delays, ph)
        after = _counts()
        v1, h1 = one.step(one.prepare_block(blk), delays, h1)
        parts = after[1] - before[1] if int8 else after[0] - before[0]
        assert parts == 4 and after[2] - before[2] == 4
        assert after[3] - before[3] == 1
        tol = (3e-5 if int8 else 2e-5) * v1.abs().max().item()
        np.testing.assert_allclose(pv.cpu().numpy(), v1.cpu().numpy(),
                                   atol=tol)


@pytest.mark.cuda
def test_cuda_sharded_multi_matches_single_steps(cuda_device):
    """The block-parallel K = 8 call on four shards of one card against
    eight single-device steps there."""
    kw = _kw(num_samp=2**16, nbins=1024, mode="SPECTRUM")
    cfg = CorrelatorConfig(**kw, device="cuda")
    peng = FxEngine(cfg, fused=True,
                    mesh=make_correlator_mesh(4, 1, [cuda_device] * 4))
    one = FxEngine(cfg, fused=True)
    blocks = _blocks(2, 2**16, 8, seed=4)
    delays = torch.zeros((8, 2), device=cuda_device)
    delays[:, 1] = 1e-7
    pv, ph = peng.multi_step(peng.prepare_batch(blocks), delays,
                             peng.fresh_history())
    h = one.fresh_history()
    for i, b in enumerate(blocks):
        v, h = one.step(one.prepare_block(b), delays[i], h)
        np.testing.assert_allclose(pv[i].cpu().numpy(), v.cpu().numpy(),
                                   atol=3e-5 * v.abs().max().item())
    np.testing.assert_allclose(ph.cpu().numpy(), h.cpu().numpy(), atol=1e-5)


# --------------------------------------------------------------------------
# The mesh under the Correlator, and fxtpu's state in a mesh engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 8])
def test_correlator_on_a_mesh_matches_one_device(tmp_path, k):
    """A Correlator over a (2, 2) mesh of CPU shards, fused, one block a
    call and K = 8 through the stager (each shard two whole blocks),
    calibrating on its first block: the rows and delays of the same run on
    one device."""
    from fxtpu_torch.correlator import Correlator
    from fxtpu_torch.products import load_products
    from fxtpu_torch.sources import NoiseSource, save_recording
    rec = save_recording(NoiseSource(nchan=2, seed=11, delays=[0.0, 2.5e-6]),
                         str(tmp_path / "rec.npy"), 2**14, 18)
    rows = {}
    for tag, mesh in (("one", None),
                      ("mesh", make_correlator_mesh(2, 2, CPU8[:4]))):
        out = str(tmp_path / f"{tag}.csv")
        cfg = CorrelatorConfig(**_kw(mode="SPECTRUM"), device="cpu",
                               fused=True, source="replay", replay_file=rec,
                               run_time=60, loglevel="WARNING",
                               output_file=out, startup_duration=0.1,
                               blocks_per_dispatch=k)
        cor = Correlator(config=cfg, mesh=mesh)
        cor.run_state_machine()
        assert (cor.stager is not None) == (k > 1)
        assert cor.blocks_processed == 17
        rows[tag] = (load_products(out)[1], cor.calibrated_delays)
    (one, d1), (mesh_rows, dm) = rows["one"], rows["mesh"]
    np.testing.assert_allclose(dm, d1, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(mesh_rows, one,
                               atol=3e-5 * np.abs(one).max())


@pytest.mark.parametrize("int8", [False, True], ids=["c64", "int8"])
def test_import_fxtpu_mesh_state(int8):
    """fxtpu's mesh engine's carried state (its history replicated, the
    8-bit tail as packed words) imported into the port's mesh engine: the
    next block's visibility from there agrees."""
    jeng, peng = _engines(4, 2, fused=True, mode="SPECTRUM",
                          ingest_dtype="int8" if int8 else "complex64")
    blocks = _blocks(2, 2**14, 2, seed=19, int8=int8)
    delays = np.asarray([0.0, 1e-7], np.float32)
    _, jh = _jstep(jeng, blocks[0], delays, jeng.fresh_history())
    ph, pd = peng.import_fxtpu_state(jeng.window2d, jeng.pairs, jh, delays)
    jv, _ = _jstep(jeng, blocks[1], delays, jh)
    pv, _ = peng.step(peng.prepare_block(blocks[1]), pd, ph)
    want = _c(jv)
    np.testing.assert_allclose(pv.numpy(), want,
                               atol=2e-5 * np.abs(want).max())
