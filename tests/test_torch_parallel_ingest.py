"""Sharded host -> mesh ingest (fxtpu_torch.parallel.ingest) against
fxtpu.parallel.ingest: where each shard's samples land, the engine's use
of it, the per-process sample span, and 8-bit samples through the mesh,
on 8 shards of the CPU (fxtpu on its 8 virtual CPU devices)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine  # noqa: E402
from fxtpu_torch.parallel import make_correlator_mesh  # noqa: E402
from fxtpu_torch.parallel.ingest import (block_sharding,  # noqa: E402
                                         local_sample_span, put_block,
                                         put_frames)
from fxtpu_torch.parallel.mesh import Shard  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_correlator_mesh(4, 2, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def jmesh():
    jax = pytest.importorskip("jax")
    from fxtpu.parallel import make_correlator_mesh as jmake
    return jmake(4, 2, devices=jax.devices()[:8])


def _block(rng, nch=2, ns=2**13):
    return (rng.normal(size=(nch, ns)) + 1j * rng.normal(size=(nch, ns))
            ).astype(np.complex64)


def test_put_block_sharded_placement(rng, mesh, jmesh):
    """Each shard holds its span of the sample axis, the spans those of
    fxtpu's sharding; together they are the block, bit for bit; a stacked
    batch keeps the sample axis the split one."""
    from fxtpu.parallel.ingest import put_block as jput
    blk = _block(rng)
    iq = put_block(blk, mesh)
    spans = block_sharding(mesh, blk.shape[1])
    assert sorted(iq) == list(range(8))
    jiq = jput(blk, jmesh)
    jspans = sorted((s[1].start, s[1].stop) for s in
                    jiq.re.sharding.devices_indices_map(blk.shape).values())
    assert spans == jspans
    for i, (a, b) in enumerate(spans):
        assert iq[i].device == CPU and iq[i].is_contiguous()
        np.testing.assert_array_equal(iq[i].numpy(), blk[:, a:b])
    stacked = put_block(np.stack([blk, blk]), mesh)
    assert stacked[3].shape == (2, 2, 1024)
    np.testing.assert_array_equal(stacked[3][1].numpy(), blk[:, 3072:4096])


def test_put_block_no_mesh_single_device(rng):
    """Without a mesh the engine places the whole block on its device."""
    blk = _block(rng)
    eng = FxEngine(CorrelatorConfig(num_samp=2**13, nbins=256,
                                    clamp_num_samp=False, device="cpu"))
    iq = eng.prepare_block(blk)
    assert isinstance(iq, torch.Tensor)
    np.testing.assert_array_equal(iq.numpy(), blk)


def test_engine_prepare_block_uses_mesh_sharding(rng, mesh, jmesh):
    """The engine's ingest places the block by the mesh (framed rows on
    the fused route), and its step takes that directly: fxtpu's plain
    mesh step's visibility."""
    import jax.numpy as jnp
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.fx import FxEngine as JEngine
    from fxtpu.ops.cplx import to_complex
    kw = dict(num_samp=2**13, nbins=256, clamp_num_samp=False)
    blk = _block(rng, ns=2**13)
    eng = FxEngine(CorrelatorConfig(**kw, device="cpu"), mesh=mesh)
    iq = eng.prepare_block(blk)
    assert [tuple(x.shape) for x in iq.values()] == [(2, 1024)] * 8
    vis, _ = eng.step(iq, torch.zeros(2), eng.fresh_history())
    assert vis.shape == (1, 256)
    jeng = JEngine(JConfig(**kw), mesh=jmesh)
    jv, _ = jeng.step(jeng.prepare_block(blk), jnp.zeros((2,), jnp.float32),
                      jeng.fresh_history())
    np.testing.assert_allclose(vis.numpy(), to_complex(jv), rtol=5e-4,
                               atol=5e-7)
    fused = FxEngine(CorrelatorConfig(**kw, device="cpu"), mesh=mesh,
                     fused=True)
    rows = fused.prepare_block(blk)
    assert [tuple(x.shape) for x in rows.values()] == [(2, 4, 256)] * 8
    np.testing.assert_array_equal(rows[5].numpy().reshape(2, -1),
                                  blk[:, 5 * 1024:6 * 1024])


def test_local_sample_span_single_process_covers_all(mesh):
    assert local_sample_span(mesh, 2**13) == (0, 2**13)
    # a process owning the first half of the shards reads the first half
    half = make_correlator_mesh(
        4, 2, [Shard(0, CPU)] * 4 + [Shard(1, CPU)] * 4)
    assert local_sample_span(half, 2**13, 256) == (0, 2**12)
    # a block whose length is not whole rows: the last shard's span holds
    # the samples after the last row
    assert block_sharding(mesh, 2**13 + 100, 256)[-1] == (7168, 2**13 + 100)
    frames = put_frames(np.zeros((2, 2**13 + 100), np.complex64), mesh, 256)
    assert frames[7].shape == (2, 4, 256)


def test_int8_mesh_ingest_matches_f32(mesh, jmesh):
    """8-bit planes ship through the mesh as int8 (a quarter of the bytes)
    and the sharded step dequantizes on the device: the float mesh fed
    the dequantized values to 1e-5 of scale, and fxtpu's int8 mesh."""
    import jax.numpy as jnp
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.fx import FxEngine as JEngine
    from fxtpu.ops.cplx import to_complex

    from fxtpu_torch.sources.base import QuantizedSource
    from fxtpu_torch.sources.synthetic import NoiseSource

    ns, nbins, step = 2**13, 256, 1.0 / 32
    blk_q = QuantizedSource(NoiseSource(nchan=2, seed=42),
                            quant_step=step).read_block(ns)
    blk_f = ((blk_q[..., 0].astype(np.float32)
              + 1j * blk_q[..., 1].astype(np.float32)) * step
             ).astype(np.complex64)
    kw = dict(num_samp=ns, nbins=nbins, clamp_num_samp=False)
    eng_f = FxEngine(CorrelatorConfig(**kw, device="cpu"), mesh=mesh)
    eng_q = FxEngine(CorrelatorConfig(**kw, ingest_dtype="int8",
                                      device="cpu"), mesh=mesh)
    iq_f, iq_q = eng_f.prepare_block(blk_f), eng_q.prepare_block(blk_q)
    assert all(x.dtype == torch.int8 for x in iq_q.values())
    nbytes = [sum(x.numel() * x.element_size() for x in iq.values())
              for iq in (iq_f, iq_q)]
    assert nbytes[0] == 4 * nbytes[1]
    d = torch.zeros(2)
    vf, _ = eng_f.step(iq_f, d, eng_f.fresh_history())
    vq, _ = eng_q.step(iq_q, d, eng_q.fresh_history())
    scale = vf.abs().max().item()
    np.testing.assert_allclose(vq.numpy() / scale, vf.numpy() / scale,
                               atol=1e-5)
    jeng = JEngine(JConfig(**kw, ingest_dtype="int8"), mesh=jmesh)
    jv, _ = jeng.step(jeng.prepare_block(blk_q), jnp.zeros((2,), jnp.float32),
                      jeng.fresh_history())
    np.testing.assert_allclose(vq.numpy(), to_complex(jv), rtol=5e-4,
                               atol=5e-7)
