"""Per-block collective-volume accounting for the sharded FX step.

Counterpart of ``fxtpu.parallel.accounting``.  Its two sides:

  * :func:`predicted_volume` / :func:`predicted_volume_blockdp`: the
    analytic per-block (per-dispatch) payload model of the sharded steps,
    copied from ``fxtpu``, op by op:

      - halo ``ppermute``: the ``[nch, ntaps-1, nbins]`` tail, 8 bytes a
        complex64 sample (``fxtpu``'s stacked float32 planes), or for
        8-bit samples 2 bytes a sample (``fxtpu``'s packed int32 words of
        4 bins: the same bytes),
      - psums: the fused path sums the raw cross power ``[nbl, nbins]``,
        the DC accumulators T and GJ ``[nch, nbins]``, the means ``[nch]``
        and the stream tail; the plain path the DC mean, the integrated
        ``[nbl, nbins/F]`` over ``time`` and the tail,
      - the corner turn ``all_to_all`` (plain path only, F > 1): the full
        local spectra ``[nch, S/n, nbins]``, O(num_samp) per shard;

  * :func:`measured_volume`: the same numbers counted while the step
    runs: every collective of :mod:`~fxtpu_torch.parallel.collectives`
    adds one shard's payload to its mesh's ``volume`` (where ``fxtpu``
    parses the compiled HLO instead).

The bytes are payload, not wire bytes: those depend on how a transport
moves them.
"""

from __future__ import annotations

from typing import Dict

from fxtpu_torch.parallel.mesh import OPS

__all__ = ["measured_volume", "predicted_volume", "predicted_volume_blockdp",
           "predicted_collective_time", "predicted_scaling_efficiency"]


def measured_volume(step, *args) -> Dict[str, int]:
    """Run the sharded ``step`` (or ``multi_step``) once on ``args`` and
    return the payload bytes its collectives moved, by op."""
    mesh = step.mesh
    mesh.reset_volume()
    step(*args)
    return dict(mesh.volume)


def predicted_volume(*, nch: int, nbl: int, nbins: int, num_samp: int,
                     ntaps: int, mesh_time: int, mesh_freq: int,
                     fused: bool, int8_native: bool = False,
                     continuum: bool = False) -> Dict[str, int]:
    """Analytic per-block collective payload (bytes) of the sharded step,
    op by op as ``parallel/sharded.py`` runs them."""
    n = mesh_time * mesh_freq
    halo = ntaps - 1
    s_rows = num_samp // nbins
    f32 = 4
    out = {op: 0 for op in OPS}
    if n == 1:
        return out
    # the tail [nch, halo, nbins]: complex64, or (I, Q) int8 pairs
    tail = 2 * nch * halo * (nbins // 4 if int8_native else nbins) * f32
    out["collective-permute"] = tail if ntaps > 1 else 0
    if fused:
        # psums: xp [1, nbl, nbins] + T [1, nch, nbins] + GJ the same
        # + mu [1, nch] + the stream tail handoff
        out["all-reduce"] = (2 * nbl * nbins * f32
                             + 2 * 2 * nch * nbins * f32
                             + 2 * nch * f32
                             + tail)
        # the single pass never forms frame-sharded spectra: no corner turn
        out["all-to-all"] = 0
    else:
        # the DC mean over the sample-sharded block [nch]
        # + the psum over time of the integrated product [nbl, nbins/F]
        # + the stream-tail handoff psum
        out["all-reduce"] = (2 * nch * f32
                             + (2 * nbl * (nbins // mesh_freq) * f32
                                if mesh_time > 1 else 0)
                             + (tail if ntaps > 1 else 0))
        if mesh_freq > 1:
            # corner turn: each shard's full local spectra
            # [nch, s_rows/n, nbins], O(num_samp)
            out["all-to-all"] = 2 * nch * (s_rows // n) * nbins * f32
            # the fftshift of the bin-sharded output: each freq shard
            # takes another's [nbl, nbins/F] (SPECTRUM products only)
            if not continuum:
                out["collective-permute"] += (
                    2 * nbl * (nbins // mesh_freq) * f32)
    return out


def predicted_volume_blockdp(*, nch: int, nbins: int, ntaps: int,
                             n_shards: int,
                             int8_native: bool = False) -> Dict[str, int]:
    """Analytic per-DISPATCH collective payload (bytes) of the
    block-parallel fused K-block step: one boundary-history ppermute
    (each shard's last block's tail, plus its mean for the raw-tail
    history of 8-bit samples) and one masked psum that hands every shard
    the last shard's history.  Per block, divide by K."""
    halo = ntaps - 1
    f32 = 4
    out = {op: 0 for op in OPS}
    if n_shards == 1:
        return out
    tail = 2 * nch * halo * (nbins // 4 if int8_native else nbins) * f32
    mu = 2 * nch * f32 if int8_native else 0
    out["collective-permute"] = tail + mu if ntaps > 1 else mu
    out["all-reduce"] = tail + mu if ntaps > 1 else mu
    return out


def predicted_collective_time(volumes: Dict[str, int], n_shards: int,
                              link_bw: float) -> float:
    """Seconds to move one step's collective payload over a 1D ring of
    ``n_shards`` devices with per-direction link rate ``link_bw``
    (bytes/s): a permute crosses each link once (bytes/BW); a ring
    all-reduce moves 2(n-1)/n of its payload per device; all-to-all and
    all-gather/reduce-scatter (n-1)/n.  No overlap of compute and
    collectives, so the efficiency it predicts is a lower bound given the
    volumes."""
    if n_shards <= 1:
        return 0.0
    ring = (n_shards - 1) / n_shards
    t = volumes.get("collective-permute", 0) / link_bw
    t += 2 * ring * volumes.get("all-reduce", 0) / link_bw
    t += ring * volumes.get("all-to-all", 0) / link_bw
    t += ring * (volumes.get("all-gather", 0)
                 + volumes.get("reduce-scatter", 0)) / link_bw
    return t


def predicted_scaling_efficiency(*, samples_per_s_single: float, nch: int,
                                 nbl: int, nbins: int, num_samp: int,
                                 ntaps: int, n_shards: int, link_bw: float,
                                 path: str = "fused",
                                 mesh_freq: int = 1,
                                 int8_native: bool = False,
                                 continuum: bool = False,
                                 blocks_per_dispatch: int = 1) -> dict:
    """The byte accounting turned into a time prediction: given a
    measured single-device rate (samples/s) and a link rate ``link_bw``
    (bytes/s, one direction of one link), predict the n-shard scaling
    efficiency ``eff = t_comp/n / (t_comp/n + t_coll)``.

    ``path``: 'fused' / 'xla' (the frame-sharded per-block step; 'xla' is
    the plain one, mesh_time = n / mesh_freq) / 'blockdp' (the K-block
    dispatch, collective bytes amortized over ``blocks_per_dispatch``)."""
    t_comp = nch * num_samp / samples_per_s_single
    if path == "blockdp":
        vols = predicted_volume_blockdp(nch=nch, nbins=nbins, ntaps=ntaps,
                                        n_shards=n_shards,
                                        int8_native=int8_native)
        t_coll = predicted_collective_time(
            vols, n_shards, link_bw) / max(blocks_per_dispatch, 1)
    else:
        vols = predicted_volume(nch=nch, nbl=nbl, nbins=nbins,
                                num_samp=num_samp, ntaps=ntaps,
                                mesh_time=n_shards // mesh_freq,
                                mesh_freq=mesh_freq,
                                fused=path == "fused",
                                int8_native=int8_native,
                                continuum=continuum)
        t_coll = predicted_collective_time(vols, n_shards, link_bw)
    t_shard = t_comp / n_shards
    return {
        "per_block_compute_s": t_shard,
        "per_block_collective_s": t_coll,
        "volumes": vols,
        "efficiency": t_shard / (t_shard + t_coll) if t_coll else 1.0,
        "aggregate_samples_per_s":
            nch * num_samp / (t_shard + t_coll),
    }
