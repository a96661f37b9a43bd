"""The X stage of the single pass over spectra in device memory.

Counterpart of the X loop of ``fxtpu.ops.pfb_pallas._fx_kernel``
(any pair list, autos with no imaginary part) and of its T and GJ
accumulators, for channel counts whose spectra of a frame do not fit in
one CTA's shared memory together.  The CUDA kernel is
``fxtpu_torch/csrc/fx_xstage.cu``; the wide route of the single pass
(``fx_fused.fx_fused_parts(..., x_stage="global")``) launches it after the
frame kernel has written every spectrum out, and :func:`fx_xstage`
launches it alone, beside its plain version :func:`fx_xstage_reference`.

Contract, for ``spec`` complex64 ``[K, nch, S, nbins]``, ``pairs`` int32
``[nbl, 2]`` and ``da`` complex64 ``[halo, nbins]``
(``dc_posthoc.dc_constants``' dA): ``parts [K, nbl + 2 nch, nbins]``,
rows ``0 .. nbl-1`` the frame-summed ``spec_p conj(spec_q)`` of each pair
(imaginary part exactly 0 for an auto pair), then ``T_c``, the sum of
channel c's spectra, then ``GJ_c``, the sum over frames ``f < halo`` of
``spec_c[f] conj(dA[f])``.
"""

from __future__ import annotations

import torch

__all__ = ["fx_xstage", "fx_xstage_reference", "xstage_shared_bytes",
           "XSTAGE_BINS", "XSTAGE_FRAMES"]

#: Bins of a CTA's tile (one a lane; kTileBins).
XSTAGE_BINS = 32
#: Frames of every channel a CTA stages at once (kChunk).
XSTAGE_FRAMES = 8


def xstage_shared_bytes(nch: int) -> int:
    """Dynamic shared memory of the X kernel: a chunk of frames of every
    channel at a tile of bins (128 KiB at 64 channels)."""
    return nch * XSTAGE_FRAMES * XSTAGE_BINS * 8


def fx_xstage_reference(spec: torch.Tensor, pairs: torch.Tensor,
                        da: torch.Tensor) -> torch.Tensor:
    """The X stage in plain torch, same contract as :func:`fx_xstage`."""
    halo = da.shape[0]
    idx = pairs.to(device=spec.device, dtype=torch.long)
    xp = (spec[:, idx[:, 0]] * spec[:, idx[:, 1]].conj()).sum(dim=2)
    autos = idx[:, 0] == idx[:, 1]
    xp[:, autos] = xp[:, autos].real.to(xp.dtype)
    t = spec.sum(dim=2)
    gj = (spec[:, :, :halo] * da.conj()).sum(dim=2)
    return torch.cat([xp, t, gj], dim=1)


def _check(spec, pairs, da):
    if spec.dtype != torch.complex64 or da.dtype != torch.complex64:
        raise TypeError("spec and da must be complex64")
    if pairs.dtype != torch.int32:
        raise TypeError("pairs must be int32")
    if spec.ndim != 4:
        raise ValueError(f"spec must be [K, nch, S, nbins], got "
                         f"{tuple(spec.shape)}")
    k, _, s_rows, nbins = spec.shape
    if da.ndim != 2 or da.shape[1] != nbins or da.shape[0] > s_rows:
        raise ValueError(f"da {tuple(da.shape)} must be [halo <= {s_rows}, "
                         f"{nbins}]")
    if pairs.ndim != 2 or pairs.shape[1] != 2:
        raise ValueError(f"pairs must be [nbl, 2], got {tuple(pairs.shape)}")
    if not (1 <= k <= 65535 and nbins % XSTAGE_BINS == 0):
        raise ValueError(f"the X kernel takes 1 to 65535 blocks and nbins a "
                         f"multiple of {XSTAGE_BINS}, got K={k}, "
                         f"nbins={nbins}")
    for name, t in (("pairs", pairs), ("da", da)):
        if t.device != spec.device:
            raise ValueError(f"{name} is on {t.device}, spec on "
                             f"{spec.device}")
    for name, t in (("spec", spec), ("pairs", pairs), ("da", da)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def xstage_launch(spec, pairs, da, parts, fold=None):
    """Launch the X kernel over ``spec`` into ``parts`` on the current
    stream, checked, and count it on ``fx_xstage.launches``.  ``fold =
    (x, sums, mu, new_hist, n_groups, step)`` ends the wide route's step
    (``fx_fused._launch_parts``): the launch also forms mu and the new
    history from the merged samples ``x`` and the frame kernel's sample
    sums; ``step`` is None for complex64 samples, the quantisation step of
    8-bit ones."""
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    k, nch, s_rows, nbins = spec.shape
    x = sums = mu = new_hist = None
    n_groups, step = 0, None
    if fold is not None:
        x, sums, mu, new_hist, n_groups, step = fold
    entry = lib.fxt_xstage if step is None else lib.fxt_xstage_i8
    extra = () if step is None else (step,)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = entry(spec.data_ptr(), pairs.data_ptr(), ptr(da),
                   parts.data_ptr(), ptr(x), ptr(sums), ptr(mu),
                   ptr(new_hist), nch, k, s_rows, nbins, pairs.shape[0],
                   da.shape[0], n_groups, *extra, stream)
    check(lib, rc, "fx_xstage kernel launch")
    fx_xstage.launches += 1


def fx_xstage(spec: torch.Tensor, pairs: torch.Tensor,
              da: torch.Tensor) -> torch.Tensor:
    """The X stage over the frames' spectra ``spec [K, nch, S, nbins]``
    -> ``parts [K, nbl + 2 nch, nbins]`` (module docstring contract).

    CPU tensors run :func:`fx_xstage_reference`; CUDA tensors launch the
    kernel (built at first use) or raise.  Each launch of the kernel adds
    one to ``fx_xstage.launches``: those of this call, and those of the
    single pass's wide route, which launches it after its frame kernel
    (``fx_fused.fx_fused_parts(..., x_stage="global")``)."""
    if spec.device.type == "cpu":
        return fx_xstage_reference(spec, pairs, da)
    if spec.device.type != "cuda":
        raise ValueError(f"fx_xstage runs on cuda or cpu, not {spec.device}")
    _check(spec, pairs, da)
    k, nch, _, nbins = spec.shape
    parts = torch.empty((k, pairs.shape[0] + 2 * nch, nbins),
                        dtype=torch.complex64, device=spec.device)
    xstage_launch(spec, pairs, da, parts)
    return parts


fx_xstage.launches = 0
