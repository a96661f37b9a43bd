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

import dataclasses

import torch

__all__ = ["fx_xstage", "fx_xstage_reference", "xstage_plan", "XStagePlan",
           "count_launch", "XSTAGE_BINS"]

#: The wrappers take bin counts that are multiples of this (every bin
#: count the port takes is one).
XSTAGE_BINS = 32
#: Rows of parts a thread sums (``kRows``, the kernel instance) -> the
#: threads a CTA that instance takes at most (its ``__launch_bounds__``,
#: ``RowThreads`` in ``csrc/fx_xstage.cu``): 576 x 8 rows cover 64
#: channels' 2,208 rows at a tile of 2 bins; more rows take tiles of rows
#: (:attr:`XStagePlan.row_tiles`).
XSTAGE_ROW_THREADS = {2: 256, 4: 256, 8: 576}
XSTAGE_ROWS = max(XSTAGE_ROW_THREADS)
#: Stages of the ring the frames stream through (at least 2), and the
#: shared memory the ring takes at most: 96 KiB, two CTAs an SM.
XSTAGE_STAGES = 3
XSTAGE_RING_BYTES = 96 << 10
#: CTAs the grid reaches for where the bins allow: two an SM of the
#: H100's 132, rounded to a power of two of tiles.
XSTAGE_FILL_CTAS = 256


@dataclasses.dataclass(frozen=True)
class XStagePlan:
    """One launch's shape (``XStagePlan`` in ``csrc/fx_xstage.cu``): a CTA
    owns ``tile`` bins of one block; thread t sums bin ``t % tile`` of the
    rows ``slot, slot + slots, ...`` (``slot = t // tile``), ``rows`` of
    them (the kernel instance, a key of :data:`XSTAGE_ROW_THREADS`); the
    frames stream through ``stages`` buffers of ``frames`` frames of every
    channel (tile and frames powers of two); ``threads`` a CTA;
    ``shared_bytes`` the ring and the block's means; ``row_tiles`` the
    grid's third axis, ``ceil((nbl + 2 nch) / (slots rows))`` (1 up to 64
    channels), row tile z holding rows from ``z slots rows`` on.  The
    kernel derives the row tiles from the same numbers, so they are not
    among :meth:`args`."""
    tile: int
    slots: int
    rows: int
    frames: int
    stages: int
    threads: int
    shared_bytes: int
    row_tiles: int = 1

    def args(self):
        """The entry's plan arguments, in its order."""
        return (self.tile, self.slots, self.rows, self.frames, self.stages,
                self.threads)

    def ctas(self, nbins: int, k: int) -> int:
        """CTAs a launch over ``k`` blocks of ``nbins`` bins runs."""
        return nbins // self.tile * k * self.row_tiles


def xstage_plan(nch: int, nbl: int, s_rows: int, nbins: int,
                k: int = 1) -> XStagePlan:
    """The X kernel's plan for K blocks of ``nch`` channels, ``nbl``
    pairs, ``s_rows`` frames and ``nbins`` bins (a multiple of
    :data:`XSTAGE_BINS`).  The tile is the widest power of two that
    leaves about :data:`XSTAGE_FILL_CTAS` CTAs or more, narrowed until the
    ``nbl + 2 nch`` rows spread over 256 threads (576 where 256 cannot
    hold them), at most :data:`XSTAGE_ROWS` a thread.  A slot takes one row
    of those summed over every frame (pairs and T) where they are few, and
    the GJ rows, summed over the first halo frames only, ride on the same
    threads, so every thread sums over every frame.  The kernel instance
    is the fewest rows a thread of :data:`XSTAGE_ROW_THREADS` that hold a
    slot's rows and take the threads.  Where even 576 threads of 8 rows
    at a tile of 2 bins cannot hold the rows (from 66 channels with
    autos), the rows are cut into the fewest row tiles of that instance,
    of near-equal size, each with the slots its share needs.  The ring
    takes
    :data:`XSTAGE_STAGES` stages (fewer only where one frame of every
    channel would not fit, never fewer than 2) of the most frames, a power
    of two, that :data:`XSTAGE_RING_BYTES` allows (few, large chunks: each
    costs the CTA a barrier), at most a third of the block's so that short
    blocks still overlap; after the ring, the block's means (nch
    float2)."""
    rows = nbl + 2 * nch
    busy = max(1, rows - nch)     # the rows summed over every frame
    top = min(256, nbins & -nbins)
    fill = 2
    while fill * 2 <= min(top, nbins * k // XSTAGE_FILL_CTAS):
        fill *= 2
    row_tiles = 1
    for most in sorted(set(XSTAGE_ROW_THREADS.values())):
        tile = fill
        while tile > 2 and -(-rows // (most // tile)) > XSTAGE_ROWS:
            tile //= 2
        slots = min(most // tile, busy)
        if -(-rows // slots) <= XSTAGE_ROWS:
            break
    else:
        # tile is 2 here: the rows over the widest instance's CTAs
        row_tiles = -(-rows // (most // tile * XSTAGE_ROWS))
        slots = -(-rows // (row_tiles * XSTAGE_ROWS))
    threads = -(-tile * slots // 32) * 32
    per = min(n for n, top in XSTAGE_ROW_THREADS.items()
              if n * slots * row_tiles >= rows and threads <= top)
    frame_bytes = nch * tile * 8
    stages = XSTAGE_STAGES
    while stages > 2 and stages * frame_bytes > XSTAGE_RING_BYTES:
        stages -= 1
    most = max(1, min(XSTAGE_RING_BYTES // (stages * frame_bytes),
                      -(-s_rows // stages)))
    frames = 1 << (most.bit_length() - 1)
    return XStagePlan(tile, slots, per, frames, stages, threads,
                      stages * frames * frame_bytes + nch * 8, row_tiles)


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


def count_launch(plan: XStagePlan, nbins: int, k: int):
    """Count one launch of the X kernel on :func:`fx_xstage`'s counters:
    ``launches``, and its work, ``row_tiles`` (the grid's third axis) and
    ``ctas`` (:meth:`XStagePlan.ctas`)."""
    fx_xstage.launches += 1
    fx_xstage.row_tiles += plan.row_tiles
    fx_xstage.ctas += plan.ctas(nbins, k)


def xstage_launch(spec, pairs, da, parts, fold=None):
    """Launch the X kernel over ``spec`` into ``parts`` on the current
    stream, checked, and count it (:func:`count_launch`).  ``fold =
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
    plan = xstage_plan(nch, pairs.shape[0], s_rows, nbins, k)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = entry(spec.data_ptr(), pairs.data_ptr(), ptr(da),
                   parts.data_ptr(), ptr(x), ptr(sums), ptr(mu),
                   ptr(new_hist), nch, k, s_rows, nbins, pairs.shape[0],
                   da.shape[0], n_groups, *plan.args(), *extra, stream)
    check(lib, rc, "fx_xstage kernel launch")
    count_launch(plan, nbins, k)


def fx_xstage(spec: torch.Tensor, pairs: torch.Tensor,
              da: torch.Tensor) -> torch.Tensor:
    """The X stage over the frames' spectra ``spec [K, nch, S, nbins]``
    -> ``parts [K, nbl + 2 nch, nbins]`` (module docstring contract).

    CPU tensors run :func:`fx_xstage_reference`; CUDA tensors launch the
    kernel (built at first use) or raise.  Each launch of the kernel adds
    one to ``fx_xstage.launches``, and its row tiles and CTAs to
    ``fx_xstage.row_tiles`` and ``fx_xstage.ctas``: those of this call,
    and those of the single pass's wide route, which launches it after its
    frame kernel (``fx_fused.fx_fused_parts(..., x_stage="global")``)."""
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
fx_xstage.row_tiles = 0
fx_xstage.ctas = 0
