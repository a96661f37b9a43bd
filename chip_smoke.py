#!/usr/bin/env python3
"""Drive the fxtpu_torch port once on a CUDA card and check it.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Shapes: the flagship (the CLI defaults: 2 channels, 2^18-sample blocks,
4096 bins, 4 taps), the wideband configuration of ``bench.py``
(``wideband`` / ``wideband_int8``: 2 channels, 2^21-sample blocks, 8192
bins, 32 taps, where the fused step's FIR runs through the window's
rank-6 factors, the SVD-FIR mode), the CLI's deep-tap block (2 x 2^18
samples at 8192 bins and 32 taps) and ``bench.py``'s ``bench_pipeline``
(2 channels, 2^21-sample blocks, 4096 bins, 8 blocks per dispatch).

Phases (any failure raises and exits non-zero, with no ``ok`` line):

1. print the card (``nvidia-smi`` name and power limit), the torch, CUDA
   and nvcc versions, then build the CUDA kernels from
   ``fxtpu_torch/csrc`` and the host library (the ring buffer and the
   int8 loops) from ``fxtpu_torch/csrc/host`` with ``g++``, printing the
   compiler's version, the build's seconds and the file;
2. hold each kernel entry against its plain torch version on the card,
   over 3 chained blocks from a fresh history: the fused FX step in the
   direct-loop mode (``fx_fused``, ``fx_fused_i8``) at nbins=256 with 3
   channels and autos, at the flagship, at the flagship width with 4
   channels and autos (10 pairs) and at the wideband shape; in the
   SVD-FIR mode (``fx_fused_svd``, ``fx_fused_i8_svd``) at nbins=256 x 32
   taps x 3 channels with autos and at the wideband shape: ``max|xp_k -
   xp_ref| <= 2e-5 max|xp_ref|``, the fused-against-unfused tolerance of
   ``tests/test_planes.py``, for complex64 the history within 1e-6, for
   8-bit samples the raw tail exact and ``mu_prev`` within 1e-6 max|mu|;
   the spectrometer (``spectrometer``) at nbins=256 with 4 taps (a ragged
   tail) and 1 tap and at the flagship: spectra within 5e-6 max|spec|
   (``tests/test_planes.py:301``), history within 1e-6; the K-block
   entries (``fx_fused_multi``, ``fx_fused_i8_multi``) over 2 chained
   launches in both FIR modes, K = 3 at nbins=256 (4 and 32 taps), K = 8
   at the flagship, at ``bench_pipeline``'s block (frames summed in groups
   of 2) and at the CLI's deep-tap block (SVD), and K = 2 at the wideband
   shape: within 2e-5 max|xp_ref| of their plain versions (3e-5 in the SVD
   mode) with the history bounds above, and bit for bit the K one-block
   launches; the single pass (``fx_parts``, ``fx_parts_i8``:
   ``ops.fx_fused.fx_fused_parts`` / ``fx_fused_parts_i8``) and its
   epilogue (``fx_finish``: ``ops.fx_epilogue.fx_finish``) at K = 1 and 8
   from a carried history, in the direct mode at nbins=256, the flagship,
   ``bench_pipeline``'s block and the wideband shape, in the SVD mode at
   nbins=256 x 32 taps, the CLI's deep-tap block and the wideband shape:
   the parts within 2e-5 (3e-5: 8-bit samples, deep taps) of their plain
   version's scale, off the DC bin and at it, mu and the complex64 tail
   within 1e-6, the int8 tail exact; the epilogue against ``dc_correct``
   + ``finish`` (packed and plain delays, spectra and continuum), every
   bin within 1e-6 of max|vis| plus 2e-6 of the raw cross power per frame
   that cancels at that bin, the DC bin printed apart; the corrected cross
   power against the two-pass plain version with the same allowance for
   what cancels; the single pass's wide route (``fx_parts_wide``,
   ``fx_parts_wide_i8``: the spectra through device memory to the X
   kernel of ``fx_xstage.cu``) at bench.py's nchan8 block (8 x 2^20
   samples, 4096 bins, 36 baselines), the CLI's block at ``--nchan 8``
   (8 x 2^18, 4096 bins, 28 baselines), the CLI's 8-channel deep-tap block
   (8 x 2^18, 8192 bins, 32 taps, SVD), the many-pairs shape and 64
   channels at nbins=256 (both forced onto it, and held to the shared
   route's kernels within 2e-6 of scale as well, bit equality reported)
   at K = 1 and 4, to the same rules, its autos' imaginary parts exactly
   0; the shapes of fxbench's engine cells, to the same rules: 128
   channels with autos (8,256 pairs, 2^18 samples, 4096 bins, the X
   kernel's register-tiled instance) on the wide route at K = 1 and 3 in both ingests,
   512 channels with autos (131,328 pairs, the X kernel's band instance,
   the epilogue's narrow one; CONTINUUM refused there, past 65,535 rows)
   at K = 1 in both ingests, and
   the flagship at K = 64 on the shared route in complex64 (effex2.engine's
   ingest), the plain versions taken in tiles of pairs (``by_pair_tiles``:
   every pair at once would gather 17 GB a block at 128 channels), the
   step's one C call there too (not at 512) and the reduce at K = 64 in both ingests; the X kernel alone (``fx_xstage``) at four of those
   shapes, at 128 channels (K = 1 and 3) and at 512 (K = 1) within 2e-5
   of each part's scale; the single pass's reduce alone
   (``fx_parts_reduce``: ``ops.fx_fused.parts_reduce``) at the flagship
   (K = 1 and 8) and ``bench_pipeline``'s block in both ingests, parts, mu
   and history bit for bit its plain version's; the step's one C call
   (``fxt_fx_step`` / ``_i8``, ``ops.fx_epilogue.fx_fused_step``: the
   frame kernel, then the reduce or X kernel and the epilogue as
   programmatic dependents) at the flagship (K = 1 and 8), the pipeline
   block (CONTINUUM), the deep-tap block (SVD) and the wide route's cli8,
   nchan8 and deep8 blocks, both ingests, packed and plain delays: vis, mu
   and the new history bit for bit those of the two-call step
   (``fx_fused_parts*`` then ``fx_finish``; largest difference 0), vis
   within 1e-6 of max|vis| plus 2e-6 of the raw cross power of the plain
   epilogue over the step's own parts, the parts within 2e-5 (3e-5) of
   the plain single pass's; the bench's largest calls (``bench_cases``:
   each configuration of ``fxtpu_torch.bench.CONFIGS`` at the K of its
   largest ``multi_step`` call, 22 blocks at 2 x 2^21 samples and at the
   wideband shape, 16 at wideband int8, 13 at nchan8: the calls nearest
   the single pass's cap of 25 blocks, 15 on the wide route) through the
   single pass and its epilogue, its reduce or X kernel, and at the
   largest K of each shape the FIR launch at 32 taps and the step's one C
   call, to the rules above; every stage
   of the ablation (``fx_ablate``:
   ``ops.fx_fused.fx_fused_ablate``, both ingests, both FIR modes) at
   nbins=256, at the flagship, at the CLI's deep-tap block and at the
   wideband shape, and every leg of the copy, overlap and retile probes
   (``copy_probe``, ``overlap_probe``, ``retile_probe``) at a small shape
   and at the shape it is timed at (the overlap probe also at 256 and 8192
   bins with 2 and 8 taps, each structure with the shared memory the probe
   asks for, which decides its layout: the kernel's, ``fxt_overlap_layout``,
   must be the module's plan, and a copying leg's copies must ask for its
   schedule's bytes, as the kernel counts them), each against its plain
   version (the stages within 2e-5 max|xp_ref|, 3e-5 at deep taps; the
   copy checksums exactly; overlap within 2e-5, retile within 1e-5 of
   max|plain|);
3. the main path, ``fxtpu_torch.cli.main`` for 2 s on the card, at the
   CLI defaults and at ``--resolution 8192 --ntaps 32`` (the deep-tap
   path), each with complex64 ingest and with ``--ingest int8`` (int8
   rings), then at the defaults with ``--blocks_per_dispatch 8`` (the
   staged path) in both ingests, each with every launch count set to 0
   just before and read just after: the run's single-pass wrapper and the
   epilogue ran once per correlated block each (at K = 8: K-block calls x
   8 + one-block calls = blocks), the two-pass entries and every other
   not at all (at ``--nchan 8`` in each ingest the wide route's counters
   and the X kernel's, counted by the wrapper that launches it, 28 baselines a block in the CSV, every channel's delay recovered; and
   ``FxEngine`` takes the wide route's kernels at the nchan8 shape and at
   ``--nchan 3 --resolution 8192 --ntaps 32``; at fxbench's engine cells,
   ``meerkat_l4k.engine128_int8``, ``effex2.engine`` and
   ``leda512.engine512_int8``, it takes their
   route and ingest, ``dispatch_batch_for`` gives their K (3, 64 and 1), and
   one ``multi_step`` call with every count set to 0 just before is one
   launch of the single pass, of its X kernel (the plan's CTAs and
   spectra reads, on a register-tiled instance at 128 and 512 channels)
   or reduce, and of the epilogue, its block 0 ``step`` bit for bit;
   these counts are in the ``kernels`` line under ``cells``), the engine's
   ``fir_mode`` is the run's
   (``direct``, ``svd``), the calibration recovered the injected 2 us
   delay within 0.5 sample, the calibrated in-band phase is flat (std <
   0.3 rad, 0.35 under int8) and the CSV loads with the reference recipe;
   then checkpoint/resume through the Correlator (``calibrate_on_start=
   False``) in both ingests at K = 1 and 8: a replay of the CLI's blocks
   run whole, run cut short with ``snapshot_every=2`` and resumed from its
   snapshot with ``resume_from`` over the whole replay, the resumed rows
   within 2e-5 of max|vis| (3e-5 int8) of the whole run's tail;
   then ``bench_pipeline``'s configuration through the Correlator
   (looping replay, CONTINUUM, ``buffer_chunks`` 32) for 4 s at K = 8 and
   at K = 1 in each ingest, counted the same way, under a CUDA-only
   ``torch.profiler`` trace for the device's busy share (the launches
   whose device record the tracer lost counted beside it); every CLI and
   pipeline run must have gone through the native host plane (every ring
   a ``NativeRingBuffer``, a feeder a channel on the zero-copy producer,
   the aligner gathering through views); then the host data plane alone:
   ``bench_host_pipeline``'s configuration (2 channels x 2^21 samples, a
   feeder a channel, both ingests) on the native plane and on Python rings
   with numpy's quantizer, A B B A, 3 s a run (Msamp/s and GB/s, median
   and spread), then each host stage alone on one such block (the
   source's read, the quantize, the ring's ``put`` against ``reserve`` +
   ``commit``, the aligner's views against ``get`` + ``np.stack``, the
   staging copy into pinned memory by torch's ``copy_`` against
   ``np.copyto``, the copy to the card by CUDA events; median of 12 on
   one thread), each reading with the host's CPU, cores, load average and
   torch's threads beside it, on a ``host_plane`` JSON line; then the
   two-pass entries, which the engine no longer calls, as a caller
   composes a step from them (``fx_fused_raw*`` and the plain ``finish``:
   3 blocks one at a time, 2 batches of 8, both ingests, 4 and 32 taps),
   counted the same way and held to the engine's step; then the F-stage
   entry ``spectrometer_fused``, which no main path calls, over 3 chained
   flagship blocks; then the measurement path, ``fxtpu_torch.probes.main``
   for ``ablate`` (flagship and ``bench_pipeline`` blocks at K = 1 and 8 in
   both ingests, the deep-tap block and the wideband shape in both FIR
   modes), ``copy_rate``, ``overlap`` (both copy mechanisms), ``retile``,
   ``breakdown`` (2 x 2^18 and 2 x 2^21 samples) and ``all``, each run
   counted the same way: its own kernel launched, no other;
4. times (CUDA events, median of 2 x n calls after warm-up, in turns): at
   the flagship each direct-loop kernel against its plain version (also
   with 4 channels and autos, 10 pairs), the engine step on either route
   for both ingests, the host-to-device copy of one block (host clock to a synchronize) and the spectrometer
   against its plain version; at the wideband shape the SVD-FIR kernel,
   the direct-loop kernel and both plain versions for each ingest, the
   engine step on either route (the kernel route in the SVD mode) and one
   block's copy; per block, one K = 8 launch against 8 one-block launches
   and the plain version at the flagship and at the CLI's deep-tap block
   (SVD), ``multi_step`` against ``step`` at the flagship, and 8 blocks'
   copy through a pinned buffer on a side stream against 8 pageable
   copies; the single pass against the two-pass form of the fused route
   in one process, in turns (A B B A): ``step`` and ``multi_step`` at the
   flagship and ``step`` at ``bench_pipeline``'s block in both ingests,
   one block's copy pinned (``prepare_block``) against pageable by the
   host's clock and by CUDA events, the device time of each kernel of a
   step, and the device launches of a single-pass step, which fails the
   run when they are more than 3 or the mean pre-pass is among them; at
   8 channels the wide route's wrapper and plain version (nchan8 and the
   8-channel deep block, both ingests), the X kernel alone at the nchan8
   and ``--nchan 8`` CLI blocks against its plain version and one
   ``torch.matmul`` of the spectra (its ``library_ms``), the nchan8 engine
   step on either route, failing the
   run above 4 device launches a wide-route step; the single pass with
   ``x_stage`` "shared" against "global" at the flagship and
   ``bench_pipeline``'s block, both ingests, in turns (A B B A); the parts
   reduce alone at the flagship (K = 1 and 8) and ``bench_pipeline``'s
   block, both ingests, against its plain version and ``torch.sum`` over
   the groups (its ``library_ms``); the step's one C call against the
   two-call step in turns (A B B A) at the flagship (K = 1 and 8), the
   pipeline block, cli8 and nchan8, both ingests: event ms a step, device
   us by kernel, the epilogue's exposed us (its end less its
   predecessor's) and the step's span on the card, failing above 3 device
   launches a step; a flagship step's host time split into checks,
   allocations, ctypes call(s) and the rest (``time.perf_counter``);
   the device launches of one engine step (flagship, and wideband
   in the SVD mode), of one K = 8 ``multi_step`` and of each wrapper alone
   (a CUDA-only profiler trace); the stage table, the
   frame kernel's device time per block after each stage from the
   ``ablate`` runs, with ``torch.fft.fft`` over ``[nch, S, nbins]`` timed
   beside the FFT stages (``library_ms``; the port never calls it on this
   path) and, at the flagship, the FFT stage's own device time (``fft -
   fir``, the radix-16 passes) printed against it.

Every bin count of ``fxtpu``'s kernels (``_kernel_factor``: n = 128 m, 2
<= m <= 128; ROADMAP K.3) runs the same kernels, the FFT through the
frame kernel's mixed-radix body: phase 2 holds the single pass and its
epilogue at 384, 3072, 12,288, 16,256 and 16,384 bins (2 x 2^18 samples, both
ingests; the last three on the wide route) and in the SVD-FIR mode at 6144
bins and 32 taps, to the rules above; K = 8 at 3072 bins against 8
one-block steps (block 0 bit for bit, every block within 1e-5 of
max|vis|, plus what cancels at the DC bin); the step's one C call at 3072
and 16,384; the X kernel alone at 16,256 and 16,384; the spectrometer at
3072 and 16,384; the ablation at 3072 and 16,256 (stages ``fir``,
``fft`` and ``full``).  Phase 3 runs the CLI at ``--resolution 3072``,
``16384`` and ``6144 --ntaps 32`` in both ingests, counted as above, with no
WARNING that the engine took the plain route, and the ablation probe at
3072 and 16,256; phase 4 times the single pass, the spectrometer and the
X kernel there and prints the FFT stage (``fft - fir``) at 3072 and
16,256 bins beside ``torch.fft.fft``.  Snapshot/resume (phase 3) runs
through the Correlator with ``calibrate_on_start=False``.  12,288 bins (the
band plan's third count) joins 384 to 16,384 in phases 2 and 4.

At deep taps (``fx_fused.deep_fir``: 16 taps and more) every entry but the
spectrometer launches the FIR as a kernel of its own, ``fir_rows_kernel``,
before its frame kernel, which then reads one row of its output a frame;
phase 2 holds that launch alone (``fx_fused.fir_rows``) against its plain
version at ``FIR_CASES`` (the deep CLI block at K = 1 and 8, the wideband
block in both FIR modes, 6144 bins at 32 taps, the 8-channel deep block;
both ingests; within ``FIR_TOL`` of max|fir|) and K = 8 at the deep CLI
block against 8 steps; phase 3 counts one FIR launch a block on the deep
CLI runs (``fir_rows`` in ``read_counts``) and on the deep ablation
probes; phase 4 times it at ``FIR_CASES`` against its bound (``fir_bound``)
and its plain version (``fir_rows`` in the kernels line; no single PyTorch
call computes it in this layout, so ``library_ms`` is null).

Scale-out (``fxtpu_torch.parallel``), a phase 3 part of its own, each run
counted alone: the fused frame-sharded step (``SCALE_CASES``: the
flagship in both ingests and the ``--nchan 8`` CLI block on the wide
route) on meshes of 2 x 2 and 4 x 1 shards of the card over 3 chained
blocks with a mean offset, against the single-device fused step (vis
within 2e-5 of max|vis|, 3e-5 under int8; the history within 1e-6, the
int8 tail exact); each block launches the single pass and its reduce (or
X kernel) once a shard and the epilogue once, nothing else; the
block-parallel K = 8 call on 4 shards against 8 single-device steps
(3e-5, history 1e-5), one launch of each a shard; the plain step with
the corner turn on 2 x 2 against the plain single-device step (rtol
5e-4, atol 5e-7), no hand kernel; the collective bytes of each, counted
by ``parallel.collectives``, equal to ``parallel.accounting``'s model;
``python -m fxtpu_torch --mesh_time 2 --mesh_freq 2`` on the card (the
single-device run's CSV header, the delay recovered, 4 single passes and
one epilogue a block), also at ``--blocks_per_dispatch 8``; and ``parallel.multihost.launch(2, "step")``, two
processes of 4 shards each on the card over ``gloo`` (CUDA tensors staged
through pinned host memory, the staged bytes printed), against the
one-process 4 x 2 mesh (rtol 2e-5, atol 2e-4).  The mesh steps and the
K = 8 call are timed by events beside the single-device step's and
call's.  Their launches join the main path's counts in the kernels line,
and ``fx_parts`` carries the phase's record under ``scaleout``.

The scaling bench and the observe example, the last step of phase 3:
``fxtpu_torch.scaling_bench.main`` at the flagship width (2 channels,
4096 bins, 4 taps) and fxtpu's ``--block_pow 21``, the sweep over 1, 2
and 4 shards of the card (2^21 samples a shard, ``BENCH_ITERS`` timed
steps) and ``--multi 8`` on 4 shards; every row's steps launch the single
pass and its reduce once a shard and the epilogue once (the K = 8 call:
the block-parallel path, once a shard each), counted around each run and
added to the kernels line's.  Then ``examples/observe_torch.sh --device
cuda --time 2 --omit_plot``: its CSV loads with the reference recipe and
its logged launches are one single pass and one epilogue a row.  The
rows print on a JSON line of their own (``scaling_bench``, with the card)
before the stage table's.

The bench, after the observe example: ``fxtpu_torch.bench.bench`` (the
port of ``bench.py``) in this process for each of its five
configurations at their full size, the counts set to 0 before and read
after each run: every timed iteration's ceil(K / m) ``multi_step`` calls
(``BENCH_ROUTES``: K blocks capped at what one launch takes) and the
untimed ones launch the configuration's single pass, its reduce or X
kernel, the FIR launch at 32 taps and the epilogue once a call, and
nothing else; each configuration's JSON line prints.  Then ``python -m
fxtpu_torch.bench`` runs in processes of its own: the default
configuration, and ``--pipeline`` and ``--host_pipeline`` in each ingest
at ``--seconds 6`` (bench.py's runs are 12 and 6 s), each exiting 0 with
one line of bench.py's metric, a positive value, no ``error`` and shares
of the card's peaks at most 1.05.  Its record prints on a ``bench`` JSON
line after the scaling bench's.

Every kernel's ``bound_ms`` is computed here from the run's shapes: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its operations over 67 TFLOP/s (float32 outside the tensor
cores; the retile probe's bf16 products summed in float32, the tensor
cores' work, over 989.4 TFLOP/s), the H100's published rates;
``bound_by`` says which.  ``library_ms``
is the time of one PyTorch call that computes the same function, timed
here and used nowhere in the port: ``torch.sum`` over the tiles' words
beside the copy probe's leg of contiguous tiles, ``torch.matmul`` of the
spectra per bin (the Gram ``[nch, S] @ [S, nch]^H``) beside the X kernel,
``torch.sum`` of the partials over the groups beside the parts reduce;
no single call computes what any other kernel here computes (a FIR, an
FFT and products in one pass, or a correction and a rotation), so theirs
is null.

It prints one JSON line of the stage table, one of kernel results (for
the K-block entries every time per block, at K = 8), then, as the last
line, ``{"ok": true, "device": {...}}``.
"""

import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

FLAGSHIP = dict(nch=2, nsamp=2**18, nbins=4096, ntaps=4, autos=False)
SMALL = dict(nch=3, nsamp=32 * 256, nbins=256, ntaps=4, autos=True)
# bench.py's wideband configuration at its full width
WIDEBAND = dict(nch=2, nsamp=2**21, nbins=8192, ntaps=32, autos=False)
SMALL_DEEP = dict(nch=3, nsamp=64 * 256, nbins=256, ntaps=32, autos=True)
# the CLI's block at --resolution 8192 --ntaps 32 (the reference's clamp)
DEEP_CLI = dict(nch=2, nsamp=2**18, nbins=8192, ntaps=32, autos=False)
MULTI_K = 8          # blocks per dispatch of the CLI runs and the pipeline
# bench_pipeline's block: 512 frames in 256 groups of 2 (frames_per_group > 1)
PIPELINE_BLOCK = dict(nch=2, nsamp=2**21, nbins=4096, ntaps=4, autos=False)
# the X stage over many pairs: four channels with autos at the flagship
# width, 10 baselines of spectra that all stay in shared memory
MANY_PAIRS = dict(nch=4, nsamp=2**18, nbins=4096, ntaps=4, autos=True)
# bench.py's nchan8 cell (bench.py:392-393): 8 channels of 2^20 samples at
# 4096 bins with autos (36 baselines); a frame's 8 spectra do not fit in
# one cluster's shared memory, so the single pass takes its wide route (the
# spectra through device memory to the X kernel, fx_xstage.cu)
NCHAN8 = dict(nch=8, nsamp=2**20, nbins=4096, ntaps=4, autos=True)
# the CLI's deep-tap block at --nchan 8 (28 baselines, the SVD-FIR mode)
DEEP8 = dict(nch=8, nsamp=2**18, nbins=8192, ntaps=32, autos=False)
# the CLI's block at --nchan 8 and its defaults (28 baselines, no autos):
# the wide route's shape on the main path
CLI8 = dict(nch=8, nsamp=2**18, nbins=4096, ntaps=4, autos=False)
# fxtpu's most channels (MAX_FUSED_NCHAN = 64; 2080 pairs with autos) at
# a small width: the X kernel's largest tile (128 KiB of shared memory)
WIDE64 = dict(nch=64, nsamp=8 * 256, nbins=256, ntaps=4, autos=True)
WIDE_K = 4           # blocks of the wide route's K-block checks
# (shape, FIR mode, x_stage) of the wide route's checks in phase 2, each
# at K = 1 and WIDE_K: the shapes where it is the only route (the main
# path's among them), and two where the shared route takes the shape too
# and is compared with it
WIDE_CASES = ((NCHAN8, "direct", "auto"), (CLI8, "direct", "auto"),
              (DEEP8, "svd", "auto"), (MANY_PAIRS, "direct", "global"),
              (WIDE64, "direct", "global"))
CLI_NCHAN = 8        # the CLI runs of the wide route (28 baselines)
# MeerKAT's 4k mode (fxbench's meerkat_l4k): 128 channels with autos, 8,256
# pairs of 2^18 samples at 4096 bins, past the shared route's 64 channels:
# 8,512 rows of parts, which the X kernel's register-tiled instance takes
NCHAN128 = dict(nch=128, nsamp=2**18, nbins=4096, ntaps=4, autos=True)
NCHAN128_K = 3       # the most blocks a launch takes there (the scratch)
# LEDA's 512-input correlator (fxbench's leda512): 512 channels with autos,
# 131,328 pairs of 2^18 samples at 4096 bins, one block a launch (K nbl and
# the spectra pass the caps on K): the X kernel's band instance and the
# epilogue's narrow pair-tiled one (16 bins a tile past 433 channels)
NCHAN512 = dict(nch=512, nsamp=2**18, nbins=4096, ntaps=4, autos=True)
FLAGSHIP_K = 64      # the blocks of fxbench's effex2.engine calls
# the most bytes of one gathered [K, pairs, S, nbins] operand of a plain
# version: every pair at once takes 17 GB a block at NCHAN128
PLAIN_TILE_BYTES = 2 << 30
# (cell, the engine's configuration, ingest, the cell's blocks, K of its
# calls, X stage) of the benchmark's engine cells whose calls phase 3 counts
CELL_ENGINES = (
    ("meerkat_l4k.engine128_int8",
     dict(nchan=128, include_autos=True, num_samp=2**18, nbins=4096,
          bandwidth=856e6, frequency=1284e6), "int8", 24, NCHAN128_K,
     "global"),
    ("effex2.engine", dict(), "complex64", 64, FLAGSHIP_K, "shared"),
    ("leda512.engine512_int8",
     dict(nchan=512, include_autos=True, num_samp=2**18, nbins=4096,
          bandwidth=98.304e6, frequency=49.152e6), "int8", 16, 1, "global"))
XSTAGE_SOURCE = "fxtpu_torch/csrc/fx_xstage.cu"
# (shape, K, FIR mode) of the K-block entries' checks in phase 2: every
# shape and K the CLI's main path and phase 4 launch them at, and smaller
# ones (the bench launches the single pass instead: ``bench_cases``)
MULTI_CASES = ((SMALL, 3, "direct"), (FLAGSHIP, MULTI_K, "direct"),
               (PIPELINE_BLOCK, MULTI_K, "direct"), (WIDEBAND, 2, "direct"),
               (SMALL_DEEP, 3, "svd"), (DEEP_CLI, MULTI_K, "svd"),
               (WIDEBAND, 2, "svd"))
# bench.py's bench_pipeline at its defaults, run for PIPELINE_S seconds
PIPELINE = dict(mode="CONTINUUM", nchan=2, num_samp=2**21, nbins=4096,
                buffer_chunks=4 * MULTI_K)
PIPELINE_S = 2.5
CLI_S = 2            # seconds of each CLI run
HBM_BYTES_PER_S = 3.35e12    # the H100's published device-memory rate
FP32_FLOPS = 67e12           # and float32 rate outside the tensor cores
# the H100 SXM5's dense bf16 tensor-core rate (bf16 products, float32 sums)
BF16_TENSOR_FLOPS = 989.4e12
PROBES_SOURCE = "fxtpu_torch/csrc/probes.cu"
SPEC_CASES = (dict(nch=3, nsamp=32 * 256 + 100, nbins=256, ntaps=4),
              dict(nch=3, nsamp=32 * 256, nbins=256, ntaps=1),
              dict(nch=2, nsamp=2**18, nbins=4096, ntaps=4))
REL_TOL = 2e-5       # xp, relative to max|xp_ref| (tests/test_planes.py)
DEEP_TOL = 3e-5      # deep-tap routes against each other (test_planes:485)
SPEC_TOL = 5e-6      # spectra, relative to max|spec_ref| (test_planes:301)
HIST_TOL = 1e-6      # history, absolute
MU_TOL = 1e-6        # int8 mu_prev, relative to max|mu_ref|
STEP = 1.0 / 32      # quant_step of 8-bit samples, the CLI default
TRUE_DELAY = 2e-6    # the delay the CLI runs inject (--true_delay)
SOURCE = "fxtpu_torch/csrc/fx_fused.cu"
# entry -> the TPU kernel (or mode of it) it replaces
REPLACES = {
    "fx_fused": "fxtpu/ops/pfb_pallas.py:468",
    "fx_fused_i8": "fxtpu/ops/pfb_pallas.py:785",
    "fx_fused_svd": "fxtpu/ops/pfb_pallas.py:810",
    "fx_fused_i8_svd": "fxtpu/ops/pfb_pallas.py:831",
    "spectrometer": "fxtpu/ops/pfb_pallas.py:133",
    "fx_fused_multi": "fxtpu/ops/pfb_pallas.py:1669",
    "fx_fused_i8_multi": "fxtpu/ops/pfb_pallas.py:1669",
    "fx_parts": "fxtpu/ops/pfb_pallas.py:993",
    "fx_parts_i8": "fxtpu/ops/pfb_pallas.py:1050",
    "fx_parts_reduce": "fxtpu/ops/pfb_pallas.py:993",
    "fx_parts_wide": "fxtpu/ops/pfb_pallas.py:993",
    "fx_parts_wide_i8": "fxtpu/ops/pfb_pallas.py:1050",
    "fx_xstage": "fxtpu/ops/pfb_pallas.py:1078",
    "fx_finish": "fxtpu/ops/pfb_pallas.py:1501",
    "fx_ablate": "scripts/fused_ablate.py:58",
    "copy_probe": "scripts/dma_width_probe.py:44",
    "overlap_probe": "scripts/dma_overlap_probe.py:154",
    "retile_probe": "scripts/retile_probe.py:51",
    # _fx_kernel's FIR, at deep taps its banded SVD form (:810-869), whose
    # windows of rows are read once
    "fir_rows": "fxtpu/ops/pfb_pallas.py:810",
}
FIR_TOL = 1e-6       # fir_rows against its plain version, of max|fir|

PROBE_KERNELS = ("fx_ablate", "copy_probe", "overlap_probe", "retile_probe")
FINISH_SOURCE = "fxtpu_torch/csrc/fx_finish.cu"
FIN_TOL = 1e-6       # fx_finish, relative to max|vis_ref|, plus
CANCEL_TOL = 2e-6    # this share of the raw cross power that cancels at a
#                      bin (the DC bin's |mu|^2 |Abar(0)|^2 and its leakage)
# (shape, K) of the parts reduce's checks in phase 2 and its times in 4
REDUCE_CASES = (("flagship", FLAGSHIP, 1), ("flagship_k8", FLAGSHIP, MULTI_K),
                ("pipeline", PIPELINE_BLOCK, 1))
# (tag, shape, K, FIR mode, continuum) of the step entry's checks in phase 2
# and its A/B in phase 4: the main path's shapes on both routes
STEP_CASES = (("flagship", FLAGSHIP, 1, "direct", False),
              ("flagship_k8", FLAGSHIP, MULTI_K, "direct", False),
              ("pipeline", PIPELINE_BLOCK, 1, "direct", True),
              ("deep", DEEP_CLI, 1, "svd", False),
              ("cli8", CLI8, 1, "direct", False),
              ("nchan8", NCHAN8, 1, "direct", False),
              ("deep8", DEEP8, 1, "svd", False))
STEP_SOURCE = "fxtpu_torch/csrc/fx_step.cu"
# (shape, K, FIR mode) of the single-pass entries' checks in phase 2
PARTS_CASES = tuple((case, k, "direct") for case in (
    SMALL, FLAGSHIP, PIPELINE_BLOCK, WIDEBAND) for k in (1, MULTI_K)) + tuple(
    (case, k, "svd") for case in (SMALL_DEEP, DEEP_CLI, WIDEBAND)
    for k in (1, MULTI_K))
# Every bin count of fxtpu's kernels (_kernel_factor: n = 128 m, 2 <= m <=
# 128; ROADMAP K.3) at the CLI's block, 2 channels of 2^18 samples: 384
# (682 frames), 3072 (85 frames, 1024 samples a block not framed), 16,256
# = 127 x 128 (16 frames, the largest odd factor) and 16,384 (16 frames,
# the wide route: a spectrum is 128 KiB), and 6144 at 32 taps (42 frames,
# the SVD-FIR mode at rank 6)
R384 = dict(nch=2, nsamp=2**18, nbins=384, ntaps=4, autos=False)
R3072 = dict(nch=2, nsamp=2**18, nbins=3072, ntaps=4, autos=False)
R16256 = dict(nch=2, nsamp=2**18, nbins=16256, ntaps=4, autos=False)
R16384 = dict(nch=2, nsamp=2**18, nbins=16384, ntaps=4, autos=False)
# the band plan's third count (PERF.md section 4): 12,288 = 3 x 4096, the
# wide route (a frame's two spectra take 192 KiB)
R12288 = dict(nch=2, nsamp=2**18, nbins=12288, ntaps=4, autos=False)
R6144D = dict(nch=2, nsamp=2**18, nbins=6144, ntaps=32, autos=False)
# (tag, shape, FIR mode) of the single pass's checks and times at them
BIN_CASES = (("r384", R384, "direct"), ("r3072", R3072, "direct"),
             ("r12288", R12288, "direct"), ("r16256", R16256, "direct"),
             ("r16384", R16384, "direct"), ("r6144d", R6144D, "svd"))
# (tag, shape, K, FIR mode) of the deep-tap FIR launch's checks in phase 2
# and its times in phase 4: the shapes where a step launches it
# (fx_fused.deep_fir), each with the table of its main path's FIR mode
FIR_CASES = (("deep", DEEP_CLI, 1, "svd"),
             ("deep_k8", DEEP_CLI, MULTI_K, "svd"),
             ("wideband", WIDEBAND, 1, "svd"),
             ("wideband_direct", WIDEBAND, 1, "direct"),
             ("r6144d", R6144D, 1, "svd"), ("deep8", DEEP8, 1, "svd"))
# the spectrometer at the same counts
BIN_SPEC_CASES = (dict(nch=2, nsamp=2**18, nbins=3072, ntaps=4),
                  dict(nch=2, nsamp=2**18, nbins=16384, ntaps=4))
# (tag, CLI flags) of the main path's runs at them, each in both ingests
BIN_CLI = (("r3072", ["--resolution", "3072"]),
           ("r16384", ["--resolution", "16384"]),
           ("r6144d", ["--resolution", "6144", "--ntaps", "32"]))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def nvcc_version() -> str:
    from fxtpu_torch.cuda_build import nvcc_path
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def probe_wrappers() -> dict:
    """The measurement path's kernel wrappers by their entry's name."""
    from fxtpu_torch.ops.fx_fused import fx_fused_ablate
    from fxtpu_torch.probes.copy_rate import copy_probe
    from fxtpu_torch.probes.overlap import overlap_probe
    from fxtpu_torch.probes.retile import retile_probe
    return {"fx_ablate": fx_fused_ablate, "copy_probe": copy_probe,
            "overlap_probe": overlap_probe, "retile_probe": retile_probe}


def reset_counts():
    from fxtpu_torch.ops import fx_fused
    from fxtpu_torch.ops.fx_epilogue import fx_finish
    from fxtpu_torch.ops.fx_xstage import fx_xstage
    from fxtpu_torch.ops.spectrometer import spectrometer_fused
    for fn in (fx_fused.fx_fused_raw, fx_fused.fx_fused_raw_i8,
               fx_fused.fx_fused_raw_multi, fx_fused.fx_fused_raw_i8_multi,
               fx_fused.fx_fused_parts, fx_fused.fx_fused_parts_i8):
        fn.launches = fn.svd_launches = 0
    for fn in (fx_fused.fx_fused_parts, fx_fused.fx_fused_parts_i8):
        fn.wide_launches = fn.wide_svd_launches = 0
    spectrometer_fused.launches = fx_finish.launches = fx_finish.tiled = 0
    fx_xstage.launches = fx_fused.parts_reduce.launches = 0
    fx_xstage.ctas = fx_xstage.spectra_reads = fx_xstage.tiled = 0
    fx_fused.fir_rows.launches = 0
    for fn in probe_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    from fxtpu_torch.ops import fx_fused
    from fxtpu_torch.ops.fx_epilogue import fx_finish
    from fxtpu_torch.ops.fx_xstage import fx_xstage
    from fxtpu_torch.ops.spectrometer import spectrometer_fused
    counts = {}
    for name, fn in (("fx_fused", fx_fused.fx_fused_raw),
                     ("fx_fused_i8", fx_fused.fx_fused_raw_i8),
                     ("fx_fused_multi", fx_fused.fx_fused_raw_multi),
                     ("fx_fused_i8_multi", fx_fused.fx_fused_raw_i8_multi),
                     ("fx_parts", fx_fused.fx_fused_parts),
                     ("fx_parts_i8", fx_fused.fx_fused_parts_i8)):
        counts[name] = fn.launches
        counts[name + "_svd"] = fn.svd_launches
    # the single pass's wide route (the X stage through device memory)
    for name, fn in (("fx_parts_wide", fx_fused.fx_fused_parts),
                     ("fx_parts_wide_i8", fx_fused.fx_fused_parts_i8)):
        counts[name] = fn.wide_launches
        counts[name + "_svd"] = fn.wide_svd_launches
    counts["fx_xstage"] = fx_xstage.launches
    counts["fx_parts_reduce"] = fx_fused.parts_reduce.launches
    counts["fx_finish"] = fx_finish.launches
    counts["fir_rows"] = fx_fused.fir_rows.launches
    counts["spectrometer"] = spectrometer_fused.launches
    for name, fn in probe_wrappers().items():
        counts[name] = fn.launches
    return counts


def window_and_fir(case, fir, device):
    """The window as the kernels take it, and the FIR mode's factors
    (None for the direct loop)."""
    import torch

    from fxtpu_torch.ops import pfb_window, svd_tensors
    ntaps, nbins = case["ntaps"], case["nbins"]
    w = pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)
    svd = svd_tensors(w, device) if fir == "svd" else None
    if fir == "svd" and svd is None:
        raise AssertionError(f"the {ntaps}-tap window does not factorise")
    return torch.as_tensor(w, device=device), svd


def make_case(case, rng, device, fir="direct"):
    """Window, FIR factors, pairs and 3 chained blocks of numpy-seeded
    data with a per-channel DC offset (so the mean removal is
    exercised)."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    s = case["nsamp"] // nbins
    w, svd = window_and_fir(case, fir, device)
    pairs = pairs_tensor(baseline_pairs(nch, case["autos"]), nch, device)
    blocks = []
    for _ in range(3):
        x = (rng.normal(size=(nch, s, nbins))
             + 1j * rng.normal(size=(nch, s, nbins))
             + (0.3 - 0.2j) * np.arange(1, nch + 1)[:, None, None])
        blocks.append(torch.as_tensor(x.astype(np.complex64), device=device))
    hist = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64,
                       device=device)
    return w, svd, pairs, blocks, hist


def compare_kernel(case, device, fir):
    """Phase 2 at one shape: returns (max abs err, max rel err) of xp."""
    import torch

    from fxtpu_torch.ops.fx_fused import fx_fused_raw, fx_fused_raw_reference
    w, svd, pairs, blocks, h0 = make_case(case, np.random.default_rng(1234),
                                          device, fir)
    hk = hr = h0
    abs_err = rel_err = 0.0
    for k, x in enumerate(blocks):
        xk, hk = fx_fused_raw(x, hk, w, pairs, svd)
        xr, hr = fx_fused_raw_reference(x, hr, w, pairs, svd)
        torch.cuda.synchronize()
        if not (torch.isfinite(torch.view_as_real(xk)).all()
                and torch.isfinite(torch.view_as_real(hk)).all()):
            raise AssertionError(f"non-finite kernel output at {case}")
        err = (xk - xr).abs().max().item()
        scale = xr.abs().max().item()
        herr = (hk - hr).abs().max().item()
        print(f"  block {k}: max|xp_k - xp_ref| = {err:.6g} "
              f"({err / scale:.3g} of max|xp_ref| = {scale:.6g}), "
              f"history err {herr:.3g}", flush=True)
        if err > REL_TOL * scale or herr > HIST_TOL:
            raise AssertionError(
                f"kernel disagrees with its plain version at {case} ({fir}): "
                f"xp {err / scale:.3g} > {REL_TOL} or history {herr:.3g} "
                f"> {HIST_TOL}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    return abs_err, rel_err


def make_case_i8(case, rng, device, fir="direct"):
    """Window, FIR factors, pairs and 3 chained blocks of 8-bit samples
    [nch, S, nbins, 2] (noise of ~30 quant units plus a DC offset of a
    few quant units per channel), and the fresh raw-tail history."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    s = case["nsamp"] // nbins
    w, svd = window_and_fir(case, fir, device)
    pairs = pairs_tensor(baseline_pairs(nch, case["autos"]), nch, device)
    dc = np.array([3.0, -2.0]) * np.arange(1, nch + 1)[:, None, None, None]
    blocks = [torch.as_tensor(
        np.clip(np.rint(30 * rng.normal(size=(nch, s, nbins, 2)) + dc),
                -127, 127).astype(np.int8), device=device)
        for _ in range(3)]
    hist = {"tail": torch.zeros((nch, ntaps - 1, nbins, 2),
                                dtype=torch.int8, device=device),
            "mu_prev": torch.zeros((nch,), dtype=torch.complex64,
                                   device=device)}
    return w, svd, pairs, blocks, hist


def compare_kernel_i8(case, device, fir):
    """Phase 2 for the int8 kernel at one shape: (max abs err, max rel
    err) of xp."""
    import torch

    from fxtpu_torch.ops.fx_fused import (fx_fused_raw_i8,
                                          fx_fused_raw_i8_reference)
    w, svd, pairs, blocks, h0 = make_case_i8(
        case, np.random.default_rng(4321), device, fir)
    hk = hr = h0
    abs_err = rel_err = 0.0
    for k, x in enumerate(blocks):
        xk, hk = fx_fused_raw_i8(x, hk, w, pairs, STEP, svd)
        xr, hr = fx_fused_raw_i8_reference(x, hr, w, pairs, STEP, svd)
        torch.cuda.synchronize()
        if not (torch.isfinite(torch.view_as_real(xk)).all()
                and torch.isfinite(torch.view_as_real(hk["mu_prev"])).all()):
            raise AssertionError(f"non-finite int8 kernel output at {case}")
        err = (xk - xr).abs().max().item()
        scale = xr.abs().max().item()
        tail_ok = torch.equal(hk["tail"], hr["tail"])
        mu_err = (hk["mu_prev"] - hr["mu_prev"]).abs().max().item()
        mu_scale = hr["mu_prev"].abs().max().item()
        print(f"  block {k}: max|xp_k - xp_ref| = {err:.6g} "
              f"({err / scale:.3g} of max|xp_ref| = {scale:.6g}), tail "
              f"exact {tail_ok}, mu err {mu_err:.3g} of max|mu| "
              f"{mu_scale:.6g}", flush=True)
        if err > REL_TOL * scale or not tail_ok or mu_err > MU_TOL * mu_scale:
            raise AssertionError(
                f"int8 kernel disagrees with its plain version at {case} "
                f"({fir}): xp {err / scale:.3g} > {REL_TOL}, tail exact "
                f"{tail_ok} or mu {mu_err:.3g} > {MU_TOL} * {mu_scale:.3g}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    return abs_err, rel_err


def merged_batch(case, k, rng, device, int8):
    """K blocks of numpy-seeded samples in the merged layout ``[nch, K,
    S, nbins]`` complex64 (int8: ``[nch, K, S, nbins, 2]``), with a DC
    offset that differs per channel and block (so each block's own mean
    matters)."""
    import torch
    nch, nbins = case["nch"], case["nbins"]
    s = case["nsamp"] // nbins
    grade = np.arange(1, nch + 1)[:, None] * np.arange(1, k + 1)[None, :]
    if int8:
        dc = np.array([3.0, -2.0]) * grade[..., None]
        x = np.clip(np.rint(30 * rng.normal(size=(nch, k, s, nbins, 2))
                            + dc[:, :, None, None]), -127, 127)
        return torch.as_tensor(x.astype(np.int8), device=device)
    x = (rng.normal(size=(nch, k, s, nbins))
         + 1j * rng.normal(size=(nch, k, s, nbins))
         + (0.3 - 0.2j) * grade[..., None, None])
    return torch.as_tensor(x.astype(np.complex64), device=device)


def fresh_history(case, device, int8):
    import torch
    nch, ntaps, nbins = case["nch"], case["ntaps"], case["nbins"]
    if int8:
        return {"tail": torch.zeros((nch, ntaps - 1, nbins, 2),
                                    dtype=torch.int8, device=device),
                "mu_prev": torch.zeros((nch,), dtype=torch.complex64,
                                       device=device)}
    return torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64,
                       device=device)


def multi_entries(int8):
    """(K-block wrapper, its plain version, the one-block wrapper)."""
    from fxtpu_torch.ops import fx_fused as ff
    if int8:
        return (ff.fx_fused_raw_i8_multi, ff.fx_fused_raw_i8_multi_reference,
                ff.fx_fused_raw_i8)
    return (ff.fx_fused_raw_multi, ff.fx_fused_raw_multi_reference,
            ff.fx_fused_raw)


def same_history(a, b):
    import torch
    if isinstance(a, dict):
        return all(torch.equal(a[key], b[key]) for key in a)
    return torch.equal(a, b)


def compare_multi(case, k, device, fir, int8):
    """Phase 2 for a K-block entry: two chained K-block launches against
    the plain version (xp within 2e-5 max|xp_ref|, 3e-5 in the SVD mode;
    history as for the one-block entries) and against K chained one-block
    launches, bit for bit.  Returns (max abs err, max rel err) of xp."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    multi, ref, single = multi_entries(int8)
    w, svd = window_and_fir(case, fir, device)
    pairs = pairs_tensor(baseline_pairs(case["nch"], case["autos"]),
                         case["nch"], device)
    arg = (STEP,) if int8 else ()
    tol = DEEP_TOL if fir == "svd" else REL_TOL
    rng = np.random.default_rng(2468)
    hk = hr = hs = fresh_history(case, device, int8)
    abs_err = rel_err = 0.0
    for call in range(2):
        x = merged_batch(case, k, rng, device, int8)
        xk, hk = multi(x, hk, w, pairs, *arg, svd)
        xr, hr = ref(x, hr, w, pairs, *arg, svd)
        xs = []
        for j in range(k):
            xj, hs = single(x[:, j].contiguous(), hs, w, pairs, *arg, svd)
            xs.append(xj)
        torch.cuda.synchronize()
        if not torch.isfinite(torch.view_as_real(xk)).all():
            raise AssertionError(f"non-finite K-block output at {case}")
        err = (xk - xr).abs().max().item()
        scale = xr.abs().max().item()
        if int8:
            mu_err = (hk["mu_prev"] - hr["mu_prev"]).abs().max().item()
            hist_ok = (torch.equal(hk["tail"], hr["tail"]) and mu_err
                       <= MU_TOL * hr["mu_prev"].abs().max().item())
            hdesc = f"tail exact, mu err {mu_err:.3g}" if hist_ok else "bad"
        else:
            herr = (hk - hr).abs().max().item()
            hist_ok = herr <= HIST_TOL
            hdesc = f"history err {herr:.3g}"
        bitwise = (xk.shape == (k, len(pairs), case["nbins"])
                   and torch.equal(xk, torch.stack(xs))
                   and same_history(hk, hs))
        print(f"  call {call} (K={k}): max|xp_k - xp_ref| = {err:.6g} "
              f"({err / scale:.3g} of max|xp_ref| = {scale:.6g}), {hdesc}, "
              f"= {k} one-block launches bit for bit: {bitwise}",
              flush=True)
        if err > tol * scale or not hist_ok or not bitwise:
            raise AssertionError(
                f"K-block entry disagrees at {case}, K={k} ({fir}, int8 "
                f"{int8}): xp {err / scale:.3g} > {tol}, history ok "
                f"{hist_ok}, bit for bit {bitwise}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    return abs_err, rel_err


def raw_history(case, rng, device, int8):
    """A history that is not zero: a DC-corrected complex64 tail, or a
    raw int8 tail with the mean it still carries."""
    import torch
    nch, ntaps, nbins = case["nch"], case["ntaps"], case["nbins"]
    if int8:
        tail = np.clip(np.rint(30 * rng.normal(size=(nch, ntaps - 1, nbins,
                                                     2))), -127, 127)
        mu = 0.05 * (rng.normal(size=nch) + 1j * rng.normal(size=nch))
        return {"tail": torch.as_tensor(tail.astype(np.int8), device=device),
                "mu_prev": torch.as_tensor(mu.astype(np.complex64),
                                           device=device)}
    h = rng.normal(size=(nch, ntaps - 1, nbins, 2)) @ np.array([1.0, 1j])
    return torch.as_tensor(h.astype(np.complex64), device=device)


def parts_batch(case, k, rng, device, int8):
    """K merged blocks for the single pass: noise with a DC offset of a
    few hundredths to a few tenths of its sigma that differs per channel
    and block (a receiver's offset; the post-hoc correction cancels at the
    DC bin, which loses precision as the mean grows).  The channels' grades
    run 1 .. 4 and start again, so that the offsets stay in that range at
    any channel count."""
    import torch
    nch, nbins = case["nch"], case["nbins"]
    s = case["nsamp"] // nbins
    grade = (np.arange(nch) % 4 + 1)[:, None] + 0.5 * np.arange(k)[None, :]
    # the normals drawn on the host, the rest formed on the device in
    # float64 (numpy's sums and roundings, faster at 2 x 22 x 2^21)
    g = torch.as_tensor(rng.normal(size=(nch, k, s, nbins, 2)),
                        device=device)
    if int8:
        dc = torch.as_tensor(np.array([3.0, -2.0])
                             * grade[..., None, None, None], device=device)
        return torch.round(30 * g + dc).clamp_(-127, 127).to(torch.int8)
    off = torch.as_tensor((0.03 - 0.02j) * grade[..., None, None],
                          device=device)
    return (torch.complex(g[..., 0], g[..., 1]) + off).to(torch.complex64)


def by_pair_tiles(fn, args, at, per_pair):
    """``fn(*args)``, a plain version whose pairs are ``args[at]``, with
    the pairs taken in tiles where every pair at once would gather more
    than PLAIN_TILE_BYTES into one operand (``per_pair``: its bytes a
    pair): the first output's pair rows (axis 1) joined in order, the
    other outputs, which do not depend on the pairs, the first tile's."""
    import torch
    pairs = args[at]
    per = max(1, PLAIN_TILE_BYTES // per_pair)
    if len(pairs) <= per:
        return fn(*args)
    outs = [fn(*args[:at], pairs[lo:lo + per], *args[at + 1:])
            for lo in range(0, len(pairs), per)]
    return (torch.cat([o[0] for o in outs], dim=1), *outs[0][1:])


def compare_parts(case, k, device, fir, int8, x_stage="auto"):
    """Phase 2 for the single pass at one shape, K blocks from a carried
    history, on the X stage ``x_stage`` gives (``fx_fused.x_route``: the
    shared-memory route, or the wide route, whose entries are
    ``fx_parts_wide`` / ``fx_parts_wide_i8``): the parts
    (``fx_fused_parts`` / ``fx_fused_parts_i8``) against their plain
    version (on the wide route ``fx_fused_parts_wide_reference``, its
    autos' imaginary parts exactly 0, and where the shared route takes the
    shape too, against its kernels within 2e-6 of scale, bit equality
    reported): xp_raw and T within 2e-5 (3e-5 for
    8-bit samples and deep taps) of their scale off the DC bin and at it
    (the raw DC bin towers above the rest, so each is held on its own
    scale), GJ on one scale, mu and the complex64 tail within 1e-6, the
    int8 tail exact; then the epilogue (``fx_finish``) on the kernel's
    parts against ``dc_correct`` + ``finish`` for packed and plain delays,
    spectra and continuum (continuum refused, ValueError, where K nbl
    passes ``fx_epilogue.MAX_FINISH_ROWS``: LEDA's 131,328 pairs at one
    block): every bin within 1e-6 of max|vis| plus 2e-6
    of the raw cross power per frame that cancels at that bin (the DC bin
    and, for large means, its neighbours); then the corrected cross power
    against the two-pass plain version, at the kernels' tolerance plus the
    same allowance for what cancels.  Returns {entry: (max abs err, max
    rel err)} for the parts entry and ``fx_finish``, and the largest
    DC-bin error seen, relative to max|vis|."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.ops.dc_posthoc import (block_mu_prev, dc_constants,
                                            dc_correct)
    from fxtpu_torch.ops.xengine import pack_delays
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    s = case["nsamp"] // nbins
    w, svd = window_and_fir(case, fir, device)
    pairs_np = baseline_pairs(nch, case["autos"])
    pairs = pairs_tensor(pairs_np, nch, device)
    consts = dc_constants(w.cpu().numpy(), nbins, s, device, svd)
    rng = np.random.default_rng(1357)
    x = parts_batch(case, k, rng, device, int8)
    hist = raw_history(case, rng, device, int8)
    deep = int8 or ntaps >= 16
    tol = DEEP_TOL if deep else REL_TOL
    rank = 0 if svd is None else svd[0].shape[1]
    wide = ff.x_route(nbins, ntaps, nch, rank, x_stage) == "global"
    if int8:
        args = (x, hist["tail"], w, pairs, STEP, svd, consts)
        entry = ff.fx_fused_parts_i8
        ref = (ff.fx_fused_parts_i8_wide_reference if wide
               else ff.fx_fused_parts_i8_reference)
        mu_prev = hist["mu_prev"]
    else:
        args = (x, hist, w, pairs, svd, consts)
        entry = ff.fx_fused_parts
        ref = (ff.fx_fused_parts_wide_reference if wide
               else ff.fx_fused_parts_reference)
        mu_prev = None
    got = entry(*args, x_stage=x_stage)
    want = by_pair_tiles(ref, args, 3, k * s * nbins * 8)
    torch.cuda.synchronize()
    abs_err = rel_err = 0.0
    notes = []
    for name, g, r in zip(("xp", "T", "GJ"), got, want):
        if not torch.isfinite(torch.view_as_real(g)).all():
            raise AssertionError(f"non-finite {name} at {case}")
        regions = ((slice(None),) if name == "GJ"
                   else (slice(1, None), slice(0, 1)))
        for sl in regions:
            err = (g[..., sl] - r[..., sl]).abs().max().item()
            scale = r[..., sl].abs().max().item()
            if not err <= tol * scale:
                raise AssertionError(
                    f"{name} of the single pass disagrees with its plain "
                    f"version at {case} K={k} ({fir}, int8 {int8}): "
                    f"{err / scale:.3g} > {tol}")
            abs_err, rel_err = max(abs_err, err), max(rel_err, err / scale)
        notes.append(f"{name} {err / scale:.2g}")
    if wide:
        autos = pairs[:, 0] == pairs[:, 1]
        if bool(autos.any()) and bool((got[0][:, autos].imag != 0).any()):
            raise AssertionError(f"the wide route's autos have an "
                                 f"imaginary part at {case} K={k}")
        if ff.supported(nbins, ntaps, nch, rank):
            shared = entry(*args, x_stage="shared")
            torch.cuda.synchronize()
            same = []
            for name, g, r in zip(("xp", "T", "GJ"), got, shared):
                for sl in (slice(1, None), slice(0, 1)):
                    err = (g[..., sl] - r[..., sl]).abs().max().item()
                    scale = r[..., sl].abs().max().item()
                    if not err <= 2e-6 * scale:
                        raise AssertionError(
                            f"{name} of the wide route disagrees with the "
                            f"shared route at {case} K={k}: "
                            f"{err / scale:.3g} > 2e-6")
                cross = ~autos if name == "xp" else slice(None)
                equal = torch.equal(g[:, cross], r[:, cross])
                same.append(f"{name} {bool(equal)}")
            same.append(f"mu {bool(torch.equal(got[3], shared[3]))}, tail "
                        f"{bool(torch.equal(got[4], shared[4]))}")
            notes.append("= shared route bit for bit (cross pairs): "
                         + ", ".join(same))
    mu_err = (got[3] - want[3]).abs().max().item()
    if int8:
        hist_ok = torch.equal(got[4], want[4])
    else:
        hist_ok = (got[4] - want[4]).abs().max().item() <= HIST_TOL
    if not (mu_err <= MU_TOL * max(1.0, want[3].abs().max().item())
            and hist_ok):
        raise AssertionError(f"mu ({mu_err:.3g}) or the new history of the "
                             f"single pass is wrong at {case} K={k}")
    del want
    # the epilogue on the kernel's parts
    bw, freq = 2.4e6, 1.4204e9
    tables = fe.FinishTables(pairs_np, nbins, bw, freq, device)
    d = (np.tile(np.arange(nch) * TRUE_DELAY, (k, 1))
         + 1e-7 * np.arange(k)[:, None])
    # what cancels at each bin: the raw cross power, per frame (the DC bin's
    # |mu|^2 |Abar(0)|^2 and what the window leaks of it into its neighbours)
    raw = got[0].abs() / s
    raw_dc = raw.max().item()
    raw_shifted = torch.fft.fftshift(raw, dim=-1)
    fin_abs = fin_rel = dc_rel = cont_rel = 0.0
    refused = k * len(pairs_np) > fe.MAX_FINISH_ROWS
    for packed in (True, False):
        delays = torch.as_tensor(
            pack_delays(d, freq) if packed else d.astype(np.float32),
            device=device)
        for continuum in (False, True):
            if continuum and refused:
                try:
                    fe.fx_finish(*got[:4], pairs, consts, delays, tables, s,
                                 bw, continuum, mu_prev)
                except ValueError:
                    continue
                raise AssertionError(
                    f"fx_finish took CONTINUUM at {case} K={k}: "
                    f"{k * len(pairs_np)} rows, past MAX_FINISH_ROWS")
            v = fe.fx_finish(*got[:4], pairs, consts, delays, tables, s, bw,
                             continuum, mu_prev)
            r = fe.fx_finish_reference(*got[:4], pairs, consts, delays,
                                       tables, s, bw, continuum, mu_prev)
            torch.cuda.synchronize()
            scale = r.abs().max().item()
            err = (v - r).abs()
            if continuum:
                bound = FIN_TOL * scale + CANCEL_TOL * raw.mean(dim=-1) / bw
            else:
                bound = FIN_TOL * scale + CANCEL_TOL * raw_shifted
            if v.shape != r.shape or not bool((err <= bound).all()):
                raise AssertionError(
                    f"fx_finish disagrees with its plain version at {case} "
                    f"K={k} (packed {packed}, continuum {continuum}): "
                    f"{(err / bound).max().item():.3g} of its bound, "
                    f"{FIN_TOL} * max|vis| + {CANCEL_TOL} * raw cross power "
                    "per frame")
            if continuum:       # every bin's share, the DC bin's too
                cont_rel = max(cont_rel, err.max().item() / scale)
                continue
            # the five bins around DC are reported apart
            around = slice(nbins // 2 - 2, nbins // 2 + 3)
            dc_rel = max(dc_rel, err[..., around].max().item() / scale)
            err[..., around] = 0
            worst = err.max().item()
            fin_abs, fin_rel = max(fin_abs, worst), max(fin_rel, worst / scale)
            del v, r, err, bound
    # the single pass against the two-pass plain version, off the DC bin,
    # a tile of pairs at a time (at once, its operands and the correction's
    # terms would hold several [K, nbl, nbins] tensors: 4.3 GB each at 512
    # channels); every bin within tol of max|xp| plus CANCEL_TOL of the raw
    # cross power: max(err - CANCEL_TOL |raw|) <= tol * scale
    del raw, raw_shifted
    torch.cuda.empty_cache()
    mu_blocks = block_mu_prev(got[3], mu_prev)
    per = max(1, PLAIN_TILE_BYTES // (s * nbins * 8))
    scale = dc_abs = off_abs = excess = 0.0
    for lo in range(0, len(pairs), per):
        tile = slice(lo, lo + per)
        xp = dc_correct(got[0][:, tile], *got[1:4], pairs[tile], consts,
                        mu_prev=mu_blocks)
        if int8:
            ref, _ = ff.fx_fused_raw_i8_multi_reference(
                x, hist, w, pairs[tile], STEP, svd)
        else:
            ref, _ = ff.fx_fused_raw_multi_reference(x, hist, w,
                                                     pairs[tile], svd)
        err = (xp - ref).abs()
        scale = max(scale, ref.abs().max().item())
        dc_abs = max(dc_abs, err[..., 0].max().item())
        off_abs = max(off_abs, err[..., 1:].max().item())
        excess = max(excess, (err - CANCEL_TOL * got[0][:, tile].abs())
                     .max().item())
        del xp, ref, err
    two_dc, two_off = dc_abs / scale, off_abs / scale
    if not excess <= tol * scale:
        raise AssertionError(
            f"the corrected single pass disagrees with the two-pass plain "
            f"version at {case} K={k}: {two_off:.3g} of max|xp| off the DC "
            f"bin, {two_dc:.3g} at it; bound {tol} * max|xp| + {CANCEL_TOL} * "
            "the raw cross power")
    print(f"  K={k}: " + ", ".join(notes) + f", mu {mu_err:.2g}; fx_finish "
          f"{fin_rel:.2g} of max|vis| (5 bins around DC {dc_rel:.2g}, "
          f"continuum {'refused' if refused else f'{cont_rel:.2g}'}, raw DC "
          f"bin {raw_dc / scale * s:.3g} of max|xp|); against the two-pass "
          f"plain version {two_off:.2g} off DC, DC bin {two_dc:.2g}",
          flush=True)
    name = ("fx_parts_wide" if wide else "fx_parts") + (
        "_i8" if int8 else "")
    return ({name: (abs_err, rel_err), "fx_finish": (fin_abs, fin_rel)},
            max(dc_rel, two_dc))


def step_inputs(case, k, fir, int8, packed, continuum, device, seed=2468):
    """One single-pass step's arguments at ``case`` over K blocks, in
    ``ops.fx_epilogue.fx_fused_step``'s order: merged blocks with DC
    offsets (``parts_batch``) behind a carried history that is not zero
    (``raw_history``), the window and its FIR factors, pairs, the window's
    constants, per-block delays (packed or plain), the epilogue's tables,
    the bandwidth, the mode and, for 8-bit samples, the quantisation
    step."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops.dc_posthoc import dc_constants
    nch, nbins = case["nch"], case["nbins"]
    s = case["nsamp"] // nbins
    w, svd = window_and_fir(case, fir, device)
    pairs_np = baseline_pairs(nch, case["autos"])
    rng = np.random.default_rng(seed)
    x = parts_batch(case, k, rng, device, int8)
    hist = raw_history(case, rng, device, int8)
    bw, freq = 2.4e6, 1.4204e9
    return (x, hist, w, pairs_tensor(pairs_np, nch, device),
            dc_constants(w.cpu().numpy(), nbins, s, device, svd),
            step_delays(nch, k, packed, freq, device),
            fe.FinishTables(pairs_np, nbins, bw, freq, device), bw,
            continuum, STEP if int8 else None, svd)


def step_delays(nch, k, packed, freq, device):
    """Per-block delays ``[K, nch]`` of ``step_inputs``: packed or plain."""
    import torch

    from fxtpu_torch.ops.xengine import pack_delays
    d = (np.tile(np.arange(nch) * TRUE_DELAY, (k, 1))
         + 1e-7 * np.arange(k)[:, None])
    return torch.as_tensor(pack_delays(d, freq) if packed
                           else d.astype(np.float32), device=device)


def two_call_step(args):
    """The step as the parent tree's ``fx_fused_step`` formed it: the
    single pass's wrapper (``fx_fused_parts`` / ``_i8``: frames and reduce,
    or on the wide route frames and the X kernel, in one or two C calls),
    then ``fx_finish`` in a call of its own -> (vis, mu, new history,
    parts (xp, T, GJ))."""
    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops import fx_fused as ff
    x, hist, w, pairs, consts, delays, tables, bw, cont, step, svd = args
    if step is not None:
        xp, t, gj, mu, new = ff.fx_fused_parts_i8(x, hist["tail"], w, pairs,
                                                  step, svd, consts)
        mu_prev = hist["mu_prev"]
    else:
        xp, t, gj, mu, new = ff.fx_fused_parts(x, hist, w, pairs, svd, consts)
        mu_prev = None
    vis = fe.fx_finish(xp, t, gj, mu, pairs, consts, delays, tables,
                       x.shape[2], bw, cont, mu_prev)
    return vis, mu, new, (xp, t, gj)


def one_call_step(args, pool=None):
    """The step through its one C call (``fxt_fx_step`` / ``_i8``), by
    the pieces ``fx_fused_step`` is made of -> its buffers (``vis``,
    ``mu``, ``new_hist``, ``parts``, ...)."""
    from fxtpu_torch.ops import fx_epilogue as fe
    plan = fe.check_step(*args)
    bufs = fe.step_buffers(plan, pool)
    fe.launch_step(plan, bufs)
    bufs["plan"] = plan
    return bufs


def compare_step(case, k, fir, continuum, device, ingests=(False, True)):
    """Phase 2 for the step entry at one shape, K blocks, in the ingests
    ``ingests`` gives (int8 or not; both by default) with packed and plain
    delays: its vis, mu and new history against the
    two-call form's (``two_call_step``) bit for bit (largest difference
    0); ``fx_fused_step``'s outputs the same as the pieces'; its vis
    against the plain epilogue (``fx_finish_reference``) over its own
    parts, every bin within FIN_TOL of max|vis| plus CANCEL_TOL of the raw
    cross power per frame (phase 2's rule for ``fx_finish``), and its
    parts against the plain single pass (the wide route's plain version
    where it takes that route) within 2e-5 (3e-5: 8-bit samples, deep
    taps) of their scale off the DC bin and at it.  Returns (largest
    difference from the two-call form, largest error against the plain
    epilogue relative to max|vis|, route)."""
    import torch

    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops import fx_fused as ff
    diff = fin_rel = 0.0
    route = None
    for int8 in ingests:
        base = step_inputs(case, k, fir, int8, True, continuum, device)
        for packed in (True, False):
            # the same samples and history (copies) under each delay form
            args = (base[0].clone(),
                    ({n: v.clone() for n, v in base[1].items()} if int8
                     else base[1].clone()), *base[2:5],
                    base[5] if packed else step_delays(
                        case["nch"], k, False, 1.4204e9, device), *base[6:])
            x, hist, w, pairs, consts, delays, tables, bw, cont, step, svd = (
                args)
            vis_o, mu_o, new_o, _ = two_call_step(args)
            bufs = one_call_step(args)
            vis_w, new_w = fe.fx_fused_step(*args, pool={})
            torch.cuda.synchronize()
            plan = bufs["plan"]
            route = plan.route
            vis, mu, new = bufs["vis"], bufs["mu"], bufs["new_hist"]
            d = (vis - vis_o).abs().max().item()
            diff = max(diff, d)
            new_w = new_w["tail"] if int8 else new_w
            if not (d == 0 and torch.equal(vis, vis_o)
                    and torch.equal(mu, mu_o) and torch.equal(new, new_o)
                    and torch.equal(vis_w, vis) and torch.equal(new_w, new)):
                raise AssertionError(
                    f"the step entry is not the two-call step bit for bit at "
                    f"{case} K={k} ({fir}, int8 {int8}, packed {packed}): "
                    f"largest vis difference {d}, mu equal "
                    f"{torch.equal(mu, mu_o)}, history equal "
                    f"{torch.equal(new, new_o)}")
            nbl, nch = plan.nbl, plan.nch
            parts = bufs["parts"]
            xp, t, gj = parts[:, :nbl], parts[:, nbl:nbl + nch], parts[
                :, nbl + nch:]
            mu_prev = hist["mu_prev"] if int8 else None
            s = x.shape[2]
            r = fe.fx_finish_reference(xp, t, gj, mu, pairs, consts, delays,
                                       tables, s, bw, cont, mu_prev)
            raw = xp.abs() / s
            scale = r.abs().max().item()
            bound = FIN_TOL * scale + CANCEL_TOL * (
                raw.mean(dim=-1) / bw if cont
                else torch.fft.fftshift(raw, dim=-1))
            err = (vis - r).abs()
            if vis.shape != r.shape or not bool((err <= bound).all()):
                raise AssertionError(
                    f"the step entry's vis disagrees with the plain epilogue "
                    f"at {case} K={k} ({fir}, int8 {int8}, packed {packed}): "
                    f"{(err / bound).max().item():.3g} of its bound")
            fin_rel = max(fin_rel, err.max().item() / scale)
            wide = route == "global"
            per_pair = k * s * case["nbins"] * 8
            if int8:
                ref = by_pair_tiles(
                    ff.fx_fused_parts_i8_wide_reference if wide
                    else ff.fx_fused_parts_i8_reference,
                    (x, hist["tail"], w, pairs, step, svd, consts), 3,
                    per_pair)
            else:
                ref = by_pair_tiles(
                    ff.fx_fused_parts_wide_reference if wide
                    else ff.fx_fused_parts_reference,
                    (x, hist, w, pairs, svd, consts), 3, per_pair)
            tol = DEEP_TOL if (int8 or case["ntaps"] >= 16) else REL_TOL
            for name, g, want in zip(("xp", "T", "GJ"), (xp, t, gj), ref):
                for sl in ((slice(None),) if name == "GJ"
                           else (slice(1, None), slice(0, 1))):
                    e = (g[..., sl] - want[..., sl]).abs().max().item()
                    sc = want[..., sl].abs().max().item()
                    if not e <= tol * sc:
                        raise AssertionError(
                            f"the step entry's {name} disagrees with the "
                            f"plain single pass at {case} K={k} ({fir}, int8 "
                            f"{int8}): {e / sc:.3g} > {tol}")
            del args, bufs, vis_o, mu_o, new_o, ref
        del base
    print(f"  fx_step K={k} ({fir}, {route} route, "
          f"{'continuum' if continuum else 'spectra'}) shape {case}: largest "
          f"difference from the two-call step {diff}, against the plain "
          f"epilogue {fin_rel:.2g} of max|vis|", flush=True)
    return diff, fin_rel, route


def xstage_inputs(case, k, device):
    """The X kernel's inputs at ``case``: the spectra ``[K, nch, S,
    nbins]`` of K raw blocks from a carried history (plain torch), the
    pairs and the window's dA."""
    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.ops.dc_posthoc import dc_constants
    nch, nbins = case["nch"], case["nbins"]
    s = case["nsamp"] // nbins
    w, _ = window_and_fir(case, "direct", device)
    pairs = pairs_tensor(baseline_pairs(nch, case["autos"]), nch, device)
    da = dc_constants(w.cpu().numpy(), nbins, s, device)[1]
    rng = np.random.default_rng(2024)
    x = parts_batch(case, k, rng, device, False)
    hist = raw_history(case, rng, device, False)
    spec = ff._raw_spectra(x.reshape(nch, k * s, nbins), hist, x.shape, w,
                           None)
    return spec.transpose(0, 1).contiguous(), pairs, da


def compare_xstage(case, k, device):
    """Phase 2 for the X kernel alone (``fx_xstage``): K blocks' spectra
    through the kernel against its plain version, the cross power, T and
    GJ each within 2e-5 of its own scale, the autos' imaginary parts
    exactly 0, and the instance the plan names launched (from
    ``XSTAGE_TILED_NCH`` channels, MeerKAT's 128 among them, the
    register-tiled one, counted on ``fx_xstage.tiled``).  Returns (max
    abs err, max rel err)."""
    import torch

    from fxtpu_torch.ops.fx_xstage import (XSTAGE_TILED_NCH, fx_xstage,
                                           fx_xstage_reference)
    spec, pairs, da = xstage_inputs(case, k, device)
    tiled = fx_xstage.tiled
    got = fx_xstage(spec, pairs, da)
    tiled = fx_xstage.tiled - tiled
    if tiled != int(case["nch"] >= XSTAGE_TILED_NCH):
        raise AssertionError(f"fx_xstage at {case} K={k}: {tiled} launches "
                             f"of the tiled instance")
    nbl, nch = pairs.shape[0], case["nch"]

    def plain(spec, p, da):         # (the pairs' rows, T and GJ)
        parts = fx_xstage_reference(spec, p, da)
        return parts[:, :len(p)], parts[:, len(p):]

    want = torch.cat(by_pair_tiles(plain, (spec, pairs, da), 1,
                                   spec[:, 0].numel() * 8), dim=1)
    torch.cuda.synchronize()
    abs_err = rel_err = 0.0
    notes = []
    for name, rows in (("xp", slice(0, nbl)), ("T", slice(nbl, nbl + nch)),
                       ("GJ", slice(nbl + nch, None))):
        err = (got[:, rows] - want[:, rows]).abs().max().item()
        scale = want[:, rows].abs().max().item()
        if not (torch.isfinite(torch.view_as_real(got[:, rows])).all()
                and err <= REL_TOL * scale):
            raise AssertionError(
                f"fx_xstage {name} disagrees with its plain version at "
                f"{case} K={k}: {err / scale:.3g} > {REL_TOL}")
        abs_err, rel_err = max(abs_err, err), max(rel_err, err / scale)
        notes.append(f"{name} {err / scale:.2g}")
    autos = pairs[:, 0] == pairs[:, 1]
    if bool((got[:, :nbl][:, autos].imag != 0).any()):
        raise AssertionError(f"fx_xstage autos have an imaginary part at "
                             f"{case} K={k}")
    print(f"  fx_xstage K={k} ({'tiled' if tiled else 'row'} instance, "
          f"{case['nch']} channels): " + ", ".join(notes) + " of scale; "
          "autos' imaginary parts 0", flush=True)
    return abs_err, rel_err


def shared_plan(case):
    """The single pass's plan of one block of ``case`` on the shared route
    (``fx_fused.plan_parts`` over meta tensors: the shapes alone, no
    memory)."""
    import torch

    from fxtpu_torch.ops import baseline_pairs
    from fxtpu_torch.ops import fx_fused as ff
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    meta = dict(device="meta", dtype=torch.complex64)
    pairs = baseline_pairs(nch, case.get("autos", False))
    return ff.plan_parts(
        torch.empty((nch, 1, case["nsamp"] // nbins, nbins), **meta),
        torch.empty((nch, ntaps - 1, nbins), **meta),
        torch.empty((ntaps, nbins), device="meta"),
        ff.pairs_tensor(pairs, nch, "meta"), None,
        (None, torch.empty((ntaps - 1, nbins), **meta)), None, "shared")


def reduce_inputs(case, k, int8, device, seed=31):
    """The parts reduce's operands at ``case``, K blocks: the step's
    samples, per-group partials ``[K, n_groups, nbl + 2 nch, nbins]`` of
    unit noise (the reduce's function does not depend on where they came
    from; the single pass's plan, ``shared_plan``, splits the block as
    the frame kernel does) and each group's sample sums formed from the
    samples (double; exact integers for 8-bit ones).  Returns (partial,
    sums, x, n_gj, halo)."""
    import torch

    nch, nbins, halo = case["nch"], case["nbins"], case["ntaps"] - 1
    plan = shared_plan(case)
    nbl, n_groups, per = plan.nbl, plan.n_groups, plan.per
    x = parts_batch(case, k, np.random.default_rng(seed), device, int8)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    partial = torch.randn((k, n_groups, nbl + 2 * nch, nbins),
                          dtype=torch.complex64, device=device, generator=gen)
    xs = x.long() if int8 else torch.view_as_real(x).double()
    sums = torch.stack([xs[:, :, g * per:(g + 1) * per].sum(dim=(2, 3))
                        for g in range(n_groups)], dim=2)
    return (partial, sums.permute(1, 2, 0, 3).contiguous(), x,
            min(n_groups, -(-halo // per)), halo)


def compare_reduce(case, k, device, int8):
    """Phase 2 for the parts reduce alone (``fx_parts_reduce``:
    ``ops.fx_fused.parts_reduce``) at one shape and K: parts, mu and the
    new history each equal to its plain version's bit for bit (the same
    float32 and double additions in the same order).  Returns (max abs
    err, max rel err), both 0 when it passes."""
    import torch

    from fxtpu_torch.ops import fx_fused as ff
    partial, sums, x, n_gj, halo = reduce_inputs(case, k, int8, device)
    step = STEP if int8 else None
    got = ff.parts_reduce(partial, sums, x, n_gj, halo, step)
    want = ff.parts_reduce_reference(partial, sums, x, n_gj, halo, step)
    torch.cuda.synchronize()
    for name, g, w in zip(("parts", "mu", "history"), got, want):
        if not torch.equal(g, w):
            err = (g.float() - w.float()).abs().max().item() if g.dtype == (
                torch.int8) else (g - w).abs().max().item()
            raise AssertionError(f"fx_parts_reduce {name} is not its plain "
                                 f"version's bit for bit at {case} K={k} "
                                 f"int8={int8}: max diff {err:.3g}")
    print(f"  fx_parts_reduce K={k} int8={int8} ({partial.shape[1]} groups, "
          f"GJ over {n_gj}): parts, mu and history bit-equal to the plain "
          "version", flush=True)
    return 0.0, 0.0


def parts_reduce_bound(case, k, int8=False):
    """The least time the card could take for one parts reduce over k
    blocks of ``case``: its bytes, each read or written once (the xp and T
    rows of every group's partial, the GJ rows of the first n_gj groups,
    the groups' sample sums, the last block's halo rows in and the new
    history out, the parts and mu out) over the device-memory rate, or its
    float32 additions (2 per element and group after the first) over the
    float32 rate.  Returns (ms, "bytes" or "operations")."""
    nch, nbins, halo = case["nch"], case["nbins"], case["ntaps"] - 1
    plan = shared_plan(case)
    nbl, n_groups, per = plan.nbl, plan.n_groups, plan.per
    n_gj = min(n_groups, -(-halo // per))
    sample = 2 if int8 else 8
    nbytes = (8 * k * nbins * ((nbl + nch) * n_groups + nch * n_gj)
              + 16 * k * n_groups * nch + 2 * sample * nch * halo * nbins
              + 8 * k * (nbl + 2 * nch) * nbins + 8 * k * nch)
    flops = 2 * k * nbins * ((nbl + nch) * (n_groups - 1)
                             + nch * (n_gj - 1))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def time_reduce(device):
    """Phase 4, the parts reduce alone at each of REDUCE_CASES in both
    ingests: the kernel, its plain version and ``torch.sum(partial,
    dim=1)`` (its ``library_ms``: the same sums over the groups, the GJ
    rows of every group where the kernel sums n_gj; the port never calls
    it) by CUDA events, in turns, and the device us of the kernel and of
    ``torch.sum`` (the profiler's).  Returns (times ms, device us), keyed
    ``<shape>[_i8]`` with ``plain_`` and ``library_`` beside the
    kernel's."""
    import torch

    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.probes.common import device_events
    fns, dev_us, keep = {}, {}, []
    for tag, case, k in REDUCE_CASES:
        for int8 in (False, True):
            key = tag + ("_i8" if int8 else "")
            args = (*reduce_inputs(case, k, int8, device),
                    STEP if int8 else None)
            keep.append(args)
            fns[key] = lambda a=args: ff.parts_reduce(*a)
            fns["plain_" + key] = lambda a=args: ff.parts_reduce_reference(*a)
            if not int8:
                fns["library_" + tag] = (
                    lambda p=args[0]: torch.sum(p, dim=1))
                dev_us["library_" + tag] = kernel_us(device_events(
                    fns["library_" + tag], 3)).get("other")
            fns[key]()
            torch.cuda.synchronize()
            dev_us[key] = kernel_us(device_events(fns[key], 3)).get("reduce")
    times = cuda_times(fns, n=20, warm=3)
    del keep
    return times, dev_us


def make_spec_case(case, rng, device):
    """Window and 3 blocks [nch, nsamp] (nsamp need not be a multiple of
    nbins) with a DC offset per channel, and the fresh history."""
    import torch
    nch, nsamp = case["nch"], case["nsamp"]
    w, _ = window_and_fir(case, "direct", device)
    blocks = [torch.as_tensor(
        (rng.normal(size=(nch, nsamp)) + 1j * rng.normal(size=(nch, nsamp))
         + (0.3 - 0.2j) * np.arange(1, nch + 1)[:, None]
         ).astype(np.complex64), device=device) for _ in range(3)]
    hist = torch.zeros((nch, case["ntaps"] - 1, case["nbins"]),
                       dtype=torch.complex64, device=device)
    return w, blocks, hist


def compare_spectrometer(case, device):
    """Phase 2 for the spectrometer: (max abs err, max rel err) of the
    spectra over 3 chained blocks."""
    import torch

    from fxtpu_torch.ops.spectrometer import (spectrometer_fused,
                                              spectrometer_fused_reference)
    w, blocks, h0 = make_spec_case(case, np.random.default_rng(5678), device)
    nbins = case["nbins"]
    hk = hr = h0
    abs_err = rel_err = 0.0
    for k, x in enumerate(blocks):
        sk, hk = spectrometer_fused(x, w, nbins, hk)
        sr, hr = spectrometer_fused_reference(x, w, nbins, hr)
        torch.cuda.synchronize()
        if not torch.isfinite(torch.view_as_real(sk)).all():
            raise AssertionError(f"non-finite spectra at {case}")
        if sk.shape != sr.shape or hk.shape != hr.shape:
            raise AssertionError(f"shapes {tuple(sk.shape)}, "
                                 f"{tuple(hk.shape)} at {case}")
        err = (sk - sr).abs().max().item()
        scale = sr.abs().max().item()
        herr = (hk - hr).abs().max().item() if hk.numel() else 0.0
        print(f"  block {k}: max|spec_k - spec_ref| = {err:.6g} "
              f"({err / scale:.3g} of max|spec_ref| = {scale:.6g}), "
              f"history err {herr:.3g}", flush=True)
        if err > SPEC_TOL * scale or herr > HIST_TOL:
            raise AssertionError(
                f"spectrometer disagrees with its plain version at {case}: "
                f"{err / scale:.3g} > {SPEC_TOL} or history {herr:.3g} > "
                f"{HIST_TOL}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    return abs_err, rel_err


def run_cli(tmpdir, name, ingest, extra=()):
    """``fxtpu_torch.cli.main`` for CLI_S s on the card with every launch
    count set to 0 just before and read just after -> (Correlator, CSV
    path, counts)."""
    from fxtpu_torch.cli import main as cli_main
    out = os.path.join(tmpdir, f"vis_{name}.csv")
    reset_counts()
    cor = cli_main(["--time", str(CLI_S), "--mode", "spectrum",
                    "--true_delay",
                    str(TRUE_DELAY), "--ingest", ingest, "--no_keyboard",
                    "--omit_plot", "--output", out, "--device", "cuda",
                    *extra])
    counts = read_counts()
    eng = cor.engine
    print(f"  blocks processed {cor.blocks_processed}, launches {counts}, "
          f"kernel_active {eng.kernel_active}, int8_native "
          f"{eng.int8_native}, fir_mode {eng.fir_mode}, staged "
          f"{cor.stager is not None}, rings {cor.bufs[0].dtype} "
          f"{cor.bufs[0].block_shape}, nbins {cor.config.nbins}, ntaps "
          f"{cor.config.ntaps}", flush=True)
    if not eng.kernel_active or eng.int8_native != (ingest == "int8"):
        raise AssertionError("the CLI run did not take the kernel route")
    if ingest == "int8" and not (
            cor.bufs[0].dtype == np.int8
            and cor.bufs[0].block_shape == (cor.config.num_samp, 2)):
        raise AssertionError("the int8 run's rings are not int8")
    host_plane_state(cor, name)
    return cor, out, counts


def check_products(cor, out, name):
    """The CLI run's science: the calibration recovered the injected
    delay, the CSV loads with the reference recipe, one finite row per
    block, and the calibrated in-band phase is flat."""
    from fxtpu_torch.products import load_products
    cfg = cor.config
    int8 = cfg.ingest_dtype == "int8"
    nbl = cfg.n_baselines
    # every channel after the first carries the injected delay
    err_samples = float(np.abs(cor.calibrated_delays[1:] - TRUE_DELAY).max()
                        * cfg.bandwidth)
    print(f"  calibration error {err_samples:.4f} samples (worst of "
          f"{cfg.nchan - 1} channels)", flush=True)
    if not err_samples < 0.5:
        raise AssertionError(f"calibration error {err_samples} >= 0.5")
    # the reference recipe for product files: complex rows after the header
    data = np.loadtxt(out, dtype=np.complex128, delimiter=",", skiprows=2)
    data = np.atleast_2d(data)
    md, _ = load_products(out)
    if data.shape != (cor.blocks_processed * nbl, cfg.nbins):
        raise AssertionError(f"CSV shape {data.shape}, expected "
                             f"{(cor.blocks_processed * nbl, cfg.nbins)}")
    if not np.isfinite(data).all() or md["mode"] != "SPECTRUM":
        raise AssertionError("CSV holds non-finite values or wrong mode")
    inner = slice(cfg.nbins // 4, 3 * cfg.nbins // 4)
    ph_std = float(np.std(np.unwrap(np.angle(data.mean(axis=0)[inner]))))
    ph_max = 0.35 if int8 else 0.3
    print(f"  in-band phase std {ph_std:.4f} rad", flush=True)
    if not ph_std < ph_max:
        raise AssertionError(f"in-band phase std {ph_std} >= {ph_max} rad")
    rates = cor.metrics.rates(since="steady", until="end")
    print(f"  [{name}] steady state: {rates['blocks_per_s']:.4f} "
          f"blocks/s, {rates['samples_per_s'] / 1e6:.4f} Msamp/s over "
          f"{rates['elapsed_s']:.3f} s; {cor.metrics.report()}", flush=True)


def parts_name(ingest, deep=False):
    """The count a run's single-pass wrapper adds to (``read_counts``)."""
    return ("fx_parts_i8" if ingest == "int8" else "fx_parts") + (
        "_svd" if deep else "")


def deep_fir_launches(cor):
    """The deep-tap FIR's launches a one-block-a-call run makes: one a
    block where ``fx_fused.deep_fir`` holds at its shape, else none."""
    from fxtpu_torch.ops.fx_fused import deep_fir
    cfg = cor.config
    return (cor.blocks_processed
            if deep_fir(cfg.ntaps, cfg.num_samp // cfg.nbins) else 0)


def run_main_path(tmpdir, ingest, deep):
    """Phase 3: the CLI on the card at one ingest dtype and depth, with
    the launch counts of the run: the single-pass wrapper, its reduce and
    the epilogue once per block each (at deep taps the FIR launch too),
    every other entry (the two-pass ones too) not at all.  Returns (count
    name, the run's counts)."""
    name = parts_name(ingest, deep)
    shape = ["--resolution", "8192", "--ntaps", "32"] if deep else []
    cor, out, counts = run_cli(tmpdir, name, ingest, shape)
    if cor.engine.fir_mode != ("svd" if deep else "direct"):
        raise AssertionError(f"fir_mode {cor.engine.fir_mode} in the {name} "
                             "run")
    others = {k: v for k, v in counts.items()
              if k not in (name, "fx_finish", "fx_parts_reduce", "fir_rows")}
    if not (counts[name] == counts["fx_finish"] == counts["fx_parts_reduce"]
            == cor.blocks_processed >= 3) or any(others.values()) or (
                counts["fir_rows"] != deep_fir_launches(cor)):
        raise AssertionError(
            f"launches {counts} do not match blocks_processed "
            f"{cor.blocks_processed} of {name} (or fewer than 3 blocks)")
    check_products(cor, out, name)
    return name, counts


def run_wide_main_path(tmpdir, ingest):
    """Phase 3, the wide route's main path: the CLI at ``--nchan 8`` (28
    baselines at 4096 bins, where a frame's 8 spectra do not fit in one
    CTA's shared memory): the wide single pass and the epilogue once per
    block each, every other entry not at all, the engine's X stage
    ``global``, 28 baselines a block in the CSV and every channel's delay
    recovered, and the X kernel launched once a block by the wrapper
    that launches it.  Returns (count name, the run's counts)."""
    name = "fx_parts_wide" + ("_i8" if ingest == "int8" else "")
    cor, out, counts = run_cli(tmpdir, name, ingest,
                               ["--nchan", str(CLI_NCHAN)])
    eng = cor.engine
    if eng.x_stage != "global" or eng.fir_mode != "direct":
        raise AssertionError(f"--nchan {CLI_NCHAN}: x_stage {eng.x_stage}, "
                             f"fir_mode {eng.fir_mode}")
    if cor.config.n_baselines != CLI_NCHAN * (CLI_NCHAN - 1) // 2:
        raise AssertionError(f"{cor.config.n_baselines} baselines")
    others = {k: v for k, v in counts.items()
              if k not in (name, "fx_xstage", "fx_finish")}
    if not (counts[name] == counts["fx_xstage"] == counts["fx_finish"]
            == cor.blocks_processed >= 2) or any(others.values()):
        raise AssertionError(
            f"launches {counts} do not match blocks_processed "
            f"{cor.blocks_processed} of {name} (or fewer than 2 blocks)")
    check_products(cor, out, name)
    return name, counts


def check_wide_engines():
    """Phase 3: ``FxEngine`` with ``fused='auto'`` on the card takes the
    kernels, on the wide route, at bench.py's nchan8 shape and at
    ``--nchan 3 --resolution 8192 --ntaps 32``, in both ingests."""
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    for shape, fir in ((dict(nchan=8, include_autos=True, num_samp=2**20,
                             nbins=4096, clamp_num_samp=False), "direct"),
                       (dict(nchan=3, nbins=8192, ntaps=32), "svd")):
        for ingest in ("complex64", "int8"):
            eng = FxEngine(CorrelatorConfig(
                device="cuda", ingest_dtype=ingest, quant_step=STEP,
                **shape))
            print(f"  FxEngine {shape} {ingest}: kernel_active "
                  f"{eng.kernel_active}, x_stage {eng.x_stage}, fir_mode "
                  f"{eng.fir_mode}, launch counters "
                  f"{list(eng.launch_counts())}", flush=True)
            if not (eng.kernel_active and eng.x_stage == "global"
                    and eng.fir_mode == fir):
                raise AssertionError(f"FxEngine {shape} {ingest} does not "
                                     "take the wide route's kernels")


def check_cell_engines(device):
    """Phase 3 at the benchmark's engine cells (``CELL_ENGINES``):
    ``FxEngine`` on the card takes the cell's X stage and ingest with the
    kernels, ``dispatch_batch_for`` gives the cell's K, and one
    ``multi_step`` call of K blocks, with every count set to 0 just
    before and read just after, is one launch of the single pass's
    wrapper, one of its X kernel (the wide route: the plan's CTAs and
    the CTAs that stage each bin tile's spectra, ``plan.reads``, and from
    128 channels one launch of a register-tiled instance: at 512 the band
    one, one block a call) or its reduce (the shared route) and one of
    the epilogue (on its pair-tiled instance where ``finish_plan`` takes
    it), every other entry none; block 0 of the call is ``step`` on that
    block bit for bit.  Returns ({cell: the entries the call launched,
    with the X kernel's CTAs, spectra reads and tiled launches and the
    epilogue's pair-tiled ones}, [each call's counts])."""
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops.fx_epilogue import finish_plan
    from fxtpu_torch.ops.fx_xstage import XSTAGE_TILED_NCH, xstage_plan
    from fxtpu_torch.ops.xengine import pack_delays
    from fxtpu_torch.runtime.native import quantize_c64
    cells, calls = {}, []
    for cell, shape, ingest, blocks, k, x_stage in CELL_ENGINES:
        eng = FxEngine(CorrelatorConfig(device="cuda", ingest_dtype=ingest,
                                        quant_step=STEP, **shape))
        cfg, int8 = eng.cfg, ingest == "int8"
        if not (eng.kernel_active and eng.x_stage == x_stage
                and eng.int8_native == int8
                and eng.dispatch_batch_for(blocks) == k):
            raise AssertionError(
                f"{cell}: kernel_active {eng.kernel_active}, x_stage "
                f"{eng.x_stage}, int8_native {eng.int8_native}, "
                f"dispatch_batch_for({blocks}) "
                f"{eng.dispatch_batch_for(blocks)}, not {k}")
        rng = np.random.default_rng(22)
        data = [(rng.normal(size=(cfg.nchan, cfg.num_samp, 2))
                 @ np.array([1.0, 1j])).astype(np.complex64)
                for _ in range(k)]
        if int8:
            data = [quantize_c64(b, STEP) for b in data]
        # delays within +-8 samples, as the cell's
        d = (np.arange(cfg.nchan) % 17 - 8) / cfg.bandwidth
        d1 = torch.as_tensor(pack_delays(d, cfg.frequency), device=device)
        dk = torch.as_tensor(pack_delays(np.tile(d, (k, 1)), cfg.frequency),
                             device=device)
        h = eng.fresh_history()
        iq_k, iq_1 = eng.prepare_batch(data), eng.prepare_block(data[0])
        del data
        v1, _ = eng.step(iq_1, d1, h)
        eng.multi_step(iq_k, dk, h)         # built and warmed
        torch.cuda.synchronize()
        reset_counts()
        vk, _ = eng.multi_step(iq_k, dk, h)
        torch.cuda.synchronize()
        counts, moved = read_counts(), eng.launch_counts()
        calls.append(counts)
        ran = {n: v for n, v in counts.items() if v}
        wrapper = ("fx_parts_wide" if x_stage == "global" else "fx_parts"
                   ) + ("_i8" if int8 else "")
        second = "fx_xstage" if x_stage == "global" else "fx_parts_reduce"
        want = {wrapper: 1, second: 1, "fx_finish": 1}
        if ran != want:
            raise AssertionError(f"{cell}: one multi_step call of K={k} "
                                 f"launched {ran}, not {want}")
        if x_stage == "global":
            plan = xstage_plan(cfg.nchan, len(eng.pairs),
                               cfg.num_samp // cfg.nbins, cfg.nbins, k)
            tiled = int(cfg.nchan >= XSTAGE_TILED_NCH)
            if (int(plan.tiled) != tiled
                    or moved["fx_xstage.tiled"] != tiled
                    or moved["fx_xstage.ctas"] != plan.ctas(cfg.nbins, k)
                    or moved["fx_xstage.spectra_reads"] != plan.reads):
                raise AssertionError(
                    f"{cell}: the X kernel's work {moved}, the plan "
                    f"{plan}, {plan.ctas(cfg.nbins, k)} CTAs, "
                    f"{plan.reads} spectra reads; expected {tiled} tiled "
                    "launch")
            ran.update({n: moved[n] for n in (
                "fx_xstage.ctas", "fx_xstage.spectra_reads",
                "fx_xstage.tiled")})
        pair_tiled = int(finish_plan(cfg.nchan, len(eng.pairs), cfg.nbins,
                                     k).tiled)
        if moved.get("fx_finish.tiled", 0) != pair_tiled:
            raise AssertionError(f"{cell}: the epilogue's launches {moved}; "
                                 f"expected {pair_tiled} pair-tiled")
        if pair_tiled:
            ran["fx_finish.tiled"] = pair_tiled
        if not torch.equal(vk[0], v1):
            raise AssertionError(f"{cell}: multi_step block 0 is not step")
        print(f"  FxEngine at {cell} ({ingest}, x_stage {eng.x_stage}, "
              f"K={k}, {len(eng.pairs)} pairs): one multi_step call "
              f"launched {ran}; block 0 is step bit for bit", flush=True)
        cells[cell] = ran
        del eng, iq_k, iq_1, vk, v1, h
        torch.cuda.empty_cache()
    return cells, calls


def staged_launches(counts, name, blocks, k):
    """(K-block calls, one-block calls) of a staged run from the count of
    its single-pass wrapper, which takes both: m K-block calls and t tail
    calls give ``m + t`` launches and ``k m + t`` blocks.  Raises when no
    such m >= 0, t >= 0 exist or the reduce and the epilogue did not run
    once a call."""
    launches = counts[name]
    m, rest = (divmod(blocks - launches, k - 1) if k > 1
               else (0, blocks - launches))
    others = {c: v for c, v in counts.items()
              if c not in (name, "fx_finish", "fx_parts_reduce")}
    if (rest or m < 0 or launches - m < 0 or counts["fx_finish"] != launches
            or counts["fx_parts_reduce"] != launches
            or any(others.values())):
        raise AssertionError(
            f"launches {counts} do not account for {blocks} blocks at K = "
            f"{k} through {name}")
    return m, launches - m


def run_staged_main_path(tmpdir, ingest):
    """Phase 3, the staged path: the CLI at ``--blocks_per_dispatch 8``:
    the single-pass wrapper and the epilogue once per staged batch and
    once per tail block, every other entry not at all, and K-block calls x
    8 + one-block calls = blocks.  Returns (count name, the counts)."""
    name = parts_name(ingest)
    cor, out, counts = run_cli(tmpdir, name + "_staged", ingest, [
        "--blocks_per_dispatch", str(MULTI_K)])
    if cor.stager is None or cor.engine.fir_mode != "direct":
        raise AssertionError("the staged run did not start its stager")
    m, t = staged_launches(counts, name, cor.blocks_processed, MULTI_K)
    print(f"  {m} calls of {MULTI_K} blocks, {t} of one", flush=True)
    if m < 1:
        raise AssertionError("the staged run made no K-block call")
    check_products(cor, out, name)
    return name, counts


def run_resume_path(tmpdir, ingest, k):
    """Phase 3, checkpoint/resume on the card through the Correlator with
    ``calibrate_on_start=False``, as every resume test of both packages
    runs it (a resumed run with calibration on spends its first block on
    it and correlates the rest with fresh delays, as ``fxtpu``'s does; the
    CLI has no flag for it in either package): a replay of the CLI's
    blocks (2 channels, 2 us apart) run whole, then cut short with
    ``snapshot_every=2`` (at K = 1 after 5 blocks, at K = 8 after 11: one
    call of 8 and three tail blocks) and resumed from its last snapshot
    over the whole replay, at ``blocks_per_dispatch=k`` in ``ingest``.
    The resumed run's rows must be the whole run's tail from the
    snapshot's block on, within 2e-5 of max|vis| (3e-5 under int8).
    Returns the largest difference relative to max|vis|."""
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.correlator import Correlator
    from fxtpu_torch.products import load_products
    from fxtpu_torch.runtime import checkpoint
    from fxtpu_torch.sources import NoiseSource, save_recording
    nsamp = FLAGSHIP["nsamp"]
    total, cut = (20, 11) if k > 1 else (8, 5)
    rec = os.path.join(tmpdir, f"resume_{total}.npy")
    if not os.path.exists(rec):
        save_recording(NoiseSource(nchan=2, delays=[0.0, TRUE_DELAY],
                                   seed=61), rec, nsamp, total)
    short = os.path.join(tmpdir, f"resume_{cut}.npy")
    if not os.path.exists(short):
        np.save(short, np.load(rec)[:, : cut * nsamp])

    def run(replay, name, **kw):
        out = os.path.join(tmpdir, f"resume_{ingest}_{k}_{name}.csv")
        cor = Correlator(config=CorrelatorConfig(
            run_time=600, mode="SPECTRUM", source="replay",
            replay_file=replay, ingest_dtype=ingest, quant_step=STEP,
            blocks_per_dispatch=k, keyboard_control=False, omit_plot=True,
            output_file=out, device="cuda", loglevel="WARNING",
            calibrate_on_start=False, **kw))
        cor.run_state_machine()
        if not cor.engine.kernel_active:
            raise AssertionError("the resume run did not take the kernels")
        return cor, np.atleast_2d(load_products(out)[1])

    full, rows = run(rec, "full")
    cor_a, _ = run(short, "a", snapshot_every=2)
    done = checkpoint.load_state(cor_a.snapshot_path)["blocks_processed"]
    cor_b, rows_b = run(rec, "b", resume_from=cor_a.snapshot_path)
    if not (rows.shape[0] == full.blocks_processed == total
            and cor_a.blocks_processed == cut and 0 < done <= cut
            and cor_b.blocks_processed == total
            and rows_b.shape == rows[done:].shape):
        raise AssertionError(
            f"resume {ingest} K={k}: {full.blocks_processed} / "
            f"{cor_a.blocks_processed} (snapshot at {done}) / "
            f"{cor_b.blocks_processed} blocks, rows {rows.shape} / "
            f"{rows_b.shape}")
    tol = 3e-5 if ingest == "int8" else 2e-5
    scale = np.abs(rows).max()
    err = float(np.abs(rows_b - rows[done:]).max() / scale)
    print(f"  resume {ingest} blocks_per_dispatch={k}: snapshot at block "
          f"{done}, resumed rows against the whole run's {err:.3g} of "
          f"max|vis| (bound {tol})", flush=True)
    if not err <= tol:
        raise AssertionError(f"resumed rows disagree: {err} > {tol}")
    return err


def compare_k_blocks(case, k, device, fir="direct"):
    """Phase 2, K blocks a call (at 3072 bins, and at the deep CLI block,
    where each block's frames read the FIR launch's rows, ``fir``): the
    step over K merged blocks (``fx_fused_step``, one C call) against
    K one-block steps chained through their history, both ingests, packed
    delays that differ per block: block 0 bit for bit (a block's frames
    are grouped and summed as a one-block launch sums them), every block
    within 1e-5 of max|vis| (blocks after the first read the rows of the
    block before raw, ``fxtpu``'s own bound for K blocks a call) plus, as
    phase 2 holds the epilogue, 2e-6 of the raw cross power per frame
    that cancels at a bin (the DC bin: the two forms remove the means in
    another order), the history after the last block within 1e-6 (int8:
    the tail exactly, ``mu_prev`` within 1e-6 of max|mu|).  Returns the
    largest difference relative to max|vis|, off the DC bin and at it."""
    import torch

    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops import fx_fused as ff
    worst = [0.0, 0.0]
    for int8 in (False, True):
        args = step_inputs(case, k, fir, int8, True, False, device)
        x, hist, w, pairs, consts, delays, tables, bw, cont, step, svd = args
        vis, new = fe.fx_fused_step(*args, pool={})
        xp_raw = (ff.fx_fused_parts_i8(x, hist["tail"], w, pairs, step, svd,
                                       consts) if int8 else
                  ff.fx_fused_parts(x, hist, w, pairs, svd, consts))[0]
        raw = torch.fft.fftshift(xp_raw.abs() / x.shape[2], dim=-1)
        h, ones = hist, []
        for j in range(k):
            v, h = fe.fx_fused_step(x[:, j:j + 1].contiguous(), h, w, pairs,
                                    consts, delays[j:j + 1], tables, bw, cont,
                                    step, svd, pool={})
            ones.append(v[0])
        torch.cuda.synchronize()
        ones = torch.stack(ones)
        scale = ones.abs().max().item()
        diff = (vis - ones).abs()
        within = bool((diff <= 1e-5 * scale + CANCEL_TOL * raw).all())
        dc = x.shape[-2] // 2 if int8 else x.shape[-1] // 2
        err = diff[..., dc].max().item() / scale
        diff[..., dc] = 0
        off = diff.max().item() / scale
        first = torch.equal(vis[0], ones[0])
        if int8:
            mu_err = (new["mu_prev"] - h["mu_prev"]).abs().max().item()
            hist_ok = torch.equal(new["tail"], h["tail"]) and (
                mu_err <= MU_TOL * max(1.0, h["mu_prev"].abs().max().item()))
        else:
            hist_ok = (new - h).abs().max().item() <= HIST_TOL
        print(f"  fx_fused_step K={k} against {k} one-block steps, shape "
              f"{case}, int8 {int8}: block 0 bit for bit {first}, every "
              f"block {off:.3g} of max|vis| off the DC bin, {err:.3g} at it "
              f"(within its bound {within}), history {hist_ok}", flush=True)
        if not (first and off <= 1e-5 and within and hist_ok):
            raise AssertionError(
                f"K = {k} blocks a call disagree with {k} steps at {case} "
                f"(int8 {int8}): block 0 bit for bit {first}, {off:.3g} off "
                f"DC, {err:.3g} at it (bound 1e-5 + {CANCEL_TOL} of the raw "
                f"cross power), history {hist_ok}")
        worst = [max(worst[0], off), max(worst[1], err)]
    return worst


def fir_inputs(case, k, fir, int8, device, seed=77):
    """The deep-tap FIR's inputs at one shape: the merged samples, the
    history (complex64 the corrected tail, int8 the raw tail), the FIR's
    table (``fx_fused.fir_table``: the window, or the SVD mode's folded
    factors) and the quantisation step (None for complex64)."""
    from fxtpu_torch.ops import fx_fused as ff
    rng = np.random.default_rng(seed)
    w, svd = window_and_fir(case, fir, device)
    x = parts_batch(case, k, rng, device, int8)
    hist = raw_history(case, rng, device, int8)
    return (x, hist["tail"] if int8 else hist, ff.fir_table(w, svd),
            STEP if int8 else None)


def compare_fir_rows(case, k, fir, device):
    """Phase 2: the deep-tap FIR launch alone (``fx_fused.fir_rows``, the
    first kernel of every deep-tap step) against its plain version on the
    same inputs, in both ingests: finite, and within FIR_TOL of the plain
    output's largest magnitude (the same table, the same tap order: the
    multiply-adds' rounding only).  Returns (max abs err, max rel err)."""
    import torch

    from fxtpu_torch.ops import fx_fused as ff
    worst = (0.0, 0.0)
    for int8 in (False, True):
        x, h, table, step = fir_inputs(case, k, fir, int8, device)
        got = ff.fir_rows(x, h, table, step)
        want = ff.fir_rows_reference(x, h, table, step)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        print(f"  fir_rows ({fir}) K={k} int8 {int8} shape {case}: "
              f"{err / scale:.3g} of max|fir|", flush=True)
        if not (torch.isfinite(torch.view_as_real(got)).all()
                and err <= FIR_TOL * scale):
            raise AssertionError(f"fir_rows disagrees with its plain version "
                                 f"at {case} K={k} ({fir}, int8 {int8}): "
                                 f"{err / scale:.3g} > {FIR_TOL}")
        worst = (max(worst[0], err), max(worst[1], err / scale))
        del x, h, got, want
    return worst


def fir_bound(case, k, int8):
    """(bound ms, what bounds it) of the deep-tap FIR launch: each sample
    and history row read once (8 bytes complex64, 2 int8), the table once,
    every frame's output written once (8 bytes a bin), against 3.35 TB/s;
    its operations, 4 ntaps flops an output (two real multiply-adds a
    tap), against 67 TFLOP/s float32."""
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    frames = k * (case["nsamp"] // nbins)
    per = 2 if int8 else 8
    nbytes = (nch * (frames + ntaps - 1) * nbins * per + ntaps * nbins * 4
              + nch * frames * nbins * 8)
    ops = 4 * ntaps * nch * frames * nbins
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / 67e12 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_fir_rows(device):
    """Phase 4: the deep-tap FIR launch alone at FIR_CASES in both ingests:
    the wrapper and its plain version by CUDA events in turns, its device
    us (a CUDA-only trace of 5 calls).  Returns ({key: ms}, {key: us})."""
    import statistics

    import torch

    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.probes.common import device_events
    ms, us = {}, {}
    for tag, case, k, fir in FIR_CASES:
        for int8 in (False, True):
            key = tag + ("_i8" if int8 else "")
            x, h, table, step = fir_inputs(case, k, fir, int8, device)
            t = cuda_times({
                "kernel": lambda: ff.fir_rows(x, h, table, step),
                "plain": lambda: ff.fir_rows_reference(x, h, table, step)},
                n=10)
            ms[key], ms["plain_" + key] = t["kernel"], t["plain"]
            us[key] = statistics.median(
                e["dur"] for e in device_events(
                    lambda: ff.fir_rows(x, h, table, step), 5))
            print(f"  fir_rows {key} (K={k}): {t['kernel']:.4f} ms "
                  f"(device us {us[key]:.2f}), plain {t['plain']:.4f} ms; "
                  f"bound {fir_bound(case, k, int8)[0]:.5f} ms", flush=True)
            del x, h
            torch.cuda.empty_cache()
    return ms, us


def run_bins_main_path(tmpdir, ingest, tag, flags):
    """Phase 3 at a bin count that is not a power of two in [256, 8192]
    (ROADMAP K.3): the CLI with ``flags``, every launch count set to 0 just
    before and read just after: the engine takes the kernels
    (``kernel_active``; the wide route where the shared one does not fit,
    the SVD-FIR mode at 32 taps), with no WARNING that it took the plain
    torch route; the single pass's wrapper, its reduce (or on the wide
    route its X kernel) and the epilogue once a block each, every other
    entry not at all; the products hold (``check_products``).  Returns
    the run's counts."""
    import logging

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    records, keep = [], Keep(logging.WARNING)
    log = logging.getLogger("fxtpu_torch.fx")
    log.addHandler(keep)
    try:
        cor, out, counts = run_cli(tmpdir, f"{tag}_{ingest}", ingest, flags)
    finally:
        log.removeHandler(keep)
    eng = cor.engine
    plain = [m for m in records if "plain torch route" in m]
    wide = eng.x_stage == "global"
    name = (("fx_parts_wide" if wide else "fx_parts")
            + ("_i8" if ingest == "int8" else "")
            + ("_svd" if eng.fir_mode == "svd" else ""))
    second = "fx_xstage" if wide else "fx_parts_reduce"
    others = {c: v for c, v in counts.items()
              if c not in (name, second, "fx_finish", "fir_rows")}
    print(f"  {tag} {ingest}: x_stage {eng.x_stage}, fir_mode "
          f"{eng.fir_mode}, {cor.config.num_samp // cor.config.nbins} "
          f"frames a block", flush=True)
    if plain or not (counts[name] == counts[second] == counts["fx_finish"]
                     == cor.blocks_processed >= 2) or any(others.values()) or (
                         counts["fir_rows"] != deep_fir_launches(cor)):
        raise AssertionError(
            f"{tag} {ingest}: launches {counts} do not match blocks_processed "
            f"{cor.blocks_processed} of {name} (or fewer than 2 blocks), or "
            f"the engine warned {plain}")
    check_products(cor, out, f"{tag}_{ingest}")
    return counts


def time_bins(device):
    """Phase 4 at the bin counts of ROADMAP K.3 (``BIN_CASES``): the single
    pass's wrapper (frames and reduce, or frames and X kernel) and its
    plain version in both ingests, by CUDA events in turns, and the
    device us of each of its kernels (a CUDA-only trace of 3 calls); the
    spectrometer and its plain version at ``BIN_SPEC_CASES``; the X kernel
    alone at 16,384 bins against its plain version and ``torch.matmul``'s
    Gram (its ``library_ms``).  Returns (times ms, device us by kernel)."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.ops.dc_posthoc import dc_constants
    from fxtpu_torch.ops.fx_xstage import fx_xstage, fx_xstage_reference
    from fxtpu_torch.ops.spectrometer import (spectrometer_fused,
                                              spectrometer_fused_reference)
    from fxtpu_torch.probes.common import device_events
    fns, dev_us, keep = {}, {}, []
    rng = np.random.default_rng(43)
    for tag, case, fir in BIN_CASES:
        nch, nbins = case["nch"], case["nbins"]
        s = case["nsamp"] // nbins
        w, svd = window_and_fir(case, fir, device)
        pairs = pairs_tensor(baseline_pairs(nch, case["autos"]), nch, device)
        consts = dc_constants(w.cpu().numpy(), nbins, s, device, svd)
        for int8 in (False, True):
            key = tag + ("_i8" if int8 else "")
            x = parts_batch(case, 1, rng, device, int8)
            hist = raw_history(case, rng, device, int8)
            rank = 0 if svd is None else svd[0].shape[1]
            wide = ff.x_route(nbins, case["ntaps"], nch, rank) == "global"
            if int8:
                args = (x, hist["tail"], w, pairs, STEP, svd, consts)
                entry = ff.fx_fused_parts_i8
                ref = (ff.fx_fused_parts_i8_wide_reference if wide
                       else ff.fx_fused_parts_i8_reference)
            else:
                args = (x, hist, w, pairs, svd, consts)
                entry = ff.fx_fused_parts
                ref = (ff.fx_fused_parts_wide_reference if wide
                       else ff.fx_fused_parts_reference)
            fns["parts_" + key] = lambda e=entry, a=args: e(*a)
            fns["plain_" + key] = lambda r=ref, a=args: r(*a)
            fns["parts_" + key]()
            torch.cuda.synchronize()
            dev_us[key] = kernel_us(device_events(fns["parts_" + key], 3))
            keep.append(args)
    for case in BIN_SPEC_CASES:
        key = f"spec_r{case['nbins']}"
        w, blocks, h0 = make_spec_case(case, rng, device)
        fns[key] = lambda w=w, x=blocks[0], h=h0, n=case["nbins"]: (
            spectrometer_fused(x, w, n, h))
        fns["plain_" + key] = lambda w=w, x=blocks[0], h=h0, n=case[
            "nbins"]: spectrometer_fused_reference(x, w, n, h)
        fns[key]()
        torch.cuda.synchronize()
        dev_us[key] = kernel_us(device_events(fns[key], 3))
        keep.append(blocks)
    spec, pairs, da = xstage_inputs(R16384, 1, device)
    a = spec[0].permute(2, 0, 1).contiguous()      # [nbins, nch, S]
    ah = a.conj().transpose(1, 2)                  # [nbins, S, nch]
    fns["xstage_r16384"] = lambda: fx_xstage(spec, pairs, da)
    fns["xstage_plain_r16384"] = lambda: fx_xstage_reference(spec, pairs,
                                                             da)
    fns["xstage_library_r16384"] = lambda: torch.matmul(a, ah)
    for key in ("xstage_r16384", "xstage_library_r16384"):
        fns[key]()
        torch.cuda.synchronize()
        dev_us[key] = kernel_us(device_events(fns[key], 3))
    times = cuda_times(fns, n=10, warm=2)
    del keep
    return times, dev_us


def device_busy(prof, path):
    """(busy ms, kernel ms, copy ms, first-to-last span ms, launches the
    host made, launches without their device record) of the device in a
    ``torch.profiler`` trace: the union of its kernels', copies' and
    memsets' spans, and the sums of each.  Records are matched to the
    host's launching calls by ``correlation``, the rule of
    ``probes.common.device_events`` (B.4): the tracer can lose device
    records, and a busy share over a trace that lost some reads low, so
    the count of lost records stands beside it."""
    from fxtpu_torch.probes.common import LAUNCH_CALLS
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e["name"].startswith(LAUNCH_CALLS)}
    recorded = {e["args"]["correlation"] for e in device}
    spans, kern, copy = [], 0.0, 0.0
    for e in device:
        spans.append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] == "kernel":
            kern += e["dur"]
        elif e["cat"] == "gpu_memcpy":
            copy += e["dur"]
    if not spans:
        raise AssertionError("the profiler saw no device work")
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    first = lo
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    last = max(b for _, b in spans)
    return (busy / 1e3, kern / 1e3, copy / 1e3, (last - first) / 1e3,
            len(launched), len(launched - recorded))


def run_pipeline(tmpdir, rec, ingest, k):
    """Phase 3: ``bench_pipeline``'s configuration through the Correlator
    at K blocks per dispatch for PIPELINE_S seconds (looping replay),
    counted like the CLI runs, under a CUDA-only profiler trace.  Returns
    a dict of its rates and device times."""
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.correlator import Correlator
    from fxtpu_torch.products import load_products
    name = parts_name(ingest)
    out = os.path.join(tmpdir, f"pipe_{ingest}_{k}.csv")
    cfg = CorrelatorConfig(
        **PIPELINE, run_time=PIPELINE_S, clamp_num_samp=False,
        loglevel="WARNING", source="replay", replay_file=rec,
        blocks_per_dispatch=k, ingest_dtype=ingest, device="cuda",
        output_file=out)
    cor = Correlator(config=cfg)
    getattr(cor.source, "inner", cor.source).loop = True
    reset_counts()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cor.run_state_machine()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    n = cor.blocks_processed
    multi, _ = staged_launches(counts, name, n, k)
    if (n < 2 * k or (k > 1) != (multi > 0)
            or (cor.stager is None) != (k == 1)):
        raise AssertionError(f"pipeline {ingest} K={k}: launches {counts} "
                             f"against {n} blocks")
    md, data = load_products(out)
    if (data.shape[0] != n or not np.isfinite(data).all()
            or md["mode"] != "CONTINUUM"):
        raise AssertionError(f"pipeline CSV {data.shape} for {n} blocks")
    busy, kern, copy, span, host_launches, lost = device_busy(
        prof, os.path.join(tmpdir, f"trace_{ingest}_{k}.json"))
    r = cor.metrics.rates(since="steady", until="end")
    res = {"k": k, "blocks": n, "blocks_per_s": r["blocks_per_s"],
           "msamp_per_s": r["samples_per_s"] / 1e6,
           "steady_s": r["elapsed_s"], "wall_s": wall,
           "device_busy_ms": busy, "busy_share": busy / (wall * 1e3),
           "kernel_ms_per_block": kern / n, "copy_ms_per_block": copy / n,
           "device_span_ms": span, "launches": counts,
           "host_launches": host_launches, "lost_records": lost,
           "host_plane": host_plane_state(cor, f"pipeline {ingest} K={k}"),
           "host": host_info()}
    print(f"  pipeline {ingest} K={k}: {n} blocks, "
          f"{res['blocks_per_s']:.4f} blocks/s, "
          f"{res['msamp_per_s']:.4f} Msamp/s steady over "
          f"{r['elapsed_s']:.3f} s; device busy {busy:.3f} ms of "
          f"{wall:.3f} s ({100 * res['busy_share']:.4f}%; {lost} of "
          f"{host_launches} launches without a device record), kernels "
          f"{res['kernel_ms_per_block']:.4f} ms/block, copies "
          f"{res['copy_ms_per_block']:.4f} ms/block; "
          f"{cor.metrics.report()}; host {json.dumps(res['host'])}",
          flush=True)
    return res


def two_pass_steps(eng):
    """``(step, multi_step)`` of the fused step's two-pass form for
    ``eng``'s configuration, as a caller composes it from the two-pass
    wrappers (``fx_fused_raw*``: a mean pre-pass, the frame kernel, a
    reduce) and the plain ``finish``: what the engine ran before the
    single pass, with the engine's own inputs and history contracts."""
    import torch

    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.ops.fx_epilogue import FinishTables, finish
    cfg, dev = eng.cfg, eng.device
    w = torch.as_tensor(eng.window2d.astype(np.float32), device=dev)
    svd = ff.svd_tensors(eng.window2d, dev) if eng.fir_mode == "svd" else None
    pairs = ff.pairs_tensor(eng.pairs, cfg.nchan, dev)
    tables = FinishTables(eng.pairs, cfg.nbins, cfg.bandwidth, cfg.frequency,
                          dev)
    continuum = cfg.mode in ("CONTINUUM", "TEST")

    def build(c64, i8, frames_axis):
        def run(iq, delays, history):
            if isinstance(history, dict):
                xp, history = i8(iq, history, w, pairs, cfg.quant_step, svd)
            else:
                xp, history = c64(iq, history, w, pairs, svd)
            return finish(xp, delays, tables, iq.shape[frames_axis],
                          cfg.bandwidth, continuum), history
        return run

    return (build(ff.fx_fused_raw, ff.fx_fused_raw_i8, 1),
            build(ff.fx_fused_raw_multi, ff.fx_fused_raw_i8_multi, 2))


def run_two_pass_path(device):
    """Phase 3, the two-pass entries, which the engine no longer calls:
    ``fx_fused_raw*`` with the plain ``finish`` (:func:`two_pass_steps`)
    over 3 chained blocks one at a time and 2 chained batches of 8, at the
    flagship in both ingests and at the CLI's deep-tap block (SVD),
    counted like the main path: the one-block entry once a block, the
    K-block entry once a batch, no single-pass entry at all; every
    visibility within 2e-5 (3e-5: 8-bit samples, deep taps) of max|vis| of
    the engine's single-pass step on the same input.  Returns {entry:
    launches}."""
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops.xengine import pack_delays
    from fxtpu_torch.runtime.native import quantize_c64
    launches = {}
    rng = np.random.default_rng(77)
    for deep in (False, True):
        shape = (dict(nbins=DEEP_CLI["nbins"], ntaps=DEEP_CLI["ntaps"])
                 if deep else {})
        for ingest in ("complex64", "int8"):
            cfg = CorrelatorConfig(device="cuda", ingest_dtype=ingest,
                                   quant_step=STEP, **shape)
            one = FxEngine(cfg)
            step2, multi2 = two_pass_steps(one)
            single = ("fx_fused_i8" if ingest == "int8" else "fx_fused")
            sfx = "_svd" if deep else ""
            tol = DEEP_TOL if (deep or ingest == "int8") else REL_TOL
            blocks = [(rng.normal(size=(2, cfg.num_samp, 2))
                       @ np.array([1.0, 1j]) + (0.02 - 0.01j)
                       ).astype(np.complex64) for _ in range(MULTI_K)]
            if ingest == "int8":
                blocks = [quantize_c64(b, STEP) for b in blocks]
            d1 = torch.as_tensor(pack_delays([0.0, TRUE_DELAY],
                                             cfg.frequency), device=device)
            dk = d1.expand(MULTI_K, *d1.shape).contiguous()
            reset_counts()
            h, vis = one.fresh_history(), []
            for b in blocks[:3]:
                v, h = step2(one.prepare_block(b), d1, h)
                vis.append(v)
            hm = one.fresh_history()
            for _ in range(2):
                vm, hm = multi2(one.prepare_batch(blocks), dk, hm)
            torch.cuda.synchronize()
            counts = read_counts()
            want = {single + sfx: 3, single + "_multi" + sfx: 2}
            if deep:
                # each deep-tap call launches the FIR first
                want["fir_rows"] = 5
            if {c: v for c, v in counts.items() if v} != want:
                raise AssertionError(f"two-pass step launches {counts}, "
                                     f"expected {want}")
            h1, worst = one.fresh_history(), 0.0
            for b, v2 in zip(blocks[:3], vis):
                v1, h1 = one.step(one.prepare_block(b), d1, h1)
                worst = max(worst, ((v1 - v2).abs().max()
                                    / v2.abs().max()).item())
            if not worst <= tol:
                raise AssertionError(
                    f"the single-pass step disagrees with the two-pass "
                    f"form ({ingest}, deep {deep}): {worst:.3g} > {tol}")
            print(f"  two-pass step {ingest}{' deep' if deep else ''}: "
                  f"launches {want}; single pass within {worst:.3g} of "
                  "max|vis|", flush=True)
            if not deep:
                launches.update(want)
            else:
                launches[single + sfx] = want[single + sfx]
                launches[single + "_multi"] += want[single + "_multi" + sfx]
    return launches


def run_spectrometer_path(device):
    """Phase 3, the F-stage entry: ``spectrometer_fused`` over 3 chained
    flagship blocks, as a user calls it, counted like the main path."""
    import torch

    from fxtpu_torch.ops.spectrometer import (spectrometer_fused,
                                              spectrometer_fused_reference)
    case = SPEC_CASES[-1]
    w, blocks, h = make_spec_case(case, np.random.default_rng(91), device)
    reset_counts()
    specs = []
    for x in blocks:
        spec, h = spectrometer_fused(x, w, case["nbins"], h)
        specs.append(spec)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"  spectrometer_fused, 3 flagship blocks: launches {counts}",
          flush=True)
    if counts["spectrometer"] != 3 or sum(counts.values()) != 3:
        raise AssertionError(f"spectrometer launches {counts}, expected 3")
    want, _ = spectrometer_fused_reference(blocks[0], w, case["nbins"],
                                           torch.zeros_like(h))
    err = ((specs[0] - want).abs().max() / want.abs().max()).item()
    if specs[0].shape != (case["nch"], case["nsamp"] // case["nbins"],
                          case["nbins"]) or not err <= SPEC_TOL:
        raise AssertionError(f"spectrometer path: shape "
                             f"{tuple(specs[0].shape)}, err {err}")
    return counts["spectrometer"]


def compare_ablate(case, k, device):
    """Phase 2 for the stage ablation at one shape: every stage in both
    ingests and, at deep taps, both FIR modes, against its plain version.
    Returns (max abs err, max rel err) over all of them."""
    import torch

    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.probes import ablate
    deep = case["ntaps"] >= 16
    tol = DEEP_TOL if deep else REL_TOL
    abs_err = rel_err = 0.0
    for ingest in ("complex64", "int8"):
        for fir in (("direct", "svd") if deep else ("direct",)):
            x, h, w, pairs, step, svd = ablate.make_inputs(
                device, nch=case["nch"], k=k, num_samp=case["nsamp"],
                nbins=case["nbins"], ntaps=case["ntaps"], ingest=ingest,
                fir_mode=fir, seed=3)
            errs = {}
            # the mixed-radix kernel runs fir, fft and full
            for stage in (st for st in ff.STAGES if st in ff.MIXED_STAGES
                          or ff._pow2_bins(case["nbins"])):
                got = ff.fx_fused_ablate(x, h, w, pairs, stage, step, svd)
                want = ff.fx_fused_ablate_reference(x, h, w, pairs, stage,
                                                    step, svd)
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                errs[stage] = err / scale
                if got.shape != want.shape or not err <= tol * scale:
                    raise AssertionError(
                        f"ablation stage {stage} ({ingest}, {fir}) disagrees "
                        f"with its plain version at {case}: {err / scale:.3g} "
                        f"> {tol}")
                abs_err = max(abs_err, err)
                rel_err = max(rel_err, err / scale)
            print(f"  {ingest} {fir} K={k}: "
                  + ", ".join(f"{st} {e:.2g}" for st, e in errs.items()),
                  flush=True)
            del x
    return abs_err, rel_err


def compare_probes(device):
    """Phase 2 for the three probe kernels: every leg at a small shape and
    at the shape the probes time it at, against its plain version.
    Returns {entry: (max abs err, max rel err)}."""
    import torch

    from fxtpu_torch.probes import copy_rate, overlap, retile
    from fxtpu_torch.probes.common import sm_count
    errs = {}
    # copy probe: checksums are exact
    legs = 0
    for nbytes in (2**22, copy_rate.COLD_BYTES):
        src = copy_rate._source(nbytes, device, seed=5)
        plans = [copy_rate.width_plan(wd, nbytes)
                 for wd in copy_rate.WIDTHS]
        plans += [plan for _, _, _, plan in copy_rate.shape_plans(
            nbytes, FLAGSHIP["nbins"])]
        for plan in plans:
            want = copy_rate.copy_probe_reference(src, plan, 2)
            for mech in copy_rate.MECHS:
                got = copy_rate.copy_probe(src, plan, mech, reps=2)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"copy probe ({mech}) checksums differ from the "
                        f"plain version at {plan}")
                legs += 1
        del src
    print(f"  copy_probe: {legs} legs, every tile checksum exact",
          flush=True)
    errs["copy_probe"] = (0.0, 0.0)
    # overlap probe: the probe's own shape, a small one, and 256 and 8192
    # bins at 2 and 8 taps; each structure with the shared memory the probe
    # asks for (it decides the layout: rows once or chunks, teams)
    sms = sm_count(device)
    worst, legs, layouts = 0.0, 0, set()
    for n, cb, frames, ntaps in ((1024, 256, 3, 4), (4096, 512, 32, 4),
                                 (256, 256, 3, 2), (256, 256, 3, 8),
                                 (8192, 512, 3, 2), (8192, 512, 3, 8)):
        gen = torch.Generator(device=device).manual_seed(6)
        src = torch.view_as_complex(torch.randn(
            (2 * sms * frames + ntaps - 1, n, 2), device=device,
            generator=gen))
        for structure, (nbuf, per_sm) in overlap.STRUCTURES.items():
            nbuf = min(nbuf, n // cb)
            lay = overlap.plan(n, cb, ntaps, nbuf, per_sm)
            if lay is None:
                continue
            layouts.add((n, ntaps, structure, lay.rows_once, lay.teams))
            smem = (lay.shared_bytes if per_sm > 1
                    else max(lay.shared_bytes, overlap.ONE_CTA_BYTES))
            # the kernel takes the layout the module plans
            took = overlap.kernel_layout(n, cb, ntaps, nbuf, smem)
            if took != lay:
                raise AssertionError(f"overlap probe at n = {n}, {ntaps} "
                                     f"taps, {structure}: the kernel takes "
                                     f"{took}, overlap.plan says {lay}")
            grid, per_cta = per_sm * sms, frames * 2 // per_sm
            for mech in overlap.MECHS:
                for copy, body in ((True, "touch"), (False, "fma"),
                                   (False, "fx"), (True, "fma"),
                                   (True, "fx")):
                    overlap.copied_bytes(device)
                    worst = max(worst, overlap.check_leg(
                        src, tol=REL_TOL, cb=cb, ntaps=ntaps,
                        frames=per_cta, reps=1, nbuf=nbuf, copy=copy,
                        body=body, grid=grid, mech=mech, smem=smem))
                    # a copying leg's copies ask for its schedule's bytes
                    copied = overlap.copied_bytes(device)
                    want = overlap.device_bytes(grid, per_cta, ntaps, n,
                                                lay.rows_once)
                    if copy and copied != want:
                        raise AssertionError(
                            f"overlap probe ({mech}) at n = {n}, {ntaps} "
                            f"taps, {structure}: its copies asked for "
                            f"{copied} bytes, the schedule {want}")
                    legs += 1
        del src
    print(f"  overlap_probe: {legs} legs within {worst:.3g} of max|plain|, "
          "each the kernel's layout, each copying leg's copies its "
          "schedule's bytes; layouts (n, ntaps, structure, rows once, "
          "teams): "
          f"{sorted(layouts)}", flush=True)
    errs["overlap_probe"] = (worst, worst)
    x, xt, m = retile.make_inputs(device)
    worst = max(retile.check_form(x, xt, m, form, nt, reps)
                for form in retile.FORMS
                for nt, reps in ((2, 1), (retile.NT, 32)))
    print(f"  retile_probe: every leg within {worst:.3g} of max|plain|",
          flush=True)
    errs["retile_probe"] = (worst, worst)
    return errs


def run_probe(argv, expect):
    """Phase 3, the measurement path: ``fxtpu_torch.probes.main(argv)``
    with every launch count set to 0 just before and read just after.
    ``expect`` names the entries that must have launched; every other
    entry must not have.  Returns (records, counts)."""
    import contextlib
    import io

    from fxtpu_torch import probes
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        records = probes.main([*argv, "--device", "cuda"])
    counts = read_counts()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    if len(lines) != len(records) or [json.loads(ln) for ln in lines] != (
            json.loads(json.dumps(records))):
        raise AssertionError(f"probes {argv}: the printed lines are not the "
                             "records")
    launched = {k: v for k, v in counts.items() if v}
    print(f"  probes {' '.join(argv)}: {len(records)} lines, launches "
          f"{launched}", flush=True)
    if set(launched) != set(expect):
        raise AssertionError(f"probes {argv}: launches {launched}, expected "
                             f"exactly {sorted(expect)}")
    for rec in records:
        bad = [k for k, v in rec.items() if isinstance(v, float)
               and not np.isfinite(v)]
        if bad or rec.get("finite") is False or rec.get(
                "checksum_ok") is False:
            raise AssertionError(f"probes {argv}: bad record {rec}")
    return records, counts


def fx_bound(case, k, int8, rank, spectra=False, parts=False):
    """The least time the card could take for one FX call (or, with
    ``spectra``, one spectrometer call) over k blocks of ``case``: the
    larger of its bytes (samples, history, window or factors and pairs in
    once, the cross power or the spectra and the history out once) over
    the device-memory rate and its operations (per sample and tap 4 for the
    FIR, the direct form's count in either FIR mode: the rank-r factors are
    one way to compute the same output, not work the function needs; 5 n
    log2 n per FFT; 8 per pair, frame and bin for the X stage; 2 per sample
    for the mean) over the float32 rate.  With ``parts`` the single pass:
    the dA table in as well, T and GJ out beside the cross power and mu
    for every block, and 2 operations per sample for T and 8 per channel,
    halo frame and bin for GJ.  Returns (ms, "bytes" or "operations")."""
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    s = case["nsamp"] // nbins
    nbl = (nch * (nch - 1) // 2 + (nch if case.get("autos") else 0))
    samples = k * nch * s * nbins
    halo = nch * (ntaps - 1) * nbins
    table = (ntaps + nbins) * rank * 4 if rank else ntaps * nbins * 4
    if int8:
        nbytes = 2 * samples + 2 * halo + 8 * nch + k * nch * 8
    else:
        nbytes = 8 * samples + 2 * 8 * halo
    nbytes += table + (0 if spectra else 8 * nbl + 8 * k * nbl * nbins)
    flops = samples * (2 + 4 * ntaps + 5 * np.log2(nbins))
    if spectra:
        nbytes += 8 * samples
    else:
        flops += 8 * k * nbl * s * nbins
    if parts:
        nbytes += (8 * (ntaps - 1) * nbins + 8 * k * 2 * nch * nbins
                   + (0 if int8 else 8 * k * nch))
        flops += 2 * samples + 8 * k * nch * (ntaps - 1) * nbins
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def finish_bound(case, k):
    """The least time the card could take for one epilogue over k blocks
    of ``case``: its bytes (the parts, the window's constants, the
    frequencies, means and delays in, the visibilities out) over the
    device-memory rate, or its operations (13 complex products, 10 complex
    sums, a sine and a cosine and two divisions, some 130 per visibility)
    over the float32 rate.  Returns (ms, "bytes" or "operations")."""
    nch, nbins = case["nch"], case["nbins"]
    nbl = (nch * (nch - 1) // 2 + (nch if case.get("autos") else 0))
    nbytes = (8 * k * (nbl + 2 * nch) * nbins + 28 * nbins + 24 * k * nch
              + 8 * nbl + 8 * k * nbl * nbins)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = 130 * k * nbl * nbins / FP32_FLOPS * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def svd_form_ms(case, k, rank):
    """A note beside an SVD entry's bound: the time of the operations the
    rank-r form of the FIR itself spends (4 per sample, tap and rank, and 4
    per sample and rank to recombine) at the float32 rate."""
    samples = k * case["nch"] * case["nsamp"]
    return (samples * (4 * case["ntaps"] * rank + 4 * rank)
            / FP32_FLOPS * 1e3)


def count_device_launches(fn):
    """Kernels, copies and memsets the device runs for one call of ``fn``:
    the device events of 3 traced calls (``probes.common.device_events``,
    which holds every launching call of the host to its device record and
    the calls to the same number of launches each), over 3."""
    import torch

    from fxtpu_torch.probes.common import device_events
    fn()
    torch.cuda.synchronize()
    return len(device_events(fn, 3)) // 3


def stage_table(ablate_runs, device):
    """Phase 4: one row per ``ablate`` run of phase 3 with the frame
    kernel's device time per block after each stage (us, the profiler's),
    the pre-pass and the reduce, the event time per block of the whole
    call, and ``torch.fft.fft`` over one block's ``[nch, S, nbins]``
    complex64 timed beside them (``library_ms``, per block), and the
    FFT's own device time, ``fft - fir`` (``fft_stage_us``)."""
    import torch
    rows, fft_ms = [], {}
    for tag, records in ablate_runs:
        stages = [r for r in records if "stage" in r]
        diff = [r for r in records if "stage" not in r][0]
        first = stages[0]
        shape = (first["nch"], first["num_samp"] // first["nbins"],
                 first["nbins"])
        if shape not in fft_ms:
            z = torch.view_as_complex(torch.randn((*shape, 2), device=device))
            fft_ms[shape] = cuda_times(
                {"fft": lambda z=z: torch.fft.fft(z)}, n=20)["fft"]
            del z
        full = {r["stage"]: r for r in stages}["full"]
        frames_us = {r["stage"]: r["device_us"]["frames"] for r in stages}
        rows.append({
            "shape": tag, "k": first["k"], "ingest": first["ingest"],
            "fir_mode": first["fir_mode"],
            "frames_us": frames_us,
            "event_ms": {r["stage"]: r["ms_per_block"] for r in stages},
            "prepass_us": full["device_us"]["prepass"],
            # the deep-tap FIR launch before the frame kernel, or None
            "fir_us": full["device_us"].get("fir"),
            "reduce_us": full["device_us"]["reduce"],
            "frames_differences_us":
                diff["frame_kernel_differences_us_per_block"],
            # the FFT's own device time: its passes over the block's frames
            "fft_stage_us": frames_us["fft"] - frames_us["fir"],
            "library_ms": fft_ms[shape]})
    return rows


def probe_kernel_entries(table, probe_records, launches, errs, mkt, device):
    """The ``kernels`` line's entries of the measurement path's four
    kernels: each one's time at the shape its probe times it at, its plain
    version's time on the same input, and its bound from that input."""
    import torch

    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.probes import ablate, copy_rate, overlap, retile
    out = []

    def entry(name, source, **fields):
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": REPLACES[name], "launches": launches[name],
                    "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
                    "library_ms": None, **fields})

    # fx_ablate: stage "fft" (all but the X stage) per block, flagship, K = 8
    x, h, w, pairs, step, svd = ablate.make_inputs(
        device, nch=2, k=MULTI_K, num_samp=FLAGSHIP["nsamp"],
        nbins=FLAGSHIP["nbins"], ntaps=FLAGSHIP["ntaps"],
        ingest="complex64", fir_mode="direct", seed=1)
    t = cuda_times({
        "kernel": lambda: ff.fx_fused_ablate(x, h, w, pairs, "fft"),
        "plain": lambda: ff.fx_fused_ablate_reference(x, h, w, pairs, "fft"),
    }, n=10, warm=2)
    # per block of the K = 8 launch: the samples in, the one touch of the
    # partial out, and an eighth of the history and the window, which the
    # launch reads once
    nb, s = FLAGSHIP["nbins"], FLAGSHIP["nsamp"] // FLAGSHIP["nbins"]
    samples = 2 * s * nb
    nbytes = (8 * samples + 8 * ff.FFT_STAGE_BINS
              + (8 * 2 * 3 * nb + 4 * 4 * nb) / MULTI_K)
    flops = samples * (2 + 4 * 4 + 5 * np.log2(nb))
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    row = next(r for r in table if (r["shape"], r["k"], r["ingest"]) == (
        "flagship", MULTI_K, "complex64"))
    entry("fx_ablate", SOURCE, ms=t["kernel"] / MULTI_K,
          plain_ms=t["plain"] / MULTI_K, bound_ms=max(tb, tf),
          bound_by="bytes" if tb >= tf else "operations", stage="fft",
          k=MULTI_K, frames_us=row["frames_us"],
          full_plain_ms=mkt["flagship"]["plain"])
    del x

    # copy_probe: the cold walk by bulk copies of 32 KB runs, one repeat
    rec = next(r for r in probe_records["copy_rate"] if (
        r["sweep"], r["walk"], r["mech"], r["width"]) == (
        "width", "cold", "bulk", 32768))
    src = copy_rate._source(rec["bytes_per_rep"], device, seed=0)
    plan = copy_rate.width_plan(32768, rec["bytes_per_rep"])
    # at this width a tile is 64 contiguous KB, so one torch.sum over the
    # words as [ntiles, 16384] forms the same checksums (modulo 2^32)
    words = src.view(torch.int32).view(plan.ntiles, -1)
    if not torch.equal(words.sum(dim=1) & 0xffffffff,
                       copy_rate.copy_probe_reference(src, plan, 1)):
        raise AssertionError("torch.sum over the tiles' words is not the "
                             "copy probe's checksum")
    t = cuda_times({
        "plain": lambda: copy_rate.copy_probe_reference(src, plan, 1),
        "library": lambda: words.sum(dim=1)}, n=5, warm=1)
    plain = t["plain"]
    entry("copy_probe", PROBES_SOURCE, ms=rec["ms_per_rep"], plain_ms=plain,
          library_ms=t["library"], library="torch.sum over [ntiles, words]",
          bound_ms=(rec["bytes_per_rep"] + 4 * plan.ntiles)
          / HBM_BYTES_PER_S * 1e3, bound_by="bytes", gbps=rec["gbps"],
          leg="width sweep, cold, bulk, 32 KB runs")
    del src, words

    # overlap_probe: the pipelined fx leg, one repeat
    rec = next(r for r in probe_records["overlap_bulk"] if (
        r.get("leg"), r.get("body")) == ("pipelined", "fx"))
    n, ntaps, grid, frames = (rec["n"], rec["ntaps"], rec["grid"],
                              rec["frames_per_cta"])
    gen = torch.Generator(device=device).manual_seed(0)
    src = torch.view_as_complex(torch.randn(
        (grid * frames + ntaps - 1, n, 2), device=device, generator=gen))
    plain = cuda_times({"plain": lambda: overlap.overlap_probe_reference(
        src, cb=rec["cb"], ntaps=ntaps, frames=frames, reps=1, nbuf=2,
        copy=True, body="fx", grid=grid)}, n=5, warm=1)["plain"]
    # one repeat (the slope): every row in once; the checksums are written
    # once a launch, not once a repeat
    nbytes = src.numel() * 8
    flops = grid * frames * n * (4 * ntaps + 5 * np.log2(n))
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    entry("overlap_probe", PROBES_SOURCE, ms=rec["ms_per_rep"],
          plain_ms=plain, bound_ms=max(tb, tf),
          bound_by="bytes" if tb >= tf else "operations",
          leg="pipelined, fx body, bulk copies",
          # the layout the kernel took and the bytes its copies asked for
          # a repeat, both read from the kernel in the probe's run
          rows_read_once=rec["rows_read_once"], teams=rec["teams"],
          device_bytes_per_rep=rec["device_bytes_per_rep"])
    del src

    # retile_probe: the gather leg, one repeat of 32 tiles of 16 frames
    rec = next(r for r in probe_records["retile"] if r["form"] == "gather")
    x, xt, m = retile.make_inputs(device)
    plain = cuda_times({"plain": lambda: retile.retile_reference(
        x, m, rec["nt"], 1)}, n=10, warm=2)["plain"]
    slots = rec["nt"] * rec["tile"]
    nbytes = x.numel() * 4 + m.numel() * 4      # one repeat, as above
    # bf16 products summed in float32: the tensor cores' work
    flops = slots * 2 * retile.N1 * retile.NBINS
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_TENSOR_FLOPS * 1e3
    # every slot reads its 16 KB frame again, from L2: the best rate the
    # copy probe's hot walks measured in this run
    hot = max(r["gbps"] for r in probe_records["copy_rate"]
              if r.get("walk") == "hot" and r.get("gbps"))
    entry("retile_probe", PROBES_SOURCE,
          ms=rec["ps_per_sample"] * rec["samples_per_rep"] * 1e-9,
          plain_ms=plain, bound_ms=max(tb, tf),
          bound_by="bytes" if tb >= tf else "operations", leg="gather",
          l2_gbps=hot)
    return out


def cuda_times(fns, n=60, warm=5):
    """Median ms per call of each fn, timed with CUDA events in turns
    (a, b, b, a) so drift hits both alike."""
    import torch
    samples = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for key in order:
        fn = fns[key]
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(n):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        samples[key] += [s.elapsed_time(e) for s, e in evs]
    return {k: statistics.median(v) for k, v in samples.items()}


def engine_steps(shape_kw, block_c64, d, tol, fir_mode, tag):
    """The engine step on either route for both ingests at one shape:
    (step callables, copy callables), after checking that the two routes
    agree within ``tol`` and that the kernel route runs ``fir_mode``."""
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.runtime.native import quantize_c64
    steps, copies = {}, {}
    for ingest in ("complex64", "int8"):
        cfg = CorrelatorConfig(device="cuda", ingest_dtype=ingest,
                               quant_step=STEP, **shape_kw)
        sfx = "_i8" if ingest == "int8" else ""
        block = (block_c64 if ingest == "complex64"
                 else quantize_c64(block_c64, STEP))
        vis = {}
        for route, fused in (("kernel", True), ("plain", False)):
            eng = FxEngine(cfg, fused=fused)
            if fused and eng.fir_mode != fir_mode:
                raise AssertionError(f"{tag} engine fir_mode {eng.fir_mode}")
            iq, h = eng.prepare_block(block), eng.fresh_history()
            vis[route], _ = eng.step(iq, d, h)
            steps[route + sfx] = (lambda e=eng, i=iq, hh=h: e.step(i, d, hh))
            if fused:   # the main path's copy: framed on the host, then sent
                copies[ingest] = (lambda e=eng, b=block: e.prepare_block(b))
        verr = ((vis["kernel"] - vis["plain"]).abs().max()
                / vis["plain"].abs().max()).item()
        print(f"  [{tag} {ingest}] engine step, kernel route ({fir_mode}) "
              f"against plain route: {verr:.3g} of max|vis|", flush=True)
        if not verr <= tol:
            raise AssertionError(f"{tag} {ingest} engine routes disagree: "
                                 f"{verr} > {tol}")
    return steps, copies


def time_flagship(device):
    """Phase 4 at the flagship: each direct-loop kernel and the
    spectrometer vs its plain version, the engine step on either route
    for both ingests, one block's copy to the card, and the device
    launches of one call of each wrapper."""
    import torch

    from fxtpu_torch.ops.fx_fused import (fx_fused_raw, fx_fused_raw_i8,
                                          fx_fused_raw_i8_reference,
                                          fx_fused_raw_reference)
    from fxtpu_torch.ops.spectrometer import (spectrometer_fused,
                                              spectrometer_fused_reference)
    from fxtpu_torch.ops.xengine import pack_delays
    from fxtpu_torch.probes.ablate import device_times
    w, _, pairs, blocks, hist = make_case(FLAGSHIP, np.random.default_rng(7),
                                          device)
    x = blocks[0]
    _, _, _, blocks8, hist8 = make_case_i8(FLAGSHIP,
                                           np.random.default_rng(9), device)
    x8 = blocks8[0]
    sc = SPEC_CASES[-1]
    ws, sblocks, shist = make_spec_case(sc, np.random.default_rng(10),
                                        device)
    xs, nb = sblocks[0], sc["nbins"]
    wm, _, pm, mblocks, mhist = make_case(MANY_PAIRS,
                                          np.random.default_rng(21), device)
    xm = mblocks[0]
    _, _, _, mblocks8, mhist8 = make_case_i8(
        MANY_PAIRS, np.random.default_rng(22), device)
    xm8 = mblocks8[0]
    kt = cuda_times({
        "plain": lambda: fx_fused_raw_reference(x, hist, w, pairs),
        "kernel": lambda: fx_fused_raw(x, hist, w, pairs),
        "plain_i8": lambda: fx_fused_raw_i8_reference(x8, hist8, w, pairs,
                                                      STEP),
        "kernel_i8": lambda: fx_fused_raw_i8(x8, hist8, w, pairs, STEP),
        "plain_spec": lambda: spectrometer_fused_reference(xs, ws, nb, shist),
        "kernel_spec": lambda: spectrometer_fused(xs, ws, nb, shist),
        "plain_many": lambda: fx_fused_raw_reference(xm, mhist, wm, pm),
        "kernel_many": lambda: fx_fused_raw(xm, mhist, wm, pm),
        "plain_many_i8": lambda: fx_fused_raw_i8_reference(xm8, mhist8, wm,
                                                           pm, STEP),
        "kernel_many_i8": lambda: fx_fused_raw_i8(xm8, mhist8, wm, pm, STEP),
    })
    # the many-pairs kernels' device time: pre-pass + frame kernel + reduce
    for key, fn in (("device_us_many",
                     lambda: fx_fused_raw(xm, mhist, wm, pm)),
                    ("device_us_many_i8",
                     lambda: fx_fused_raw_i8(xm8, mhist8, wm, pm, STEP))):
        kt[key] = sum(device_times(fn).values())
    rng = np.random.default_rng(8)
    iq_np = (rng.normal(size=(2, 2**18, 2)) @ np.array([1.0, 1j])
             ).astype(np.complex64)
    d = torch.as_tensor(pack_delays([0.0, 2e-6], 1.4204e9), device=device)
    steps, copies = engine_steps({}, iq_np, d, REL_TOL, "direct", "flagship")
    counts = {
        "fx_fused_raw": count_device_launches(
            lambda: fx_fused_raw(x, hist, w, pairs)),
        "fx_fused_raw_i8": count_device_launches(
            lambda: fx_fused_raw_i8(x8, hist8, w, pairs, STEP)),
        "spectrometer_fused": count_device_launches(
            lambda: spectrometer_fused(xs, ws, nb, shist)),
    }
    return kt, cuda_times(steps), host_times(copies), counts


def time_wideband(device):
    """Phase 4 at the wideband shape: per ingest the SVD-FIR kernel, the
    direct-loop kernel and both plain versions; the engine step on either
    route (the kernel route in the SVD mode), one block's copy, and the
    device launches of one step on the kernel route."""
    import torch

    from fxtpu_torch.ops.fx_fused import (fx_fused_raw, fx_fused_raw_i8,
                                          fx_fused_raw_i8_reference,
                                          fx_fused_raw_reference)
    from fxtpu_torch.ops.xengine import pack_delays
    w, svd, pairs, blocks, hist = make_case(
        WIDEBAND, np.random.default_rng(11), device, "svd")
    x = blocks[0]
    _, _, _, blocks8, hist8 = make_case_i8(
        WIDEBAND, np.random.default_rng(12), device, "svd")
    x8 = blocks8[0]
    kt = cuda_times({
        "plain_svd": lambda: fx_fused_raw_reference(x, hist, w, pairs, svd),
        "svd": lambda: fx_fused_raw(x, hist, w, pairs, svd),
        "direct": lambda: fx_fused_raw(x, hist, w, pairs),
        "plain_direct": lambda: fx_fused_raw_reference(x, hist, w, pairs),
        "plain_svd_i8": lambda: fx_fused_raw_i8_reference(
            x8, hist8, w, pairs, STEP, svd),
        "svd_i8": lambda: fx_fused_raw_i8(x8, hist8, w, pairs, STEP, svd),
        "direct_i8": lambda: fx_fused_raw_i8(x8, hist8, w, pairs, STEP),
        "plain_direct_i8": lambda: fx_fused_raw_i8_reference(
            x8, hist8, w, pairs, STEP),
    }, n=20)
    del blocks, blocks8
    rng = np.random.default_rng(13)
    iq_np = (rng.normal(size=(2, WIDEBAND["nsamp"], 2)) @ np.array([1.0, 1j])
             ).astype(np.complex64)
    d = torch.as_tensor(pack_delays([0.0, 2e-6], 1.4204e9), device=device)
    shape = dict(nbins=WIDEBAND["nbins"], ntaps=WIDEBAND["ntaps"],
                 num_samp=WIDEBAND["nsamp"], clamp_num_samp=False)
    steps, copies = engine_steps(shape, iq_np, d, DEEP_TOL, "svd", "wideband")
    counts = {"wideband_step": count_device_launches(steps["kernel"]),
              "wideband_step_i8": count_device_launches(steps["kernel_i8"])}
    return kt, cuda_times(steps, n=20), host_times(copies, n=10), counts


def time_multi_kernels(device):
    """Phase 4, per block: one K = 8 launch of each K-block entry against
    8 chained one-block launches and the plain version, at the flagship
    (direct loop) and at the CLI's deep-tap block (SVD)."""
    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    out = {}
    for tag, case, fir in (("flagship", FLAGSHIP, "direct"),
                           ("deep", DEEP_CLI, "svd")):
        for int8 in (False, True):
            multi, ref, single = multi_entries(int8)
            w, svd = window_and_fir(case, fir, device)
            pairs = pairs_tensor(baseline_pairs(case["nch"]), case["nch"],
                                 device)
            arg = (STEP,) if int8 else ()
            x = merged_batch(case, MULTI_K, np.random.default_rng(17),
                             device, int8)
            xs = [x[:, j].contiguous() for j in range(MULTI_K)]
            h = fresh_history(case, device, int8)

            def singles(xs=xs, h=h, w=w, pairs=pairs, arg=arg, svd=svd,
                        single=single):
                for xj in xs:
                    _, h = single(xj, h, w, pairs, *arg, svd)

            t = cuda_times({
                "multi": lambda: multi(x, h, w, pairs, *arg, svd),
                "singles": singles,
                "plain": lambda: ref(x, h, w, pairs, *arg, svd),
            }, n=20 if tag == "flagship" else 6, warm=2)
            key = tag + ("_i8" if int8 else "")
            out[key] = {k: v / MULTI_K for k, v in t.items()}
            del x, xs
    return out


def time_multi_step(device):
    """Phase 4 at the flagship, per block: the engine's ``multi_step``
    over K = 8 blocks against ``step`` (checking that block 0 of the one
    is the other bit for bit), and 8 blocks' copy through a pinned buffer
    on a side stream (``prepare_batch``, the stager's copy) against 8
    pageable ``prepare_block`` copies, by the host clock; and the device
    launches (kernels, copies, memsets) of one call of each step."""
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops.xengine import pack_delays
    from fxtpu_torch.runtime.native import quantize_c64
    rng = np.random.default_rng(19)
    c64 = [(rng.normal(size=(2, FLAGSHIP["nsamp"], 2)) @ np.array([1.0, 1j])
            ).astype(np.complex64) for _ in range(MULTI_K)]
    steps, copies = {}, {}
    side = torch.cuda.Stream(device)
    for ingest in ("complex64", "int8"):
        sfx = "_i8" if ingest == "int8" else ""
        eng = FxEngine(CorrelatorConfig(device="cuda", ingest_dtype=ingest,
                                        quant_step=STEP), fused=True)
        blocks = c64 if ingest == "complex64" else [
            quantize_c64(b, STEP) for b in c64]
        freq = eng.cfg.frequency
        d1 = torch.as_tensor(pack_delays([0.0, TRUE_DELAY], freq),
                             device=device)
        dk = torch.as_tensor(pack_delays(
            np.tile([0.0, TRUE_DELAY], (MULTI_K, 1)), freq), device=device)
        h = eng.fresh_history()
        iq_k, iq_1 = eng.prepare_batch(blocks), eng.prepare_block(blocks[0])
        vk, _ = eng.multi_step(iq_k, dk, h)
        v1, _ = eng.step(iq_1, d1, h)
        if not torch.equal(vk[0], v1):
            raise AssertionError(f"multi_step block 0 is not step ({ingest})")
        steps["multi_step" + sfx] = (
            lambda e=eng, i=iq_k, hh=h, d=dk: e.multi_step(i, d, hh))
        steps["step" + sfx] = (
            lambda e=eng, i=iq_1, hh=h, d=d1: e.step(i, d, hh))
        host = eng.batch_host_buffer(MULTI_K)

        def pinned(e=eng, b=blocks, host=host):
            with torch.cuda.stream(side):
                e.prepare_batch(b, host)
            side.synchronize()

        copies["pinned" + sfx] = pinned
        copies["pageable" + sfx] = (
            lambda e=eng, b=blocks: [e.prepare_block(x) for x in b])
    st = cuda_times(steps, n=30)
    ct = host_times(copies, n=10)
    st = {k: v / MULTI_K if k.startswith("multi") else v
          for k, v in st.items()}
    counts = {k: count_device_launches(fn) for k, fn in steps.items()}
    return st, {k: v / MULTI_K for k, v in ct.items()}, counts


def kernel_us(events):
    """Median device time (us) per kernel of a list of device events, by
    the part of its name that says which it is; copies as ``copy``."""
    names = {"mean_partial_kernel": "prepass", "fx_frames_kernel": "frames",
             "fx_parts_reduce_kernel": "reduce", "fx_reduce": "reduce",
             "fx_finish_kernel": "finish", "fx_xstage_kernel": "xstage",
             "fir_rows_kernel": "fir", "fx_wide_halves_kernel": "frames"}
    durs = {}
    for e in events:
        key = "copy" if e["cat"] == "gpu_memcpy" else next(
            (v for k, v in names.items() if k in e["name"]), "other")
        durs.setdefault(key, []).append(e["dur"])
    return {k: statistics.median(v) for k, v in durs.items()}


def time_single_pass(device):
    """Phase 4, the single pass against the two-pass form of the fused
    route, both in this process and timed in turns (A B B A): the engine's
    ``step`` and ``multi_step`` (K = 8, per block) at the flagship in both
    ingests and ``step`` at ``bench_pipeline``'s block; one block's copy
    to the card, pinned (``prepare_block``; and the same through numpy's
    ``copyto``) against pageable, by the host's clock (to a synchronize)
    and by CUDA events around the call;
    each wrapper's call and
    its plain version at the flagship.  Counts the device launches of one
    single-pass step and raises when they are more than 3 or the mean
    pre-pass is among them.  Returns (times ms, launches per call, device
    us per kernel)."""
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.ops.xengine import pack_delays
    from fxtpu_torch.probes.common import device_events
    from fxtpu_torch.runtime.native import quantize_c64
    rng = np.random.default_rng(23)
    steps, copies, launches, device_us = {}, {}, {}, {}
    keep = []
    for tag, shape in (("flagship", {}), ("pipeline", dict(
            num_samp=PIPELINE_BLOCK["nsamp"], nbins=PIPELINE_BLOCK["nbins"],
            clamp_num_samp=False))):
        for ingest in ("complex64", "int8"):
            sfx = ("" if tag == "flagship" else "_pipeline") + (
                "_i8" if ingest == "int8" else "")
            cfg = CorrelatorConfig(device="cuda", ingest_dtype=ingest,
                                   quant_step=STEP, **shape)
            eng = FxEngine(cfg)
            forms = {"new": (eng.step, eng.multi_step),
                     "old": two_pass_steps(eng)}
            k = MULTI_K if tag == "flagship" else 1
            blocks = [(rng.normal(size=(2, cfg.num_samp, 2))
                       @ np.array([1.0, 1j])).astype(np.complex64)
                      for _ in range(k)]
            if ingest == "int8":
                blocks = [quantize_c64(b, STEP) for b in blocks]
            d1 = torch.as_tensor(pack_delays([0.0, TRUE_DELAY],
                                             cfg.frequency), device=device)
            iq, h = eng.prepare_block(blocks[0]), eng.fresh_history()
            iqk = eng.prepare_batch(blocks) if tag == "flagship" else None
            dk = d1.expand(k, *d1.shape).contiguous()
            for name, (step, multi) in forms.items():
                steps[f"step_{name}{sfx}"] = (
                    lambda f=step, i=iq, hh=h: f(i, d1, hh))
                if tag == "flagship":
                    steps[f"multi_step_{name}{sfx}"] = (
                        lambda f=multi, i=iqk, hh=h, d=dk: f(i, d, hh))
            framed = torch.from_numpy(blocks[0]).reshape(
                2, -1, cfg.nbins, *blocks[0].shape[2:])
            copies["pinned" + sfx] = (
                lambda e=eng, b=blocks[0]: e.prepare_block(b))
            copies["pageable" + sfx] = lambda f=framed: f.to(device)
            host = torch.empty(framed.shape, dtype=framed.dtype,
                               pin_memory=True)
            # the pinned route with numpy's single-threaded copy in place
            # of torch's threaded one (what prepare_block does not do)
            copies["pinned_numpy" + sfx] = (
                lambda h=host, f=framed: (np.copyto(h.numpy(), f.numpy()),
                                          h.to(device, non_blocking=True)))
            keep.append((eng, blocks))
    for fn in (*steps.values(), *copies.values()):
        fn()        # the first call forms the window's constants and pins
    torch.cuda.synchronize()
    for key, fn in steps.items():
        events = device_events(fn, 3)
        launches[key] = len(events) // 3
        us = kernel_us(events)
        per = MULTI_K if key.startswith("multi") else 1
        device_us[key] = {k: v / per for k, v in us.items() if k != "other"}
        names = sorted({e["name"][:60] for e in events})
        if "_new" in key and (launches[key] > 3 or "prepass" in us
                              or "other" in us):
            raise AssertionError(
                f"{key}: {launches[key]} device launches a call ({names}): "
                "a single-pass step is the frame kernel, the reduce and the "
                "epilogue, and no mean pre-pass")
    ce = cuda_times(copies, n=10, warm=2)
    st = cuda_times(steps, n=20, warm=3)
    st = {k: v / MULTI_K if k.startswith("multi") else v
          for k, v in st.items()}
    ct = host_times(copies, n=10)
    # the wrappers alone, at the flagship
    w, _, pairs, blocks, hist = make_case(FLAGSHIP, np.random.default_rng(7),
                                          device)
    _, _, _, blocks8, hist8 = make_case_i8(FLAGSHIP,
                                           np.random.default_rng(9), device)
    x, x8 = blocks[0][:, None], blocks8[0][:, None]
    from fxtpu_torch.ops.dc_posthoc import dc_constants
    s_rows = FLAGSHIP["nsamp"] // FLAGSHIP["nbins"]
    consts = dc_constants(w.cpu().numpy(), FLAGSHIP["nbins"], s_rows, device)
    parts = ff.fx_fused_parts(x, hist, w, pairs, None, consts)
    tables = fe.FinishTables(np.array([[0, 1]]), FLAGSHIP["nbins"], 2.4e6,
                             1.4204e9, device)
    d = torch.as_tensor(pack_delays([[0.0, TRUE_DELAY]], 1.4204e9),
                        device=device)
    kt = cuda_times({
        "parts": lambda: ff.fx_fused_parts(x, hist, w, pairs, None, consts),
        "parts_plain": lambda: ff.fx_fused_parts_reference(
            x, hist, w, pairs, None, consts),
        "parts_i8": lambda: ff.fx_fused_parts_i8(
            x8, hist8["tail"], w, pairs, STEP, None, consts),
        "parts_i8_plain": lambda: ff.fx_fused_parts_i8_reference(
            x8, hist8["tail"], w, pairs, STEP, None, consts),
        "finish": lambda: fe.fx_finish(*parts[:4], pairs, consts, d, tables,
                                       s_rows, 2.4e6, False),
        "finish_plain": lambda: fe.fx_finish_reference(
            *parts[:4], pairs, consts, d, tables, s_rows, 2.4e6, False),
    }, n=20, warm=3)
    # the epilogue launched alone (no predecessor to wait for)
    kt["finish_device_us"] = statistics.median(e["dur"] for e in device_events(
        lambda: fe.fx_finish(*parts[:4], pairs, consts, d, tables, s_rows,
                             2.4e6, False), 5))
    del keep
    return {**st, **{"copy_" + k: v for k, v in ct.items()},
            **{"copy_events_" + k: v for k, v in ce.items()}, **kt}, \
        launches, device_us


def xstage_bound(case, k):
    """The least time the card could take for one X kernel launch over k
    blocks of ``case``: its bytes (the spectra in once, the pairs and dA
    in, the parts out once) over the device-memory rate, or its
    operations (8 per cross pair, frame and bin, 4 per auto pair, 2 per
    channel, frame and bin for T, 8 per channel, halo frame and bin for
    GJ) over the float32 rate.  Returns (ms, "bytes" or "operations")."""
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    s = case["nsamp"] // nbins
    autos = nch if case.get("autos") else 0
    nbl = nch * (nch - 1) // 2 + autos
    nbytes = (8 * k * nch * s * nbins + 8 * nbl + 8 * (ntaps - 1) * nbins
              + 8 * k * (nbl + 2 * nch) * nbins)
    flops = (k * s * nbins * (8 * (nbl - autos) + 4 * autos + 2 * nch)
             + 8 * k * nch * (ntaps - 1) * nbins)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


def time_wide(device):
    """Phase 4, the wide route at 8 channels: the single-pass wrapper on
    its wide route and its plain version at bench.py's nchan8 block and
    at the CLI's 8-channel deep-tap block (SVD) in both ingests (CUDA
    events; the device us of each kernel of a call); the X kernel alone at
    the nchan8 block against its plain version and one ``torch.matmul``
    of the spectra, ``[nbins, nch, S] @ [nbins, S, nch]`` conjugated (its
    ``library_ms``, TF32 off; the port never calls it); the engine's step
    at the nchan8 block on either route, held to each other, with the
    device launches of a kernel-route step, which fails the run above 4
    (frames, X, epilogue and at most one more) or with a mean pre-pass
    among them.  Returns (times ms, device us per kernel, launches)."""
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.ops.dc_posthoc import dc_constants
    from fxtpu_torch.ops.fx_xstage import fx_xstage, fx_xstage_reference
    from fxtpu_torch.ops.xengine import pack_delays
    from fxtpu_torch.probes.common import device_events
    from fxtpu_torch.runtime.native import quantize_c64
    fns, dev_us, launches, keep = {}, {}, {}, []
    rng = np.random.default_rng(41)
    for tag, case, fir in (("nchan8", NCHAN8, "direct"),
                           ("cli8", CLI8, "direct"), ("deep8", DEEP8, "svd")):
        nch, nbins = case["nch"], case["nbins"]
        s = case["nsamp"] // nbins
        w, svd = window_and_fir(case, fir, device)
        pairs = pairs_tensor(baseline_pairs(nch, case["autos"]), nch,
                             device)
        consts = dc_constants(w.cpu().numpy(), nbins, s, device, svd)
        for int8 in (False, True):
            key = tag + ("_i8" if int8 else "")
            x = parts_batch(case, 1, rng, device, int8)
            hist = raw_history(case, rng, device, int8)
            if int8:
                args = (x, hist["tail"], w, pairs, STEP, svd, consts)
                entry, ref = (ff.fx_fused_parts_i8,
                              ff.fx_fused_parts_i8_wide_reference)
            else:
                args = (x, hist, w, pairs, svd, consts)
                entry, ref = (ff.fx_fused_parts,
                              ff.fx_fused_parts_wide_reference)
            fns["parts_" + key] = lambda e=entry, a=args: e(*a)
            fns["plain_" + key] = lambda r=ref, a=args: r(*a)
            fns["parts_" + key]()
            torch.cuda.synchronize()
            dev_us[key] = kernel_us(device_events(fns["parts_" + key], 3))
            keep.append(args)
    times = cuda_times(fns, n=10, warm=2)
    for tag, case in (("", NCHAN8), ("_cli8", CLI8)):
        spec, pairs, da = xstage_inputs(case, 1, device)
        a = spec[0].permute(2, 0, 1).contiguous()      # [nbins, nch, S]
        ah = a.conj().transpose(1, 2)                  # [nbins, S, nch]
        gram = torch.matmul(a, ah)
        xs = fx_xstage(spec, pairs, da)
        torch.cuda.synchronize()
        # the yardstick computes what the kernel computes for the pairs
        p, q = pairs[:, 0].long(), pairs[:, 1].long()
        gerr = ((gram[:, p, q].T - xs[0, :pairs.shape[0]]).abs().max()
                / xs[0, :pairs.shape[0]].abs().max()).item()
        print(f"  torch.matmul Gram against fx_xstage{tag}: {gerr:.3g} of "
              "max|xp|", flush=True)
        if not gerr <= REL_TOL:
            raise AssertionError(f"the Gram yardstick disagrees: {gerr}")
        times.update(cuda_times({
            "xstage" + tag: lambda: fx_xstage(spec, pairs, da),
            "xstage_plain" + tag: lambda: fx_xstage_reference(spec, pairs,
                                                              da),
            "xstage_library" + tag: lambda: torch.matmul(a, ah),
        }, n=20, warm=3))
        dev_us["xstage_alone" + tag] = kernel_us(device_events(
            lambda: fx_xstage(spec, pairs, da), 3))
        dev_us["xstage_library" + tag] = kernel_us(device_events(
            lambda: torch.matmul(a, ah), 3)).get("other")
        del spec, a, ah, gram, xs
    # the engine's step at the nchan8 block on either route
    block = (rng.normal(size=(NCHAN8["nch"], NCHAN8["nsamp"], 2))
             @ np.array([1.0, 1j]) + (0.02 - 0.01j)).astype(np.complex64)
    steps = {}
    for ingest in ("complex64", "int8"):
        sfx = "_i8" if ingest == "int8" else ""
        cfg = CorrelatorConfig(device="cuda", ingest_dtype=ingest,
                               quant_step=STEP, nchan=NCHAN8["nch"],
                               include_autos=True, num_samp=NCHAN8["nsamp"],
                               nbins=NCHAN8["nbins"], clamp_num_samp=False)
        blk = block if ingest == "complex64" else quantize_c64(block, STEP)
        d = torch.as_tensor(pack_delays(
            TRUE_DELAY * (np.arange(NCHAN8["nch"]) > 0), cfg.frequency),
            device=device)
        vis = {}
        for route, fused in (("kernel", "auto"), ("plain", False)):
            eng = FxEngine(cfg, fused=fused)
            if fused == "auto" and not (eng.kernel_active
                                        and eng.x_stage == "global"):
                raise AssertionError(f"nchan8 {ingest}: the engine does "
                                     "not take the wide route's kernels")
            iq, h = eng.prepare_block(blk), eng.fresh_history()
            vis[route], _ = eng.step(iq, d, h)
            steps[f"step_{route}{sfx}"] = (
                lambda e=eng, i=iq, hh=h: e.step(i, d, hh))
            keep.append((eng, iq, h))
        tol = DEEP_TOL if ingest == "int8" else REL_TOL
        verr = ((vis["kernel"] - vis["plain"]).abs().max()
                / vis["plain"].abs().max()).item()
        print(f"  [nchan8 {ingest}] engine step, kernel route (wide) "
              f"against plain route: {verr:.3g} of max|vis|", flush=True)
        if not verr <= tol:
            raise AssertionError(f"nchan8 {ingest} engine routes disagree: "
                                 f"{verr} > {tol}")
        events = device_events(steps["step_kernel" + sfx], 3)
        launches["step" + sfx] = len(events) // 3
        us = kernel_us(events)
        dev_us["step" + sfx] = {k: v for k, v in us.items() if k != "other"}
        names = sorted({e["name"][:60] for e in events})
        if launches["step" + sfx] > 4 or "prepass" in us or "other" in us:
            raise AssertionError(
                f"nchan8 {ingest} step: {launches['step' + sfx]} device "
                f"launches ({names}): a wide-route step is the frame "
                "kernel, the X kernel and the epilogue, at most 4 "
                "launches, no mean pre-pass")
    times.update(cuda_times(steps, n=10, warm=2))
    del keep
    return times, dev_us, launches


def time_nchan512(device):
    """Phase 4 at LEDA's block (NCHAN512, one block): the X kernel alone on
    its spectra (the band instance) and the epilogue alone on the X
    kernel's parts (the narrow pair-tiled instance, SPECTRUM, packed
    delays within 8 samples, a carried mean), each by CUDA events (ms a
    launch) and by its device time (us).  Returns ({"xstage", "finish"}:
    ms, the same: device us)."""
    import torch

    from fxtpu_torch.ops import baseline_pairs
    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops.dc_posthoc import dc_constants
    from fxtpu_torch.ops.fx_xstage import fx_xstage
    from fxtpu_torch.ops.xengine import pack_delays
    from fxtpu_torch.probes.common import device_events
    case = NCHAN512
    nch, nbins = case["nch"], case["nbins"]
    s = case["nsamp"] // nbins
    bw, freq = 98.304e6, 49.152e6
    spec, pairs, da = xstage_inputs(case, 1, device)
    parts = fx_xstage(spec, pairs, da)
    nbl = pairs.shape[0]
    w, _ = window_and_fir(case, "direct", device)
    rng = np.random.default_rng(512)

    def means(*shape):
        z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor((0.1 * z).astype(np.complex64), device=device)

    fin = (parts[:, :nbl], parts[:, nbl:nbl + nch], parts[:, nbl + nch:],
           means(1, nch), pairs, dc_constants(w.cpu().numpy(), nbins, s,
                                              device),
           torch.as_tensor(pack_delays(rng.uniform(-8, 8, (1, nch)) / bw,
                                       freq), device=device),
           fe.FinishTables(baseline_pairs(nch, True), nbins, bw, freq,
                           device), s, bw, False, means(nch))
    fns = {"xstage": lambda: fx_xstage(spec, pairs, da),
           "finish": lambda: fe.fx_finish(*fin)}
    ms = cuda_times(fns, n=10, warm=2)
    us = {key: kernel_us(device_events(fn, 3))[key]
          for key, fn in fns.items()}
    for key in fns:
        bound = (xstage_bound if key == "xstage" else finish_bound)(case, 1)
        print(f"  [nchan512] {key} alone {ms[key]:.4f} ms, device "
              f"{us[key]:.1f} us, least {bound[0]:.4f} ms ({bound[1]})",
              flush=True)
    del spec, parts, fin
    torch.cuda.empty_cache()
    return ms, us


def time_x_routes(device):
    """Phase 4, the single pass's two X stages at shapes both take: the
    wrapper with ``x_stage`` "shared" and "global" at the flagship block,
    at K = 8 of them and at ``bench_pipeline``'s block, in both ingests,
    timed in turns
    (A B B A) with CUDA events in this process, with the device us of each
    kernel of a call.  Returns (times ms, device us), keyed
    ``<shape>[_i8]_<x_stage>``."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.ops.dc_posthoc import dc_constants
    from fxtpu_torch.probes.common import device_events
    rng = np.random.default_rng(43)
    fns, dev_us, keep = {}, {}, []
    for tag, case, k in (("flagship", FLAGSHIP, 1),
                         ("flagship_k8", FLAGSHIP, 8),
                         ("pipeline", PIPELINE_BLOCK, 1)):
        nch, nbins = case["nch"], case["nbins"]
        s = case["nsamp"] // nbins
        w, _ = window_and_fir(case, "direct", device)
        pairs = pairs_tensor(baseline_pairs(nch, case["autos"]), nch,
                             device)
        consts = dc_constants(w.cpu().numpy(), nbins, s, device)
        for int8 in (False, True):
            x = parts_batch(case, k, rng, device, int8)
            hist = raw_history(case, rng, device, int8)
            if int8:
                entry = ff.fx_fused_parts_i8
                args = (x, hist["tail"], w, pairs, STEP, None, consts)
            else:
                entry, args = ff.fx_fused_parts, (x, hist, w, pairs, None,
                                                  consts)
            keep.append(args)
            for stage in ("shared", "global"):
                key = f"{tag}{'_i8' if int8 else ''}_{stage}"
                fns[key] = lambda e=entry, a=args, st=stage: e(*a,
                                                               x_stage=st)
                fns[key]()
                torch.cuda.synchronize()
                dev_us[key] = kernel_us(device_events(fns[key], 3))
    times = cuda_times(fns, n=20, warm=3)
    del keep
    return times, dev_us


def host_times(fns, n=30, warm=3):
    """Median ms per call of each fn by the host clock, each call ended
    by a synchronize, in turns (a, b, b, a)."""
    import torch
    samples = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for key in order:
        for _ in range(warm):
            fns[key]()
        torch.cuda.synchronize()
        for _ in range(n):
            t0 = time.perf_counter()
            fns[key]()
            torch.cuda.synchronize()
            samples[key].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in samples.items()}


def step_pair(tag, case, k, fir, cont, int8, device):
    """Phase 4: the step's arguments at one of STEP_CASES and its two forms
    on them, ``{"two_call": fn, "one_call": fn}``: the parent tree's
    (``two_call_step``) and ``fx_fused_step`` with a scratch pool kept
    across calls, as the engine calls it."""
    from fxtpu_torch.ops import fx_epilogue as fe
    args = step_inputs(case, k, fir, int8, True, cont, device, seed=97)
    pool = {}
    return args, {"two_call": lambda: two_call_step(args),
                  "one_call": lambda: fe.fx_fused_step(*args, pool=pool)}


def time_steps(device):
    """Phase 4, Part 1's A/B in one process: at each of STEP_CASES but
    the deep ones, in both ingests, the two-call step against the one C
    call, timed in turns (A B B A): event ms a step, device us a step by
    kernel, the epilogue's exposed us and the step's span on the device
    (``probes.common.step_exposed_us`` of a CUDA-only trace);
    each one-call step must launch 3 kernels on the device.  Returns
    {tag: {...}}."""
    import torch

    from fxtpu_torch.probes.common import device_events, step_exposed_us
    out = {}
    for tag, case, k, fir, cont in STEP_CASES:
        if fir != "direct":
            continue
        for int8 in (False, True):
            key = tag + ("_i8" if int8 else "")
            args, forms = step_pair(tag, case, k, fir, cont, int8, device)
            for fn in forms.values():
                fn()
            torch.cuda.synchronize()
            ms = cuda_times(forms, n=20, warm=3)
            rec = {"event_ms": ms}
            for form, fn in forms.items():
                events = device_events(fn, 5)
                per = len(events) // 5
                if form == "one_call" and per != 3:
                    raise AssertionError(f"{key}: the step entry launched "
                                         f"{per} kernels a step")
                us = kernel_us(events)
                rec[form] = {"launches": per, "device_us": us,
                             "device_us_sum": sum(us.values())}
                rec[form]["exposed_us"], rec[form]["span_us"] = (
                    step_exposed_us(events, per))
            out[key] = rec
            print(f"  step A/B {key} (K={k}): event ms two-call "
                  f"{ms['two_call']:.4f} / one call {ms['one_call']:.4f}; "
                  f"device us {rec['two_call']['device_us']} / "
                  f"{rec['one_call']['device_us']}; epilogue exposed us "
                  f"{rec['two_call']['exposed_us']:.3f} / "
                  f"{rec['one_call']['exposed_us']:.3f}; span us "
                  f"{rec['two_call']['span_us']:.3f} / "
                  f"{rec['one_call']['span_us']:.3f}", flush=True)
            del args, forms
    return out


def host_split(device, n=200):
    """Phase 4: one flagship step's host time (K = 1, complex64 and int8)
    split by ``time.perf_counter`` into its checks, its allocations, its
    ctypes call(s) and the rest (the whole call less those three; the
    rest holds the Python between them, the argument marshalling and the
    launch counters), each the mean of ``n`` calls, for the two-call form
    and for the one C call.  The two-call form's checks are
    ``fx_fused.plan_parts`` (the checks, the FIR table, the twiddles and
    the shape plan, which its launch used to work out within "rest") and
    the epilogue's; the one call's are ``fx_epilogue.check_step``.
    Returns {form_ingest: {part: us}}."""
    import ctypes

    import torch

    from fxtpu_torch.cuda_build import load_kernels
    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops import fx_fused as ff
    lib = load_kernels()

    def mean_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t

    out = {}
    for int8 in (False, True):
        sfx = "_i8" if int8 else ""
        args = step_inputs(FLAGSHIP, 1, "direct", int8, True, False, device,
                           seed=98)
        x, hist, w, pairs, consts, delays, tables, bw, cont, step, svd = args
        tail = hist["tail"] if int8 else hist
        stream = torch.cuda.current_stream(device).cuda_stream
        # the two-call form's pieces, as fx_fused_parts* and fx_finish make
        # them (fx_fused.plan_parts and launch_parts, fx_epilogue.fx_finish)
        vis, mu, new, (xp, t, gj) = two_call_step(args)
        nch, k, s_rows, nbins = x.shape[:4]
        nbl = pairs.shape[0]
        rows = nbl + 2 * nch
        plan = fe.check_step(*args)
        n_groups, per = plan.n_groups, plan.per
        abar, da, cs, cab, cbb = consts

        def old_checks():
            ff.plan_parts(x, tail, w, pairs, svd, consts, step)
            for name, tt, shape in (("xp", xp, (k, nbl, nbins)),
                                    ("T", t, (k, nch, nbins)),
                                    ("GJ", gj, (k, nch, nbins))):
                fe._rows_stride(name, tt, shape)
            dl, packed = fe._check_delays(delays, k, nch, nbl, x.device)
            small = [("mu", mu, torch.complex64, (k, nch)),
                     ("pairs", pairs, torch.int32, (nbl, 2)),
                     ("abar", abar, torch.complex64, (nbins,)),
                     ("cs", cs, torch.float32, (nbins,)),
                     ("cab", cab, torch.complex64, (nbins,)),
                     ("cbb", cbb, torch.float32, (nbins,)),
                     ("freqs", tables.fbase, torch.float32, (nbins,))]
            if int8:
                small.append(("mu_prev", hist["mu_prev"], torch.complex64,
                              (nch,)))
            fe._check_small(small, x.device)

        def old_allocs():
            c64 = dict(dtype=torch.complex64, device=device)
            torch.empty((k, rows, nbins), **c64)
            torch.empty((k, n_groups, rows, nbins), **c64)
            torch.empty((k, n_groups, nch, 2), device=device,
                        dtype=torch.int64 if int8 else torch.float64)
            torch.empty((k, nch), **c64)
            torch.empty_like(tail)
            torch.empty((k, nbl, nbins), **c64)

        pool = {}
        bufs = fe.step_buffers(plan, pool)
        parts = bufs["parts"]
        ptr = [tt.data_ptr() for tt in (
            x, tail, w, plan.tw, pairs, da, bufs["sums"],
            bufs["scratch"], parts, bufs["mu"], bufs["new_hist"])]
        extra = (step,) if int8 else ()
        parts_entry = lib.fxt_fx_parts_i8 if int8 else lib.fxt_fx_parts
        fin_ptr = [tt.data_ptr() for tt in (
            abar, cs, cab, cbb, delays, tables.fbase, bufs["vis"])]
        mu_prev = hist["mu_prev"].data_ptr() if int8 else None

        def old_ctypes():
            parts_entry(*ptr[:3], None, *ptr[3:], nch, k, s_rows, nbins,
                        w.shape[0], nbl, n_groups, per, *extra, stream)
            lib.fxt_fx_finish(
                ptr[8], ptr[8] + 8 * nbl * nbins,
                ptr[8] + 8 * (nbl + nch) * nbins, ptr[9], mu_prev, ptr[4],
                *fin_ptr, rows * nbins, rows * nbins, rows * nbins, k, nbl,
                nch, nbins, 1, 0, s_rows, plan.finish_plan.chunk, bw, stream)

        sargs = fe.step_args(plan, bufs)
        entry = lib.fxt_fx_step_i8 if int8 else lib.fxt_fx_step
        parts_old = {"total": mean_us(lambda: two_call_step(args)),
                     "checks": mean_us(old_checks),
                     "allocations": mean_us(old_allocs),
                     "ctypes": mean_us(old_ctypes)}
        parts_new = {
            "total": mean_us(lambda: fe.fx_fused_step(*args, pool=pool)),
            "checks": mean_us(lambda: fe.check_step(*args)),
            "allocations": mean_us(lambda: fe.step_buffers(plan, pool)),
            "ctypes": mean_us(lambda: entry(ctypes.byref(sargs), stream)),
            "of_the_rest_step_args": mean_us(
                lambda: fe.step_args(plan, bufs))}
        for form, rec in (("two_call", parts_old), ("one_call", parts_new)):
            rec["rest"] = (rec["total"] - rec["checks"] - rec["allocations"]
                           - rec["ctypes"])
            out[form + sfx] = rec
            print(f"  host split, flagship K=1 {form}{sfx} (us a step, mean "
                  f"of {n}): " + ", ".join(f"{key} {v:.2f}"
                                            for key, v in rec.items()),
                  flush=True)
        del args, bufs, pool
    return out


# --------------------------------------------------------------------------
# Scale-out (fxtpu_torch.parallel): meshes of shards on the one card
# --------------------------------------------------------------------------

SCALE_MESHES = ((2, 2), (4, 1))
SCALE_BLOCKS = 3     # chained blocks each mesh step is held over
# (tag, shape, ingest) of the fused frame-sharded step's checks
SCALE_CASES = (("flagship", FLAGSHIP, "complex64"),
               ("flagship", FLAGSHIP, "int8"),
               ("cli8", CLI8, "complex64"))
SCALE_TOL = {"complex64": 2e-5, "int8": 3e-5}   # of max|vis|
MULTI_TOL = 3e-5     # the K-block call against single steps (test_sharded)


def scale_engines(case, ingest, mesh_tf, device, fused=True):
    """(mesh engine, single-device engine, mesh) at ``case`` on one card,
    SPECTRUM, with the mesh's shards all on ``device``."""
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.parallel import make_correlator_mesh
    cfg = CorrelatorConfig(num_samp=case["nsamp"], nbins=case["nbins"],
                           ntaps=case["ntaps"], nchan=case["nch"],
                           include_autos=case["autos"], mode="SPECTRUM",
                           clamp_num_samp=False, ingest_dtype=ingest,
                           device="cuda", fused=fused)
    t, f = mesh_tf
    mesh = make_correlator_mesh(t, f, [device] * (t * f))
    return FxEngine(cfg, mesh=mesh), FxEngine(cfg), mesh


def scale_blocks(case, ingest, k, seed):
    """k blocks of ``case`` from a seed, complex ones with a mean offset
    (the post-hoc DC correction at work)."""
    rng = np.random.default_rng(seed)
    shape = (case["nch"], case["nsamp"])
    if ingest == "int8":
        return [rng.integers(-127, 128, size=(*shape, 2)).astype(np.int8)
                for _ in range(k)]
    return [(rng.normal(size=shape) + 1j * rng.normal(size=shape)
             + (0.02 - 0.01j)).astype(np.complex64) for _ in range(k)]


def history_err(a, b):
    """(largest history difference, whether the int8 tails are equal)."""
    if isinstance(a, dict):
        mu = float((a["mu_prev"] - b["mu_prev"]).abs().max()) / max(
            float(b["mu_prev"].abs().max()), 1e-30)
        return mu, bool((a["tail"] == b["tail"]).all())
    return float((a - b).abs().max()), True


def per_block_volume(mesh, blocks):
    return {k: v // blocks for k, v in mesh.volume.items()}


def check_scale_counts(counts, expect, what):
    """Every count of ``expect`` as given, every other count 0."""
    bad = {k: (v, expect.get(k, 0)) for k, v in counts.items()
           if v != expect.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: launches (got, expected) {bad}")


def scale_fused_step(tag, case, ingest, mesh_tf, device, card):
    """Scale-out check 1: the fused frame-sharded step on a mesh of shards
    of the card over SCALE_BLOCKS chained blocks against the single-device
    fused step, its launches (the single pass and its reduce or X kernel
    once a shard a block, one epilogue a block, nothing else) and its
    collective bytes against the model, then both steps' time per block
    by events.  Returns (counts, record)."""
    import torch
    from fxtpu_torch.parallel.accounting import predicted_volume
    from fxtpu_torch.ops.xengine import pack_delays
    peng, one, mesh = scale_engines(case, ingest, mesh_tf, device)
    n = mesh.size
    if not (peng.kernel_active and peng.step.fused_kernel):
        raise AssertionError(f"scale-out {tag}: not the kernel route")
    int8 = ingest == "int8"
    d = torch.as_tensor(pack_delays(
        1e-7 * np.arange(case["nch"]), peng.cfg.frequency), device=device)
    blocks = scale_blocks(case, ingest, SCALE_BLOCKS, seed=case["nch"])
    reset_counts()
    mesh.reset_volume()
    ph, vis = peng.fresh_history(), []
    for b in blocks:
        v, ph = peng.step(peng.prepare_block(b), d, ph)
        vis.append(v)
    torch.cuda.synchronize()
    counts = read_counts()
    volume = per_block_volume(mesh, SCALE_BLOCKS)
    h1, err = one.fresh_history(), 0.0
    for b, v in zip(blocks, vis):
        v1, h1 = one.step(one.prepare_block(b), d, h1)
        err = max(err, float((v - v1).abs().max() / v1.abs().max()))
    herr, tail_equal = history_err(ph, h1)
    wide = peng.x_stage == "global"
    name = ("fx_parts_wide" if wide else "fx_parts") + ("_i8" if int8 else "")
    expect = {name: n * SCALE_BLOCKS, "fx_finish": SCALE_BLOCKS,
              ("fx_xstage" if wide else "fx_parts_reduce"): n * SCALE_BLOCKS}
    check_scale_counts(counts, expect, f"scale-out {tag} {ingest} {mesh_tf}")
    pred = predicted_volume(nch=case["nch"], nbl=len(peng.pairs),
                            nbins=case["nbins"], num_samp=case["nsamp"],
                            ntaps=case["ntaps"], mesh_time=mesh_tf[0],
                            mesh_freq=mesh_tf[1], fused=True,
                            int8_native=int8)
    if not (err <= SCALE_TOL[ingest] and tail_equal
            and herr <= (MU_TOL if int8 else HIST_TOL) and volume == pred):
        raise AssertionError(
            f"scale-out {tag} {ingest} {mesh_tf}: vis {err:.3g} of scale, "
            f"history {herr:.3g}, tails equal {tail_equal}, bytes {volume} "
            f"against the model {pred}")
    iq_m, iq_1 = peng.prepare_block(blocks[0]), one.prepare_block(blocks[0])
    h_m, h_1 = peng.fresh_history(), one.fresh_history()
    times = cuda_times({"mesh": lambda: peng.step(iq_m, d, h_m),
                        "single": lambda: one.step(iq_1, d, h_1)}, n=20,
                       warm=3)
    print(f"  [{card}] {tag} {ingest} mesh {mesh_tf} ({n} shards, "
          f"{peng.x_stage} route): vis {err:.3g} of max|vis|, history "
          f"{herr:.3g}; launches {counts}; bytes a block {volume}; "
          f"{times['mesh']:.4f} ms a block against the single-device step's "
          f"{times['single']:.4f} ms", flush=True)
    return counts, {"shards": n, "route": peng.x_stage, "max_rel_err": err,
                    "history_err": herr, "bytes_per_block": volume,
                    "ms_per_block": times["mesh"],
                    "single_ms_per_block": times["single"]}


def scale_multi(device, card):
    """Scale-out check 2: the block-parallel K = MULTI_K call on a 4-shard
    mesh against MULTI_K single-device steps (MULTI_TOL of max|vis|,
    history 1e-5), one K/n-block launch of the single pass, its reduce and
    the epilogue a shard, the boundary bytes against the model, and the
    time per block beside the single-device K-block call's."""
    import torch
    from fxtpu_torch.parallel.accounting import predicted_volume_blockdp
    peng, one, mesh = scale_engines(FLAGSHIP, "complex64", (4, 1), device)
    k = peng.dispatch_batch_for(MULTI_K)
    if k != MULTI_K:
        raise AssertionError(f"dispatch_batch_for({MULTI_K}) = {k}")
    blocks = scale_blocks(FLAGSHIP, "complex64", k, seed=8)
    d = torch.zeros((k, 2), device=device)
    d[:, 1] = 2e-7
    reset_counts()
    mesh.reset_volume()
    vis, ph = peng.multi_step(peng.prepare_batch(blocks), d,
                              peng.fresh_history())
    torch.cuda.synchronize()
    counts = read_counts()
    volume = dict(mesh.volume)
    h1, err = one.fresh_history(), 0.0
    for i, b in enumerate(blocks):
        v1, h1 = one.step(one.prepare_block(b), d[i], h1)
        err = max(err, float((vis[i] - v1).abs().max() / v1.abs().max()))
    herr = float((ph - h1).abs().max())
    check_scale_counts(counts, {"fx_parts": 4, "fx_parts_reduce": 4,
                                "fx_finish": 4}, "scale-out K-block call")
    pred = predicted_volume_blockdp(nch=2, nbins=FLAGSHIP["nbins"],
                                    ntaps=FLAGSHIP["ntaps"], n_shards=4)
    if not (err <= MULTI_TOL and herr <= 1e-5 and volume == pred):
        raise AssertionError(f"scale-out K-block call: vis {err:.3g}, "
                             f"history {herr:.3g}, bytes {volume} against "
                             f"{pred}")
    iq_m, iq_1 = peng.prepare_batch(blocks), one.prepare_batch(blocks)
    h_m, h_1 = peng.fresh_history(), one.fresh_history()
    times = cuda_times({"mesh": lambda: peng.multi_step(iq_m, d, h_m),
                        "single": lambda: one.multi_step(iq_1, d, h_1)},
                       n=10, warm=2)
    print(f"  [{card}] K={k} block-parallel call on 4 shards: vis {err:.3g} "
          f"of max|vis|, history {herr:.3g}; launches {counts}; bytes a "
          f"call {volume}; {times['mesh'] / k:.4f} ms a block against the "
          f"single-device K={k} call's {times['single'] / k:.4f} ms",
          flush=True)
    return counts, {"shards": 4, "k": k, "max_rel_err": err,
                    "history_err": herr, "bytes_per_call": volume,
                    "ms_per_block": times["mesh"] / k,
                    "single_ms_per_block": times["single"] / k}


def scale_plain(device, card):
    """Scale-out check 3: the plain step with the corner turn on (2, 2)
    against the plain single-device step (rtol 5e-4, atol 5e-7,
    tests/test_sharded.py:67) over SCALE_BLOCKS chained blocks; no hand
    kernel launches; the bytes against the model."""
    import torch
    from fxtpu_torch.parallel.accounting import predicted_volume
    peng, one, mesh = scale_engines(FLAGSHIP, "complex64", (2, 2), device,
                                    fused=False)
    blocks = scale_blocks(FLAGSHIP, "complex64", SCALE_BLOCKS, seed=12)
    d = torch.tensor([0.0, 3.3e-7], device=device)
    reset_counts()
    mesh.reset_volume()
    ph, h1, worst = peng.fresh_history(), one.fresh_history(), 0.0
    for b in blocks:
        v, ph = peng.step(peng.prepare_block(b), d, ph)
        v1, h1 = one.step(one.prepare_block(b), d, h1)
        v, v1 = v.cpu().numpy(), v1.cpu().numpy()
        np.testing.assert_allclose(v, v1, rtol=5e-4, atol=5e-7)
        worst = max(worst, float(np.abs(v - v1).max() / np.abs(v1).max()))
    torch.cuda.synchronize()
    counts = read_counts()
    volume = per_block_volume(mesh, SCALE_BLOCKS)
    check_scale_counts(counts, {}, "scale-out plain step")
    pred = predicted_volume(nch=2, nbl=1, nbins=FLAGSHIP["nbins"],
                            num_samp=FLAGSHIP["nsamp"],
                            ntaps=FLAGSHIP["ntaps"], mesh_time=2,
                            mesh_freq=2, fused=False)
    if volume != pred:
        raise AssertionError(f"scale-out plain step: bytes {volume} against "
                             f"{pred}")
    print(f"  [{card}] plain step with the corner turn on (2, 2): within "
          f"rtol 5e-4, atol 5e-7 ({worst:.3g} of max|vis|); bytes a block "
          f"{volume}", flush=True)
    return {"max_rel_err": worst, "bytes_per_block": volume}


def scale_cli(tmp):
    """Scale-out check 4: ``python -m fxtpu_torch --mesh_time 2
    --mesh_freq 2 --device cuda`` (4 shards on the card) for CLI_S s: the
    product's header is the single-device default run's, the calibration
    recovers the delay, every block launches the single pass on the 4
    shards and one epilogue; then the same at ``--blocks_per_dispatch 8``
    (the stager's batches split over the shards on the card)."""
    cor, out, counts = run_cli(tmp, "mesh22", "complex64",
                               ["--mesh_time", "2", "--mesh_freq", "2"])
    n, blocks = cor.engine.mesh.size, cor.blocks_processed
    check_scale_counts(counts, {"fx_parts": n * blocks,
                                "fx_parts_reduce": n * blocks,
                                "fx_finish": blocks}, "scale-out CLI run")
    check_products(cor, out, "mesh22")
    with open(out) as fh, open(os.path.join(tmp, "vis_fx_parts.csv")) as ref:
        if [fh.readline() for _ in range(2)] != [ref.readline()
                                                 for _ in range(2)]:
            raise AssertionError("the mesh run's header differs from the "
                                 "single-device run's")
    # the staged path on the mesh: the stager's m K-block calls launch the
    # single pass, its reduce and the epilogue once a shard each; the t
    # one-block calls (the calibrating block, the tail) the single pass and
    # its reduce once a shard and one epilogue
    cor, out, staged = run_cli(tmp, "mesh22_staged", "complex64",
                               ["--mesh_time", "2", "--mesh_freq", "2",
                                "--blocks_per_dispatch", str(MULTI_K)])
    if cor.stager is None or cor.stager.stacked_batches < 1:
        raise AssertionError("the staged mesh run made no K-block call")
    m = cor.stager.stacked_batches
    t = cor.blocks_processed - m * MULTI_K
    check_scale_counts(staged, {"fx_parts": n * (m + t),
                                "fx_parts_reduce": n * (m + t),
                                "fx_finish": n * m + t},
                       "scale-out staged CLI run")
    check_products(cor, out, "mesh22_staged")
    print(f"  mesh, staged: {m} calls of {MULTI_K} blocks, {t} of one",
          flush=True)
    return [counts, staged], {"shards": n, "blocks": blocks,
                              "staged_calls": [m, t]}


def scale_two_processes(tmp, device, card):
    """Scale-out check 5: ``multihost.launch(2, "step")``, both processes'
    4 shards on the card, gloo (chosen here, by argument), against the
    single-process (4, 2) mesh step in this process on the same block
    (rtol 2e-5, atol 2e-4); each worker's own launch counts checked (the
    single pass and its reduce once a local shard, one epilogue), the
    staged bytes printed."""
    import torch
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.parallel import make_correlator_mesh
    from fxtpu_torch.parallel.multihost import launch, step_block
    nbins, nsamp = FLAGSHIP["nbins"], FLAGSHIP["nsamp"]
    out = os.path.join(tmp, "mh_step.npz")
    t0 = time.perf_counter()
    results = launch(2, "step", ["--out", out, "--nbins", str(nbins),
                                 "--num_samp", str(nsamp), "--fused"],
                     timeout=300, backend="gloo", device="cuda")
    wall = time.perf_counter() - t0
    # every process's step: the single pass and its reduce once on each of
    # its shards, one epilogue, nothing else, on the kernel route
    worker_launches = []
    for pid, r in enumerate(results):
        print("    " + r.stdout.strip().splitlines()[-1], flush=True)
        line = next((json.loads(l) for l in r.stdout.splitlines()
                     if l.startswith('{"process"')), None)
        if line is None or line["process"] != pid:
            raise AssertionError(f"worker {pid} printed no launch counts")
        k = line["local_shards"]
        expect = {"fx_fused_parts": k, "parts_reduce": k, "fx_finish": 1}
        if not line["kernel_active"] or line["launches"] != expect:
            raise AssertionError(
                f"two processes: worker {pid}'s launches {line['launches']}"
                f" (kernel route {line['kernel_active']}), expected {expect}")
        worker_launches.append(line["launches"])
    got = np.load(out)
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, ntaps=4, nbins=nbins,
                           num_samp=nsamp, clamp_num_samp=False, fused=True,
                           device="cuda")
    eng = FxEngine(cfg, mesh=make_correlator_mesh(4, 2, [device] * 8))
    vis, hist = eng.step(eng.prepare_block(step_block(nsamp)),
                         torch.tensor([0.0, 1.25e-6], device=device),
                         eng.fresh_history())
    np.testing.assert_allclose(got["vis"], vis.cpu().numpy(), rtol=2e-5,
                               atol=2e-4)
    np.testing.assert_allclose(got["hist"], hist.cpu().numpy(), rtol=1e-6,
                               atol=1e-6)
    err = float(np.abs(got["vis"] - vis.cpu().numpy()).max()
                / np.abs(vis.cpu().numpy()).max())
    print(f"  [{card}] two processes (gloo, 4 shards each on the card): "
          f"vis {err:.3g} of max|vis| from the one-process mesh; staged "
          f"through pinned host memory {int(got['staged_bytes'])} bytes "
          f"(process 0); each worker's launches {worker_launches[0]}; "
          f"launch and run {wall:.1f} s", flush=True)
    return {"max_rel_err": err, "staged_bytes": int(got["staged_bytes"]),
            "seconds": wall, "worker_launches": worker_launches}


def run_scaleout(tmp, device, card):
    """The scale-out phase: checks 1-5 (the accounting, check 6, inside 1
    to 3).  Returns (the launch counts of its kernel runs, the record)."""
    counts, record = [], {"fused_step": {}}
    for tag, case, ingest in SCALE_CASES:
        for mesh_tf in SCALE_MESHES:
            c, rec = scale_fused_step(tag, case, ingest, mesh_tf, device,
                                      card)
            counts.append(c)
            record["fused_step"][f"{tag}_{ingest}_{mesh_tf[0]}x{mesh_tf[1]}"] = rec
    c, record["multi"] = scale_multi(device, card)
    counts.append(c)
    record["plain_step"] = scale_plain(device, card)
    c, record["cli"] = scale_cli(tmp)
    counts += c
    record["two_processes"] = scale_two_processes(tmp, device, card)
    return counts, record



# --------------------------------------------------------------------------
# The scaling bench and the observe example on the card
# --------------------------------------------------------------------------

BENCH_DEVICES = (1, 2, 4)   # shards of the card in the sweep
BENCH_MULTI_SHARDS = 4
BENCH_ITERS = 10            # timed steps a sweep row (the bench's default)
BENCH_MULTI_ITERS = 10      # timed repeats of each --multi leg
BENCH_ARGS = ["--device", "cuda", "--block_pow", "21", "--nbins", "4096",
              "--freq", "2"]


def bench_expect(per_shard, per_block, shards, steps):
    """The launch counts of ``steps`` mesh steps on ``shards`` shards: the
    single pass and its reduce ``per_shard`` times a shard a step, the
    epilogue ``per_block`` times a step."""
    n = per_shard * shards * steps
    return {"fx_parts": n, "fx_parts_reduce": n,
            "fx_finish": per_block * steps}


def run_scaling_bench(card):
    """``fxtpu_torch.scaling_bench.main`` on the card at the flagship width
    (2 channels, 4096 bins, 4 taps) and fxtpu's --block_pow 21: the sweep
    over 1, 2 and 4 shards (2^21 samples a shard), then --multi 8 on 4
    shards.  Every row is checked: a sweep step launches the single pass
    and its reduce once a shard and the epilogue once; the K = 8 call
    takes the block-parallel path, one launch of each a shard; the K
    single steps as a sweep step.  The widest sweep row's step is held to
    the single-device step (``check_bench_mesh``).  Returns (the counts
    of both runs, the record)."""
    from fxtpu_torch import scaling_bench
    reset_counts()
    sweep = scaling_bench.main(
        BENCH_ARGS + ["--iters", str(BENCH_ITERS), "--devices",
                      *map(str, BENCH_DEVICES)])
    torch_sync()
    counts = read_counts()
    rows = sweep["rows"]
    if [r["devices"] for r in rows] != list(BENCH_DEVICES):
        raise AssertionError(f"scaling bench: rows {rows}")
    total = {}
    for r in rows:
        steps, n = r["steps"], r["devices"]
        if steps != 1 + scaling_bench.WARMUP + BENCH_ITERS or r[
                "launches"] != {"fx_fused_parts": n * steps,
                                "parts_reduce": n * steps,
                                "fx_finish": steps}:
            raise AssertionError(f"scaling bench row {r}: expected "
                                 f"{n * steps} single passes, {steps} "
                                 "epilogues")
        for key, v in bench_expect(1, 1, n, steps).items():
            total[key] = total.get(key, 0) + v
    check_scale_counts(counts, total, "scaling bench sweep")
    mesh_check = check_bench_mesh(card)
    reset_counts()
    multi = scaling_bench.main(
        BENCH_ARGS + ["--iters", str(BENCH_MULTI_ITERS), "--devices",
                      str(BENCH_MULTI_SHARDS), "--multi", str(MULTI_K)])
    torch_sync()
    mcounts = read_counts()
    (row,) = multi["rows"]
    n, k, calls = BENCH_MULTI_SHARDS, MULTI_K, 1 + BENCH_MULTI_ITERS
    single = bench_expect(1, 1, n, k * calls)
    blockdp = bench_expect(1, n, n, calls)
    if not (row["path"] == "block-DP" and row["k"] == k
            and row["single_launches"] == {
                "fx_fused_parts": single["fx_parts"],
                "parts_reduce": single["fx_parts_reduce"],
                "fx_finish": single["fx_finish"]}
            and row["multi_launches"] == {
                "fx_fused_parts": blockdp["fx_parts"],
                "parts_reduce": blockdp["fx_parts_reduce"],
                "fx_finish": blockdp["fx_finish"]}):
        raise AssertionError(f"scaling bench --multi {k}: {row}")
    check_scale_counts(mcounts, {key: single[key] + blockdp[key]
                                 for key in single},
                       f"scaling bench --multi {k}")
    for r in rows:
        print(f"  [{card}] scaling bench, {r['devices']} shard(s) of the "
              f"card: {r['samples_per_s']:.1f} samples/s "
              f"({r['per_device']:.1f} a shard, efficiency "
              f"{r['efficiency_vs_linear']}), launches {r['launches']}",
              flush=True)
    print(f"  [{card}] scaling bench --multi {k} on {n} shards: single steps "
          f"{row['single_samples_per_s']:.1f} samples/s, one {row['path']} "
          f"call {row['multi_samples_per_s']:.1f} (x{row['multi_speedup']})",
          flush=True)
    return [counts, mcounts], {"sweep": sweep, "multi": multi,
                               "mesh_check": mesh_check,
                               "iters": BENCH_ITERS,
                               "multi_iters": BENCH_MULTI_ITERS}


def check_bench_mesh(card):
    """The sweep's widest row held to the single-device step: that row's
    engine (``scaling_bench._engine``: 4 shards of the card, 2^21 samples
    a shard, the raw halo between them) and block, over two chained
    steps with nonzero delays, against ``FxEngine`` without a mesh: vis
    within SCALE_TOL of max|vis|, history within HIST_TOL.  Its launches
    are a comparison's and fall outside the counted runs."""
    import torch
    from fxtpu_torch import scaling_bench
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops.xengine import pack_delays
    n = max(BENCH_DEVICES)
    nsamp = 2 ** 21 * n
    peng = scaling_bench._engine(n, 2, nsamp, 4096, "cuda")
    one = FxEngine(peng.cfg, fused=peng.fused)
    if not (peng.kernel_active and peng.step.fused_kernel):
        raise AssertionError("scaling bench mesh: not the kernel route")
    block = scaling_bench._blocks(1, nsamp)[0]
    d = torch.as_tensor(pack_delays(1e-7 * np.arange(2), peng.cfg.frequency),
                        device="cuda")
    iq_m, iq_1 = peng.prepare_block(block), one.prepare_block(block)
    h_m, h_1, err = peng.fresh_history(), one.fresh_history(), 0.0
    for _ in range(2):
        v_m, h_m = peng.step(iq_m, d, h_m)
        v_1, h_1 = one.step(iq_1, d, h_1)
        err = max(err, float((v_m - v_1).abs().max() / v_1.abs().max()))
    herr, _ = history_err(h_m, h_1)
    torch.cuda.synchronize()
    print(f"  [{card}] scaling bench's {n}-shard step against the "
          f"single-device step: vis {err:.3g} of max|vis|, history "
          f"{herr:.3g}", flush=True)
    if not (err <= SCALE_TOL["complex64"] and herr <= HIST_TOL):
        raise AssertionError(f"scaling bench {n}-shard step: vis {err:.3g} "
                             f"of scale, history {herr:.3g}")
    return {"shards": n, "max_rel_err": err, "history_err": herr}


def torch_sync():
    import torch
    torch.cuda.synchronize()


def run_observe_example(tmp, card):
    """``examples/observe_torch.sh --device cuda --time 2 --omit_plot`` (no
    plot: this machine may lack matplotlib) in a directory of its own: the
    CSV loads with the reference recipe, 4096 finite bins a row, and the
    run's ``kernel launches`` log line shows one single pass, one reduce
    and one epilogue a row (its own process's counters)."""
    import ast
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(tmp, "observe")
    os.makedirs(work)
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    res = subprocess.run(
        ["bash", os.path.join(here, "examples", "observe_torch.sh"),
         "--device", "cuda", "--time", "2", "--omit_plot"],
        cwd=work, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"observe_torch.sh failed ({res.returncode}): "
                             f"{res.stderr[-3000:]}")
    data = np.atleast_2d(np.loadtxt(
        os.path.join(work, "visibilities_example.csv"), dtype=np.complex128,
        delimiter=",", skiprows=2))
    line = next((l for l in res.stderr.splitlines()
                 if "kernel launches" in l), None)
    if line is None:
        raise AssertionError("observe_torch.sh logged no kernel launches: "
                             "not the kernel route")
    counts = ast.literal_eval(line[line.index("{"):])
    rows = data.shape[0]
    if not (data.shape[1] == 4096 and np.isfinite(data).all() and rows >= 1
            and counts == {"fx_fused_parts": rows, "parts_reduce": rows,
                           "fx_finish": rows}):
        raise AssertionError(f"observe_torch.sh: rows {data.shape}, "
                             f"launches {counts}")
    print(f"  [{card}] examples/observe_torch.sh: {rows} rows of 4096 bins, "
          f"launches {counts}, {wall:.1f} s", flush=True)
    return {"rows": rows, "launches": counts, "seconds": wall}


# --------------------------------------------------------------------------
# The host data plane (fxtpu_torch/csrc/host: the native rings and loops)
# --------------------------------------------------------------------------

HOST_POW = 21        # bench_host_pipeline's block: 2 channels x 2^21 samples
HOST_NCH = 2
HOST_NBINS = 4096    # the staging buffer's frames, as bench_host_pipeline's
HOST_AB_S = 3.0      # seconds of each run of the native / Python A/B
HOST_REPEATS = 12    # calls of each stage alone; the median is kept


def host_info() -> dict:
    """The host beside a host reading: its CPU (``/proc/cpuinfo``'s model
    name, family and model number: a virtual machine may name its CPU
    "unknown"), its logical cores, the load average and torch's CPU
    threads."""
    import platform

    import torch
    cpu = {"model name": platform.processor() or platform.machine()}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "cpu family", "model"):
                    cpu.setdefault(key + " (cpuinfo)", value.strip())
    except OSError:
        pass
    model = cpu.get("model name (cpuinfo)", cpu["model name"])
    if "cpu family (cpuinfo)" in cpu:
        model += (f" (family {cpu['cpu family (cpuinfo)']}, model "
                  f"{cpu.get('model (cpuinfo)', '?')})")
    return {"cpu": model, "cores": os.cpu_count(),
            "loadavg": [round(x, 2) for x in os.getloadavg()],
            "torch_threads": torch.get_num_threads()}


def host_library_line() -> dict:
    """(a) The port's host library, built from ``fxtpu_torch/csrc/host``
    at first use (or loaded when this machine built it before): prints
    the compiler's version, the build's seconds (0 when cached) and the
    file.  Raises when there is no C++ compiler or the build fails."""
    from fxtpu_torch import host_build
    from fxtpu_torch.runtime import native
    cxx = host_build.compiler()
    if cxx is None or not native.native_available():
        raise AssertionError("no C++ compiler ($CXX or g++): the port's "
                             "host library cannot be built")
    rec = {"compiler": host_build.compiler_version(cxx),
           "command": " ".join(cxx + host_build.CXX_FLAGS),
           "build_s": host_build.build_seconds,
           "file": host_build.loaded_path.name}
    print(f"  host library {rec['file']}: {rec['compiler']}, build "
          f"{rec['build_s']:.2f} s ({rec['command']})", flush=True)
    for line in host_build.build_log.splitlines():
        print(f"    {line.rstrip()}", flush=True)
    return rec


def host_plane_state(cor, tag) -> dict:
    """(b) The host plane a Correlator's run went through: every ring a
    ``NativeRingBuffer``, a feeder a channel (the synthetic and replay
    sources split), each on the zero-copy producer, and the aligner
    gathering through views.  Raises otherwise."""
    from fxtpu_torch.runtime.native import NativeRingBuffer
    per_channel = [f for f in cor.feeders if len(f.bufs) == 1]
    state = {"rings": sorted({type(b).__name__ for b in cor.bufs}),
             "feeders": len(cor.feeders), "per_channel": len(per_channel),
             "zero_copy": [f.zero_copy for f in cor.feeders],
             "aligner_views": cor.aligner._views}
    print(f"  [{tag}] host plane: rings {state['rings']}, "
          f"{state['feeders']} feeders ({state['per_channel']} a channel), "
          f"zero_copy {state['zero_copy']}, aligner views "
          f"{state['aligner_views']}", flush=True)
    if (not all(type(b) is NativeRingBuffer for b in cor.bufs)
            or len(per_channel) != cor.config.nchan
            or not all(f.zero_copy for f in cor.feeders)
            or not cor.aligner._views):
        raise AssertionError(f"{tag}: the run's host plane is not the "
                             f"native one: {state}")
    return state


def host_pipeline_run(rec, ingest, native_plane, seconds=HOST_AB_S):
    """(c) ``bench_host_pipeline``'s configuration (a looping replay of
    ``rec``, a feeder a channel, rings of 8 blocks, the aligner, the
    staging copy into pinned memory by torch's ``copy_``; no copy to the
    card) for ``seconds``, on the native plane (native rings, the
    zero-copy producer, the native quantizer) or on the Python plane
    (``make_ring(..., prefer_native=False)``: Python rings and ``put``,
    numpy's quantizer).  Raises unless the run took the plane it was
    asked for and dropped nothing.  Returns its rates and the process's
    CPU time over the run's wall time (``cores_busy``)."""
    import torch

    from fxtpu_torch.runtime.feeder import BlockAligner, Feeder
    from fxtpu_torch.runtime.native import (NativeRingBuffer, make_ring,
                                            quantize_c64_numpy)
    from fxtpu_torch.runtime.ringbuffer import RingBuffer
    from fxtpu_torch.sources import QuantizedSource, ReplaySource

    class NumpyQuantizedSource(QuantizedSource):
        """A QuantizedSource through numpy's ufunc chain."""

        def _quantize(self, block, out=None):
            return quantize_c64_numpy(
                np.ascontiguousarray(block, dtype=np.complex64),
                self.quant_step, out=out)

    num_samp, int8 = 2 ** HOST_POW, ingest == "int8"
    iq = (2,) if int8 else ()
    frames = num_samp // HOST_NBINS
    stage = torch.empty((HOST_NCH, frames, HOST_NBINS, *iq),
                        dtype=torch.int8 if int8 else torch.complex64,
                        pin_memory=True)
    wrap = QuantizedSource if native_plane else NumpyQuantizedSource

    def source(c):
        src = ReplaySource(rec, loop=True).select_channels([c])
        return wrap(src) if int8 else src

    bufs = [make_ring(8, (num_samp, *iq), np.int8 if int8 else np.complex64,
                      prefer_native=native_plane) for _ in range(HOST_NCH)]
    feeders = [Feeder(source(c), [bufs[c]], num_samp)
               for c in range(HOST_NCH)]
    aligner = BlockAligner(bufs)
    for f in feeders:
        f.start()
    blocks = 0
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    try:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            block = aligner.get(timeout=1.0)
            if block is None:
                break
            framed = block[:, : frames * HOST_NBINS].reshape(stage.shape)
            stage.copy_(torch.from_numpy(framed))
            blocks += 1
        dt = time.perf_counter() - t0
        cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    finally:
        for f in feeders:
            f.stop()
        for f in feeders:
            f.join(5.0)
    cpu_s = (cpu1.ru_utime + cpu1.ru_stime) - (cpu0.ru_utime + cpu0.ru_stime)
    kind = NativeRingBuffer if native_plane else RingBuffer
    zero_copy = [f.zero_copy for f in feeders]
    drops = sum(b.drops for b in bufs)
    if (not all(type(b) is kind for b in bufs)
            or zero_copy != [native_plane] * HOST_NCH
            or not aligner._views or blocks < 2 or drops
            or any(f.alive for f in feeders)):
        raise AssertionError(
            f"host pipeline {ingest} native={native_plane}: rings "
            f"{[type(b).__name__ for b in bufs]}, zero_copy {zero_copy}, "
            f"views {aligner._views}, {blocks} blocks, {drops} drops, "
            f"feeders alive {[f.alive for f in feeders]}")
    rate = blocks * HOST_NCH * num_samp / dt
    return {"msamp_per_s": rate / 1e6,
            "gb_per_s": rate * (2 if int8 else 8) / 1e9,
            "blocks": blocks, "seconds": dt, "rings": kind.__name__,
            "zero_copy": zero_copy, "cores_busy": cpu_s / dt,
            "host": host_info()}


def host_pipeline_ab(rec, card) -> dict:
    """(c) The host pipeline on the native plane (A) and on the Python
    plane (B), A B B A in each ingest, in this process: each run's
    Msamp/s and GB/s with the host beside it, then each plane's median and
    spread (largest less smallest)."""
    out = {}
    for ingest in ("complex64", "int8"):
        runs = {"native": [], "python": []}
        for plane in ("native", "python", "python", "native"):
            r = host_pipeline_run(rec, ingest, plane == "native")
            runs[plane].append(r)
            print(f"  [{card}] host pipeline {ingest} {plane}: "
                  f"{r['msamp_per_s']:.4f} Msamp/s, {r['gb_per_s']:.4f} "
                  f"GB/s ({r['blocks']} blocks in {r['seconds']:.3f} s, "
                  f"the process's CPU time {r['cores_busy']:.3f} cores); "
                  f"host {json.dumps(r['host'])}", flush=True)
        summary = {}
        for plane, rs in runs.items():
            ms = [r["msamp_per_s"] for r in rs]
            gb = [r["gb_per_s"] for r in rs]
            summary[plane] = {
                "msamp_per_s": statistics.median(ms),
                "msamp_per_s_spread": max(ms) - min(ms),
                "gb_per_s": statistics.median(gb),
                "gb_per_s_spread": max(gb) - min(gb), "runs": rs}
        nat, py = summary["native"], summary["python"]
        print(f"  [{card}] host pipeline {ingest}, median (spread): native "
              f"{nat['msamp_per_s']:.4f} ({nat['msamp_per_s_spread']:.4f}) "
              f"Msamp/s, {nat['gb_per_s']:.4f} GB/s; python "
              f"{py['msamp_per_s']:.4f} ({py['msamp_per_s_spread']:.4f}) "
              f"Msamp/s, {py['gb_per_s']:.4f} GB/s; native / python "
              f"{nat['msamp_per_s'] / py['msamp_per_s']:.4f}", flush=True)
        out[ingest] = summary
    return out


def time_host(fn, before=None, n=HOST_REPEATS, warm=2):
    """Median ms of ``fn()`` by the host clock over ``n`` calls after
    ``warm``, on this thread; ``before()`` runs untimed before each."""
    times = []
    for i in range(warm + n):
        if before is not None:
            before()
        t0 = time.perf_counter()
        fn()
        dt = (time.perf_counter() - t0) * 1e3
        if i >= warm:
            times.append(dt)
    return statistics.median(times)


def host_stages(rec, ingest, device, card) -> dict:
    """(d) Each stage of the host plane alone on one pipeline block (2 x
    2^21 samples), on this thread, the median of HOST_REPEATS calls: the
    source's read (``read_block``, and ``read_block_into`` a reserved
    slot a channel), the quantize (int8: native and numpy, into a buffer
    made before), the ring (``put`` against ``reserve`` + ``commit``),
    the aligner's gather (views against ``get`` + ``np.stack``), the
    staging copy into pinned memory (torch's ``copy_``, the
    ``prepare_block`` route, against ``np.copyto``, the ``prepare_batch``
    route) and the copy of the staged block to the card (CUDA events).
    GB/s: the bytes a stage reads and writes (each once) over its time;
    the copy to the card counts the block once.  Each reading prints with
    the host beside it."""
    import torch

    from fxtpu_torch.runtime.feeder import BlockAligner
    from fxtpu_torch.runtime.native import (NativeRingBuffer, quantize_c64,
                                            quantize_c64_numpy)
    from fxtpu_torch.sources import QuantizedSource, ReplaySource
    num_samp, int8 = 2 ** HOST_POW, ingest == "int8"
    iq = (2,) if int8 else ()
    dtype = np.int8 if int8 else np.complex64
    c64 = HOST_NCH * num_samp * 8            # the block as complex64
    q8 = HOST_NCH * num_samp * 2             # and as int8 pairs
    blk = q8 if int8 else c64                # the rings' block
    frames = num_samp // HOST_NBINS

    def source(channels=None):
        src = ReplaySource(rec, loop=True)
        if channels is not None:
            src = src.select_channels(channels)
        return QuantizedSource(src, STEP) if int8 else src

    whole = source()
    splits = [source([c]) for c in range(HOST_NCH)]
    rings = [NativeRingBuffer(4, (num_samp, *iq), dtype)
             for _ in range(HOST_NCH)]
    block = whole.read_block(num_samp)
    stages = {}   # name -> (ms, bytes read and written)
    stages["read_block"] = (time_host(lambda: whole.read_block(num_samp)),
                            3 * c64 + q8 if int8 else 2 * c64)
    slots = [r.reserve(timeout=1.0) for r in rings]   # left uncommitted

    def read_into():
        for src, slot in zip(splits, slots):
            src.read_block_into(slot, num_samp)

    stages["read_block_into"] = (time_host(read_into),
                                 3 * c64 + q8 if int8 else 2 * c64)
    if int8:
        samples = ReplaySource(rec).read_block(num_samp)
        qout = np.empty((*samples.shape, 2), np.int8)
        stages["quantize_native"] = (time_host(
            lambda: quantize_c64(samples, STEP, out=qout)), c64 + q8)
        stages["quantize_numpy"] = (time_host(
            lambda: quantize_c64_numpy(samples, STEP, out=qout)), c64 + q8)

    def drain():
        for r in rings:
            while r.qsize():
                r.get_view(timeout=1.0)
                r.release()

    def put():
        for c, r in enumerate(rings):
            r.put(block[c], timeout=1.0)

    def reserve_commit():
        for r in rings:
            r.reserve(timeout=1.0)
            r.commit()

    drain()
    stages["ring_put"] = (time_host(put, before=drain), 2 * blk)
    stages["ring_reserve_commit"] = (time_host(reserve_commit, before=drain),
                                     0)
    views, stacked = BlockAligner(rings), BlockAligner(rings)
    stacked._views = False

    def refill():
        drain()
        put()

    stages["aligner_views"] = (time_host(lambda: views.get(timeout=1.0),
                                         before=refill), 2 * blk)
    stages["aligner_get_stack"] = (time_host(
        lambda: stacked.get(timeout=1.0), before=refill), 4 * blk)
    refill()
    gathered = views.get(timeout=1.0)
    stage = torch.empty((HOST_NCH, frames, HOST_NBINS, *iq),
                        dtype=torch.int8 if int8 else torch.complex64,
                        pin_memory=True)
    framed = gathered[:, : frames * HOST_NBINS].reshape(stage.shape)
    stages["stage_torch_copy"] = (time_host(
        lambda: stage.copy_(torch.from_numpy(framed))), 2 * blk)
    stages["stage_np_copyto"] = (time_host(
        lambda: np.copyto(stage.numpy(), framed)), 2 * blk)
    on_card = torch.empty(stage.shape, dtype=stage.dtype, device=device)
    ms = []
    for i in range(2 + HOST_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        on_card.copy_(stage, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            ms.append(start.elapsed_time(end))
    stages["h2d"] = (statistics.median(ms), blk)
    if not torch.equal(on_card.cpu(), stage):
        raise AssertionError("the staged block did not reach the card whole")
    out = {}
    for name, (ms_, nbytes) in stages.items():
        rec_ = {"ms": ms_, "bytes": nbytes,
                "gb_per_s": nbytes / (ms_ * 1e6) if nbytes else None,
                "host": host_info()}
        out[name] = rec_
        rate = (f"{rec_['gb_per_s']:.4f} GB/s" if nbytes
                else "no bytes moved")
        print(f"  [{card}] host stage {ingest} {name}: {ms_:.4f} ms a "
              f"block, {rate} ({nbytes} B); host {json.dumps(rec_['host'])}",
              flush=True)
    for r in rings:
        r.close()
    return out


def run_host_plane(rec, device, card) -> dict:
    """(c) and (d): the native plane against the Python plane, then each
    stage alone, in each ingest."""
    record = {"ab": host_pipeline_ab(rec, card)}
    record["stages"] = {ingest: host_stages(rec, ingest, device, card)
                        for ingest in ("complex64", "int8")}
    return record


# --------------------------------------------------------------------------
# The bench (python -m fxtpu_torch.bench, the port of bench.py) on the card
# --------------------------------------------------------------------------

# configuration -> (the single-pass count its step advances, whether it
# launches the deep-tap FIR first, multi_step calls a timed iteration,
# the largest call's K): K blocks capped at ops.fx_fused.max_blocks_parts
# (25 at 2 x 2^21 samples, 15 on the wide route at 8 x 2^20)
BENCH_ROUTES = {"default": ("fx_parts", False, 6, 22),
                "default_int8": ("fx_parts_i8", False, 6, 22),
                "wideband": ("fx_parts_svd", True, 3, 22),
                "wideband_int8": ("fx_parts_i8_svd", True, 2, 16),
                "nchan8": ("fx_parts_wide", False, 5, 13)}
BENCH_SECONDS = 6    # the module's pipeline legs (bench.py runs 12 and 6 s)
MAX_SHARE = 1.05     # of a peak, in the roofline's shares


def bench_cases():
    """(configuration, shape, K, FIR mode, int8) of each of
    ``fxtpu_torch.bench.CONFIGS`` at its largest ``multi_step`` call: the
    shape from the configuration and ``bench``'s defaults, K from
    ``BENCH_ROUTES`` (which ``run_bench_configs`` holds to the run's
    ``blocks_per_dispatch``)."""
    import inspect

    from fxtpu_torch import bench
    defaults = {p.name: p.default for p in
                inspect.signature(bench.bench).parameters.values()}
    cases = []
    for name in sorted(bench.CONFIGS):
        kw = {**defaults, **bench.CONFIGS[name]}
        case = dict(nch=kw["nchan"], nsamp=2 ** kw["block_pow"],
                    nbins=kw["nbins"], ntaps=kw["ntaps"],
                    autos=kw["include_autos"])
        entry, _, _, k = BENCH_ROUTES[name]
        cases.append((name, case, k,
                      "svd" if entry.endswith("_svd") else "direct",
                      kw["ingest"] == "int8"))
    return cases


def run_bench_configs(card):
    """``fxtpu_torch.bench.bench(**CONFIGS[c])`` in this process for each
    configuration, the counts set to 0 before and read after each: every
    timed iteration's ceil(K / m) ``multi_step`` calls, one untimed and
    ``WARMUP`` more, launch the fused single pass once a call (its SVD-FIR
    mode and the FIR launch at 32 taps, the wide route and the X kernel at
    8 channels) with its reduce or X kernel and the epilogue, and nothing
    else.  Prints each configuration's JSON line (``step_line``).  Returns
    (the counts of each run, the lines by configuration)."""
    import torch
    from fxtpu_torch import bench
    kind = torch.cuda.get_device_name(0)
    counts_all, lines = [], {}
    for name in sorted(bench.CONFIGS):
        entry, deep, per_iter, largest = BENCH_ROUTES[name]
        reset_counts()
        t0 = time.perf_counter()
        res = bench.bench(**bench.CONFIGS[name])
        torch_sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
        calls = per_iter * (1 + bench.WARMUP + bench.ITERS)
        expect = {entry: calls, "fx_finish": calls,
                  ("fx_xstage" if "wide" in entry else "fx_parts_reduce"):
                  calls}
        if deep:
            expect["fir_rows"] = calls
        launched = {c: v for c, v in counts.items() if v}
        if launched != expect or res["blocks_per_dispatch"] != largest:
            raise AssertionError(
                f"bench {name}: launches {launched}, expected {expect}; "
                f"blocks_per_dispatch {res['blocks_per_dispatch']}, "
                f"expected {largest}")
        line = bench.step_line(name, res, card, kind)
        print(f"  [{card}] bench {name}: {json.dumps(line)} ({wall:.1f} s "
              "with the blocks' making)", flush=True)
        lines[name] = dict(line, launches=launched, wall_s=wall)
        counts_all.append(counts)
        torch.cuda.empty_cache()
    return counts_all, lines


def run_bench_module(tmp, card):
    """``python -m fxtpu_torch.bench`` in processes of its own: the default
    configuration, then ``--pipeline`` and ``--host_pipeline`` at
    ``--seconds BENCH_SECONDS`` in each ingest.  Each exits 0 and prints
    one JSON line with bench.py's metric for its flags, a positive value,
    no ``error`` and its shares of the card's peaks at most MAX_SHARE.
    Returns the lines by their flags."""
    from fxtpu_torch import bench
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(tmp, "bench")
    os.makedirs(work)
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    runs = [[]] + [[flag, "--ingest", ingest, "--seconds", str(BENCH_SECONDS)]
                   for flag in ("--pipeline", "--host_pipeline")
                   for ingest in ("complex64", "int8")]
    out = {}
    for argv in runs:
        args = bench._parser().parse_args(argv)
        metric = bench.metric_name(args.config, args.pipeline,
                                   args.host_pipeline, args.ingest)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "fxtpu_torch.bench", *argv], cwd=work,
            env=env, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        line = json.loads(lines[-1]) if lines else {}
        shares = [line.get(s, 0.0) for s in ("flop_frac", "hbm_frac")]
        if not (res.returncode == 0 and len(lines) == 1
                and line.get("metric") == metric and line.get("value", 0) > 0
                and "error" not in line and max(shares) <= MAX_SHARE):
            raise AssertionError(
                f"python -m fxtpu_torch.bench {' '.join(argv)}: exit "
                f"{res.returncode}, stdout {res.stdout[-2000:]!r}, stderr "
                f"{res.stderr[-3000:]}")
        tag = " ".join(argv) or "--config default"
        print(f"  [{card}] python -m fxtpu_torch.bench {tag}: "
              f"{json.dumps(line)} ({wall:.1f} s)", flush=True)
        out[tag] = dict(line, wall_s=wall)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    import fxtpu_torch  # noqa: F401  (fails when run outside the repo)
    from fxtpu_torch.cuda_build import library_path, load_kernels

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{nvcc_version()}, python {sys.version.split()[0]}", flush=True)
    device = torch.device("cuda", 0)

    def phase(title):
        print(f"{title} [{time.perf_counter() - t_start:.1f} s]", flush=True)

    phase("phase 1: build")
    t0 = time.perf_counter()
    load_kernels()
    from fxtpu_torch import cuda_build
    print(f"  {library_path().name} ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {cuda_build.build_seconds:.1f} s, one process per source)",
          flush=True)
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "bytes stack" in line or "Compiling" in line:
            print(f"  {line.strip()}", flush=True)
    host_record = {"library": host_library_line()}

    phase("phase 2: kernels against their plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    errs = {name: (0.0, 0.0) for name in REPLACES}
    for name, compare, fir, cases in (
            ("fx_fused", compare_kernel, "direct",
             (SMALL, FLAGSHIP, MANY_PAIRS, WIDEBAND)),
            ("fx_fused_i8", compare_kernel_i8, "direct",
             (SMALL, FLAGSHIP, MANY_PAIRS, WIDEBAND)),
            ("fx_fused_svd", compare_kernel, "svd", (SMALL_DEEP, WIDEBAND)),
            ("fx_fused_i8_svd", compare_kernel_i8, "svd",
             (SMALL_DEEP, WIDEBAND))):
        for case in cases:
            print(f"  {name} shape {case}", flush=True)
            errs[name] = tuple(map(max, errs[name],
                                   compare(case, device, fir)))
    for case in SPEC_CASES:
        print(f"  spectrometer shape {case}", flush=True)
        errs["spectrometer"] = tuple(map(max, errs["spectrometer"],
                                         compare_spectrometer(case, device)))
    for name, int8 in (("fx_fused_multi", False),
                       ("fx_fused_i8_multi", True)):
        for case, k, fir in MULTI_CASES:
            print(f"  {name} ({fir}) K={k} shape {case}", flush=True)
            errs[name] = tuple(map(max, errs[name],
                                   compare_multi(case, k, device, fir, int8)))
    dc_bin = {}
    for int8 in (False, True):
        for case, k, fir in PARTS_CASES:
            name = "fx_parts_i8" if int8 else "fx_parts"
            print(f"  {name} + fx_finish ({fir}) K={k} shape {case}",
                  flush=True)
            got, dc = compare_parts(case, k, device, fir, int8)
            for key, pair in got.items():
                errs[key] = tuple(map(max, errs[key], pair))
            dc_bin[name] = max(dc_bin.get(name, 0.0), dc)
    for int8 in (False, True):
        for case, fir, x_stage in WIDE_CASES:
            for k in (1, WIDE_K):
                name = "fx_parts_wide_i8" if int8 else "fx_parts_wide"
                print(f"  {name} + fx_finish ({fir}, x_stage {x_stage}) "
                      f"K={k} shape {case}", flush=True)
                got, dc = compare_parts(case, k, device, fir, int8, x_stage)
                if name not in got:
                    raise AssertionError(f"{case} did not take the wide "
                                         "route")
                for key, pair in got.items():
                    errs[key] = tuple(map(max, errs[key], pair))
                dc_bin[name] = max(dc_bin.get(name, 0.0), dc)
    # the benchmark's engine cells at their calls' shapes: 128 channels on
    # the wide route (the X kernel's tiled instance) at K = 1 and 3 and 512
    # (its band instance, the epilogue's narrow one) at K = 1 in both
    # ingests, and the flagship's K = 64 on the shared route in
    # effex2.engine's, complex64 (parts_batch's offsets grow with K: at 64
    # the int8 blocks' means reach 3.6 sigma, where the float32 cancellation
    # next to the DC bin passes FIN_TOL + CANCEL_TOL in the plain epilogue
    # as well as the kernel's)
    for case, k, int8 in ((NCHAN128, 1, False), (NCHAN128, NCHAN128_K, False),
                          (NCHAN128, 1, True), (NCHAN128, NCHAN128_K, True),
                          (NCHAN512, 1, False), (NCHAN512, 1, True),
                          (FLAGSHIP, FLAGSHIP_K, False)):
        name = ("fx_parts" if case is FLAGSHIP else "fx_parts_wide") + (
            "_i8" if int8 else "")
        print(f"  {name} + fx_finish (direct) K={k} shape {case}",
              flush=True)
        got, dc = compare_parts(case, k, device, "direct", int8)
        if name not in got:
            raise AssertionError(f"{case} K={k} took {sorted(got)}, not "
                                 f"{name}")
        for key, pair in got.items():
            errs[key] = tuple(map(max, errs[key], pair))
        dc_bin[name] = max(dc_bin.get(name, 0.0), dc)
        torch.cuda.empty_cache()
    for int8 in (False, True):
        errs["fx_parts_reduce"] = tuple(map(
            max, errs["fx_parts_reduce"],
            compare_reduce(FLAGSHIP, FLAGSHIP_K, device, int8)))
    for case, k in ((NCHAN128, 1), (NCHAN128, NCHAN128_K), (NCHAN512, 1)):
        errs["fx_xstage"] = tuple(map(max, errs["fx_xstage"],
                                      compare_xstage(case, k, device)))
    torch.cuda.empty_cache()
    step_diff, step_fin, step_routes = 0.0, 0.0, {}
    for tag, case, k, fir, cont, ingests in (
            *(c + ((False, True),) for c in STEP_CASES),
            ("nchan128_k3", NCHAN128, NCHAN128_K, "direct", False,
             (False, True)),
            ("flagship_k64", FLAGSHIP, FLAGSHIP_K, "direct", False,
             (False,))):
        d, f, route = compare_step(case, k, fir, cont, device, ingests)
        step_diff, step_fin = max(step_diff, d), max(step_fin, f)
        step_routes[tag] = route
    print(f"  fx_step against the two-call step, every shape: largest "
          f"difference {step_diff}", flush=True)
    for case in (NCHAN8, CLI8, MANY_PAIRS, WIDE64):
        for k in (1, WIDE_K):
            errs["fx_xstage"] = tuple(map(max, errs["fx_xstage"],
                                          compare_xstage(case, k, device)))
    for _, case, k in REDUCE_CASES:
        for int8 in (False, True):
            errs["fx_parts_reduce"] = tuple(map(
                max, errs["fx_parts_reduce"],
                compare_reduce(case, k, device, int8)))
    # the bench's largest calls, nearest the single pass's cap: every
    # kernel its configurations launch; the FIR launch and the step's one
    # C call at the largest K of each shape (each in both ingests)
    step_cases = {}
    for name, case, k, fir, int8 in bench_cases():
        entry = BENCH_ROUTES[name][0].removesuffix("_svd")
        print(f"  bench {name}: {entry} + fx_finish ({fir}) K={k} shape "
              f"{case}", flush=True)
        got, dc = compare_parts(case, k, device, fir, int8)
        if entry not in got:
            raise AssertionError(f"bench {name}: the single pass took "
                                 f"{sorted(got)}, not {entry}")
        for key, pair in got.items():
            errs[key] = tuple(map(max, errs[key], pair))
        dc_bin[entry] = max(dc_bin.get(entry, 0.0), dc)
        if entry.startswith("fx_parts_wide"):
            errs["fx_xstage"] = tuple(map(max, errs["fx_xstage"],
                                          compare_xstage(case, k, device)))
        else:
            errs["fx_parts_reduce"] = tuple(map(
                max, errs["fx_parts_reduce"],
                compare_reduce(case, k, device, int8)))
        key = (json.dumps(case, sort_keys=True), fir)
        if k > step_cases.get(key, (0,))[0]:
            step_cases[key] = (k, case, name)
    for (_, fir), (k, case, name) in step_cases.items():
        if fir == "svd":
            errs["fir_rows"] = tuple(map(max, errs["fir_rows"],
                                         compare_fir_rows(case, k, fir,
                                                          device)))
        d, f, route = compare_step(case, k, fir, False, device)
        step_diff, step_fin = max(step_diff, d), max(step_fin, f)
        step_routes[f"bench_{name}"] = route
    for case, k in ((SMALL, 3), (FLAGSHIP, 2), (SMALL_DEEP, 3),
                    (DEEP_CLI, 2), (WIDEBAND, 1)):
        print(f"  fx_ablate K={k} shape {case}", flush=True)
        errs["fx_ablate"] = tuple(map(max, errs["fx_ablate"],
                                      compare_ablate(case, k, device)))
    errs.update(compare_probes(device))
    phase("phase 2: every bin count of fxtpu's kernels (ROADMAP K.3)")
    bins_dc = {}
    for tag, case, fir in BIN_CASES:
        for int8 in (False, True):
            print(f"  {tag}: single pass + fx_finish ({fir}, int8 {int8}) "
                  f"shape {case}", flush=True)
            got, dc = compare_parts(case, 1, device, fir, int8)
            for key, pair in got.items():
                errs[key] = tuple(map(max, errs[key], pair))
            bins_dc[f"{tag}{'_i8' if int8 else ''}"] = dc
    k_blocks_err = compare_k_blocks(R3072, MULTI_K, device)
    k_blocks_deep_err = compare_k_blocks(DEEP_CLI, MULTI_K, device, "svd")
    for _, case, k, fir in FIR_CASES:
        errs["fir_rows"] = tuple(map(max, errs["fir_rows"],
                                     compare_fir_rows(case, k, fir, device)))
    for tag, case in (("r3072", R3072), ("r16384", R16384)):
        d, f, route = compare_step(case, 1, "direct", False, device)
        step_diff, step_fin = max(step_diff, d), max(step_fin, f)
        step_routes[tag] = route
    for case in (R16256, R16384):
        errs["fx_xstage"] = tuple(map(max, errs["fx_xstage"],
                                      compare_xstage(case, 1, device)))
    for case in BIN_SPEC_CASES:
        print(f"  spectrometer shape {case}", flush=True)
        errs["spectrometer"] = tuple(map(max, errs["spectrometer"],
                                         compare_spectrometer(case, device)))
    for case in (R3072, R16256):
        print(f"  fx_ablate K=1 shape {case}", flush=True)
        errs["fx_ablate"] = tuple(map(max, errs["fx_ablate"],
                                      compare_ablate(case, 1, device)))

    phase("phase 3: main path (python -m fxtpu_torch)")
    launches, main_counts = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for deep in (False, True):
            for ingest in ("complex64", "int8"):
                print(f"  --ingest {ingest}"
                      + (" --resolution 8192 --ntaps 32" if deep else ""),
                      flush=True)
                name, counts = run_main_path(tmp, ingest, deep)
                main_counts.append(counts)
        for ingest in ("complex64", "int8"):
            print(f"  --ingest {ingest} --blocks_per_dispatch {MULTI_K}",
                  flush=True)
            name, counts = run_staged_main_path(tmp, ingest)
            main_counts.append(counts)
        phase("phase 3: snapshot and resume (the Correlator, "
              "snapshot_every=2, then resume_from, calibrate_on_start="
              "False)")
        resume_err = {}
        for ingest in ("complex64", "int8"):
            for k in (1, MULTI_K):
                resume_err[f"{ingest}_k{k}"] = run_resume_path(tmp, ingest,
                                                               k)
        phase(f"phase 3: the wide route's main path (python -m fxtpu_torch "
              f"--nchan {CLI_NCHAN})")
        for ingest in ("complex64", "int8"):
            print(f"  --ingest {ingest} --nchan {CLI_NCHAN}", flush=True)
            name, counts = run_wide_main_path(tmp, ingest)
            main_counts.append(counts)
        check_wide_engines()
        phase("phase 3: the engine at the benchmark's engine cells "
              "(meerkat_l4k.engine128_int8, effex2.engine, "
              "leda512.engine512_int8)")
        cell_counts, cell_calls = check_cell_engines(device)
        main_counts += cell_calls
        phase("phase 3: the main path at bin counts that are not powers of "
              "two in [256, 8192] (ROADMAP K.3)")
        for tag, flags in BIN_CLI:
            for ingest in ("complex64", "int8"):
                print(f"  --ingest {ingest} {' '.join(flags)}", flush=True)
                main_counts.append(run_bins_main_path(tmp, ingest, tag,
                                                      flags))
        from fxtpu_torch.sources import NoiseSource, save_recording
        rec = save_recording(NoiseSource(nchan=PIPELINE["nchan"], seed=1),
                             os.path.join(tmp, "rec.npy"),
                             PIPELINE["num_samp"], 4)
        pipe = {}
        for ingest in ("complex64", "int8"):
            for k in (MULTI_K, 1):
                pipe[f"{ingest}_k{k}"] = run_pipeline(tmp, rec, ingest, k)
                main_counts.append(pipe[f"{ingest}_k{k}"]["launches"])
        phase("phase 3: the host data plane (fxtpu_torch/csrc/host): "
              "native against Python, A B B A, then each stage alone")
        host_record.update(run_host_plane(rec, device, card))
        phase("phase 3: scale-out (fxtpu_torch.parallel: meshes of shards "
              "on the card, two processes)")
        scale_counts, scaleout = run_scaleout(tmp, device, card)
        main_counts += scale_counts
        phase("phase 3: the scaling bench (python -m fxtpu_torch.scaling_bench,"
              " shards of the card) and examples/observe_torch.sh")
        bench_counts, surface = run_scaling_bench(card)
        main_counts += bench_counts
        surface["observe_example"] = run_observe_example(tmp, card)
        phase("phase 3: the bench (fxtpu_torch.bench: every configuration "
              "in this process, then python -m fxtpu_torch.bench)")
        t_bench = time.perf_counter()
        bench_counts, bench_lines = run_bench_configs(card)
        main_counts += bench_counts
        bench_record = {"configs": bench_lines,
                        "module": run_bench_module(tmp, card)}
        bench_record["seconds"] = time.perf_counter() - t_bench
        print(f"  the bench phase: {bench_record['seconds']:.1f} s",
              flush=True)
    # the single-pass entries' launches on the main path, both FIR modes
    for name in ("fx_parts", "fx_parts_i8", "fx_parts_wide",
                 "fx_parts_wide_i8"):
        launches[name] = sum(c[name] + c[name + "_svd"] for c in main_counts)
    launches["fx_xstage"] = sum(c["fx_xstage"] for c in main_counts)
    launches["fx_parts_reduce"] = sum(c["fx_parts_reduce"]
                                      for c in main_counts)
    launches["fx_finish"] = sum(c["fx_finish"] for c in main_counts)
    launches["fir_rows"] = sum(c["fir_rows"] for c in main_counts)
    print(f"  main path, every run: launches {launches}", flush=True)
    phase("phase 3: the two-pass entries (fx_fused_raw* and finish)")
    launches.update(run_two_pass_path(device))
    launches["spectrometer"] = run_spectrometer_path(device)
    phase("phase 3: the measurement path (python -m fxtpu_torch.probes)")
    from fxtpu_torch.ops.fx_fused import deep_fir
    launches.update({name: 0 for name in PROBE_KERNELS})
    ablate_runs, probe_records = [], {}

    def probe(tag, argv, expect):
        records, counts = run_probe(argv, expect)
        for name in PROBE_KERNELS:
            launches[name] += counts[name]
        probe_records[tag] = records
        return records

    for tag, case, ks, firs, iters in (
            ("flagship", FLAGSHIP, (1, MULTI_K), ("auto",), 20),
            ("pipeline", PIPELINE_BLOCK, (1, MULTI_K), ("auto",), 10),
            ("deep", DEEP_CLI, (1, MULTI_K), ("direct", "svd"), 6),
            ("wideband", WIDEBAND, (1, MULTI_K), ("direct", "svd"), 3),
            ("r3072", R3072, (1,), ("auto",), 10),
            ("r16256", R16256, (1,), ("auto",), 6)):
        for k in ks:
            for ingest in ("complex64", "int8"):
                for fir in firs:
                    argv = ["ablate", "--num_samp", str(case["nsamp"]),
                            "--nbins", str(case["nbins"]), "--ntaps",
                            str(case["ntaps"]), "--k", str(k), "--ingest",
                            ingest, "--fir_mode", fir, "--iters", str(iters)]
                    # a deep-tap launch runs the FIR launch first
                    expect = ["fx_ablate"] + (["fir_rows"] if deep_fir(
                        case["ntaps"], case["nsamp"] // case["nbins"])
                        else [])
                    ablate_runs.append((tag, probe(
                        f"ablate_{tag}_{k}_{ingest}_{fir}", argv, expect)))
    probe("copy_rate", ["copy_rate"], ["copy_probe"])
    for mech in ("bulk", "cp_async"):
        probe(f"overlap_{mech}", ["overlap", "--mech", mech],
              ["overlap_probe"])
    probe("retile", ["retile"], ["retile_probe"])
    for nsamp in (FLAGSHIP["nsamp"], PIPELINE_BLOCK["nsamp"]):
        recs = probe(f"breakdown_{nsamp}", [
            "breakdown", "--num_samp", str(nsamp), "--k", str(MULTI_K)],
            ["fx_parts", "fx_parts_reduce", "fx_finish"])
        for rec in recs:
            print(f"    breakdown {nsamp} {rec['route']}: against the float64 "
                  f"oracle {rec['max_rel_err']:.3g} of max|vis| (DC bins "
                  f"{rec['max_rel_err_dc']:.3g}), multi_step "
                  f"{rec['ms_per_block']:.4f} ms/block, "
                  f"{rec['gs_per_s']:.4f} GS/s", flush=True)
            if not rec["max_rel_err"] <= 3.1e-5 or not rec[
                    "multi_step_block0_is_step"]:
                raise AssertionError(f"breakdown: {rec}")
    probe("all", ["all"], [*PROBE_KERNELS, "fx_parts", "fx_parts_reduce",
                           "fx_finish"])

    phase("phase 4: times at the flagship and wideband shapes "
          f"({threading.active_count()} threads alive)")
    kt, st, h2d, call_launches = time_flagship(device)
    wkt, wst, wh2d, wide_launches = time_wideband(device)
    mkt = time_multi_kernels(device)
    mst, mct, step_launches = time_multi_step(device)
    spt, sp_launches, sp_us = time_single_pass(device)
    wdt, wd_us, wd_launches = time_wide(device)
    n512_ms, n512_us = time_nchan512(device)
    xrt, xr_us = time_x_routes(device)
    rdt, rd_us = time_reduce(device)
    step_ab = time_steps(device)
    split = host_split(device)
    step_launches.update(call_launches)
    step_launches.update(wide_launches)
    table = stage_table(ablate_runs, device)
    bt, bt_us = time_bins(device)
    ft, ft_us = time_fir_rows(device)
    samples = FLAGSHIP["nch"] * FLAGSHIP["nsamp"]
    wsamples = WIDEBAND["nch"] * WIDEBAND["nsamp"]
    for name, sfx in (("fx_fused", ""), ("fx_fused_i8", "_i8")):
        print(f"  [{card}] flagship {name} kernel {kt['kernel' + sfx]:.4f} "
              f"ms, plain torch {kt['plain' + sfx]:.4f} ms", flush=True)
        print(f"  [{card}] flagship {name} engine step: kernel route "
              f"{st['kernel' + sfx]:.4f} ms "
              f"({samples / st['kernel' + sfx] / 1e6:.4f} GS/s), plain "
              f"route {st['plain' + sfx]:.4f} ms "
              f"({samples / st['plain' + sfx] / 1e6:.4f} GS/s)", flush=True)
        print(f"  [{card}] wideband {name}: SVD kernel "
              f"{wkt['svd' + sfx]:.4f} ms, direct-loop kernel "
              f"{wkt['direct' + sfx]:.4f} ms, plain SVD "
              f"{wkt['plain_svd' + sfx]:.4f} ms, plain direct "
              f"{wkt['plain_direct' + sfx]:.4f} ms", flush=True)
        print(f"  [{card}] wideband {name} engine step: kernel route (SVD) "
              f"{wst['kernel' + sfx]:.4f} ms "
              f"({wsamples / wst['kernel' + sfx] / 1e6:.4f} GS/s), plain "
              f"route {wst['plain' + sfx]:.4f} ms "
              f"({wsamples / wst['plain' + sfx] / 1e6:.4f} GS/s)", flush=True)
        print(f"  [{card}] many pairs {name} ({MANY_PAIRS['nch']} channels "
              f"with autos, flagship width): kernel "
              f"{kt['kernel_many' + sfx]:.4f} ms "
              f"({kt['device_us_many' + sfx]:.2f} us of device time), plain "
              f"torch {kt['plain_many' + sfx]:.4f} ms", flush=True)
    print(f"  [{card}] flagship spectrometer kernel "
          f"{kt['kernel_spec']:.4f} ms, plain torch {kt['plain_spec']:.4f} ms",
          flush=True)
    for ingest in h2d:
        print(f"  [{card}] one block to the card ({ingest}): flagship "
              f"{h2d[ingest]:.4f} ms, wideband {wh2d[ingest]:.4f} ms",
              flush=True)
    for tag in mkt:
        t = mkt[tag]
        print(f"  [{card}] {tag} per block: one K={MULTI_K} launch "
              f"{t['multi']:.4f} ms, {MULTI_K} one-block launches "
              f"{t['singles']:.4f} ms, plain {t['plain']:.4f} ms", flush=True)
    for sfx, ingest in (("", "complex64"), ("_i8", "int8")):
        print(f"  [{card}] flagship {ingest} per block: multi_step "
              f"{mst['multi_step' + sfx]:.4f} ms against step "
              f"{mst['step' + sfx]:.4f} ms; copy of {MULTI_K} blocks, pinned "
              f"on a side stream {mct['pinned' + sfx]:.4f} ms against "
              f"pageable {mct['pageable' + sfx]:.4f} ms", flush=True)
    for key, r in pipe.items():
        print(f"  [{card}] pipeline {key}: {r['blocks_per_s']:.4f} blocks/s, "
              f"{r['msamp_per_s']:.4f} Msamp/s, device busy "
              f"{100 * r['busy_share']:.4f}%", flush=True)
    print(f"  [{card}] device launches per call: {step_launches} (a step "
          "at the flagship: frame kernel, reduce and epilogue; multi_step: "
          f"the same for {MULTI_K} blocks; the two-pass wrappers alone; a "
          "wideband step in the SVD mode)", flush=True)
    print(f"  [{card}] single pass (new) against the two-pass form (old), "
          f"in turns, device launches per call: {sp_launches}", flush=True)
    for sfx, what in (("", "flagship complex64"), ("_i8", "flagship int8"),
                      ("_pipeline", "pipeline block complex64"),
                      ("_pipeline_i8", "pipeline block int8")):
        line = (f"  [{card}] {what}: step {spt['step_new' + sfx]:.4f} ms new "
                f"/ {spt['step_old' + sfx]:.4f} old")
        if "multi_step_new" + sfx in spt:
            line += (f"; multi_step per block "
                     f"{spt['multi_step_new' + sfx]:.4f} / "
                     f"{spt['multi_step_old' + sfx]:.4f}")
        print(line + f"; one block's copy by the host's clock, pinned "
              f"{spt['copy_pinned' + sfx]:.4f} ms / pageable "
              f"{spt['copy_pageable' + sfx]:.4f} (pinned through "
              f"numpy's copyto {spt['copy_pinned_numpy' + sfx]:.4f}), by "
              "events "
              f"{spt['copy_events_pinned' + sfx]:.4f} / "
              f"{spt['copy_events_pageable' + sfx]:.4f} ms; device us per "
              f"kernel of a step: new {sp_us['step_new' + sfx]}, old "
              f"{sp_us['step_old' + sfx]}", flush=True)
    for sfx in ("", "_i8"):
        print(f"  [{card}] flagship multi_step{sfx} device us per block: new "
              f"{sp_us['multi_step_new' + sfx]}, old "
              f"{sp_us['multi_step_old' + sfx]}", flush=True)
    print(f"  [{card}] flagship wrappers: fx_fused_parts {spt['parts']:.4f} "
          f"ms (plain {spt['parts_plain']:.4f}), fx_fused_parts_i8 "
          f"{spt['parts_i8']:.4f} (plain {spt['parts_i8_plain']:.4f}), "
          f"fx_finish {spt['finish']:.4f} (plain {spt['finish_plain']:.4f}; "
          f"device us alone {spt['finish_device_us']:.3f}); "
          f"DC bin, worst of phase 2, of max|vis|: {dc_bin}", flush=True)
    for tag, what in (("nchan8", "nchan8 block (8 x 2^20, 4096 bins, 36 "
                                 "baselines)"),
                      ("cli8", "--nchan 8 CLI block (8 x 2^18, 4096 bins, "
                               "28 baselines)"),
                      ("deep8", "8-channel deep CLI block (8 x 2^18, 8192 "
                                "bins, 32 taps, SVD)")):
        for sfx in ("", "_i8"):
            print(f"  [{card}] wide route, {what}{sfx}: fx_fused_parts "
                  f"{wdt['parts_' + tag + sfx]:.4f} ms (plain "
                  f"{wdt['plain_' + tag + sfx]:.4f}), device us a call "
                  f"{wd_us[tag + sfx]}", flush=True)
    for tag, what in (("", "nchan8"), ("_cli8", "--nchan 8 CLI")):
        print(f"  [{card}] X kernel alone at the {what} block: fx_xstage "
              f"{wdt['xstage' + tag]:.4f} ms (device us "
              f"{wd_us['xstage_alone' + tag]}), plain "
              f"{wdt['xstage_plain' + tag]:.4f}, torch.matmul Gram "
              f"{wdt['xstage_library' + tag]:.4f} (device us "
              f"{wd_us['xstage_library' + tag]}); bound "
              f"{xstage_bound(CLI8 if tag else NCHAN8, 1)[0]:.5f} ms",
              flush=True)
    for tag, case, k in REDUCE_CASES:
        bnd = {i8: parts_reduce_bound(case, k, i8)[0] for i8 in (False,
                                                                 True)}
        print(f"  [{card}] parts reduce alone, {tag} (K={k}): c64 "
              f"{rdt[tag]:.4f} ms (device us {rd_us[tag]}), int8 "
              f"{rdt[tag + '_i8']:.4f} ms (device us {rd_us[tag + '_i8']}); "
              f"plain {rdt['plain_' + tag]:.4f} / "
              f"{rdt['plain_' + tag + '_i8']:.4f}; torch.sum(partial, "
              f"dim=1) {rdt['library_' + tag]:.4f} (device us "
              f"{rd_us['library_' + tag]}); bound "
              f"{bnd[False]:.5f} / {bnd[True]:.5f} ms", flush=True)
    for key in xrt:
        if key.endswith("_shared"):
            wide = key[:-len("shared")] + "global"
            print(f"  [{card}] single pass, X stage A/B at {key[:-7]}: "
                  f"shared {xrt[key]:.4f} ms (device us {xr_us[key]}), "
                  f"global {xrt[wide]:.4f} ms (device us {xr_us[wide]})",
                  flush=True)
    for sfx in ("", "_i8"):
        print(f"  [{card}] nchan8 engine step{sfx}: kernel route "
              f"{wdt['step_kernel' + sfx]:.4f} ms, plain route "
              f"{wdt['step_plain' + sfx]:.4f} ms; device launches "
              f"{wd_launches['step' + sfx]}, device us "
              f"{wd_us['step' + sfx]}", flush=True)
    print(f"  [{card}] stage table: the frame kernel's device time per "
          "block after each stage, us (pre-pass, reduce; torch.fft.fft "
          "over one block beside them)", flush=True)
    for row in table:
        fr = row["frames_us"]
        print(f"    {row['shape']} K={row['k']} {row['ingest']} "
              f"{row['fir_mode']}: "
              + ", ".join(f"{st} {fr[st]:.2f}" for st in fr)
              + f" (pre-pass {row['prepass_us']:.2f}, FIR launch "
              f"{row['fir_us']}, reduce "
              f"{row['reduce_us']:.2f}; torch.fft.fft "
              f"{1e3 * row['library_ms']:.2f})", flush=True)
    for row in table:
        if row["shape"] == "flagship" and row["k"] == 1:
            print(f"  [{card}] flagship {row['ingest']} FFT stage (fft - "
                  f"fir, the radix-16 passes over one block's frames): "
                  f"{row['fft_stage_us']:.2f} us of device time against "
                  f"torch.fft.fft over the same [nch, S, nbins] "
                  f"{1e3 * row['library_ms']:.2f} us by events", flush=True)
    for row in table:
        if row["shape"] in ("r3072", "r16256"):
            print(f"  [{card}] {row['shape']} {row['ingest']} FFT stage (fft "
                  f"- fir, the mixed-radix passes over one block's frames, "
                  f"two-pass kernel K=1): {row['fft_stage_us']:.2f} us of "
                  f"device time against torch.fft.fft over the same [nch, "
                  f"S, nbins] {1e3 * row['library_ms']:.2f} us by events",
                  flush=True)
    bins_bounds = {}
    for tag, case, fir in BIN_CASES:
        fac = window_and_fir(case, fir, device)[1]
        rank = 0 if fac is None else fac[0].shape[1]
        for int8 in (False, True):
            key = tag + ("_i8" if int8 else "")
            bins_bounds[key] = fx_bound(case, 1, int8, rank, parts=True)
            print(f"  [{card}] {key} ({case['nbins']} bins, {fir}): "
                  f"fx_fused_parts{'_i8' if int8 else ''} "
                  f"{bt['parts_' + key]:.4f} ms (plain "
                  f"{bt['plain_' + key]:.4f}), device us {bt_us[key]}; "
                  f"bound {bins_bounds[key][0]:.5f} ms "
                  f"({bins_bounds[key][1]})", flush=True)
    for case in BIN_SPEC_CASES:
        key = f"spec_r{case['nbins']}"
        bins_bounds[key] = fx_bound(case, 1, False, 0, spectra=True)
        print(f"  [{card}] spectrometer at {case['nbins']} bins: "
              f"{bt[key]:.4f} ms (plain {bt['plain_' + key]:.4f}), device us "
              f"{bt_us[key]}; bound {bins_bounds[key][0]:.5f} ms "
              f"({bins_bounds[key][1]})", flush=True)
    bins_bounds["xstage_r16384"] = xstage_bound(R16384, 1)
    print(f"  [{card}] X kernel alone at 16384 bins: fx_xstage "
          f"{bt['xstage_r16384']:.4f} ms (device us {bt_us['xstage_r16384']}),"
          f" plain {bt['xstage_plain_r16384']:.4f}, torch.matmul Gram "
          f"{bt['xstage_library_r16384']:.4f} (device us "
          f"{bt_us['xstage_library_r16384']}); bound "
          f"{bins_bounds['xstage_r16384'][0]:.5f} ms", flush=True)
    for rec in probe_records["copy_rate"]:
        if rec["sweep"] == "width" or rec["mode"] in ("chan", "prod"):
            print(f"    copy {rec['sweep']} {rec['walk']} "
                  f"{rec.get('mode', '')} {rec.get('ingest', '')} "
                  f"{rec['mech']} {rec['width']} B: {rec['gbps']:.1f} GB/s",
                  flush=True)
    for mech in ("bulk", "cp_async"):
        for rec in probe_records[f"overlap_{mech}"]:
            if "summary" in rec:
                print(f"    overlap {mech} {rec['structure']} "
                      f"{rec['summary']}: copy {rec['copy_ms']:.4f} + comp "
                      f"{rec['comp_ms']:.4f} = {rec['sum_ms']:.4f}, max "
                      f"{rec['max_ms']:.4f}, measured "
                      f"{rec['measured_ms']:.4f} ms", flush=True)
    for rec in probe_records["retile"]:
        print(f"    retile {rec['form']}: {rec['ps_per_sample']:.4f} ps per "
              f"sample ({rec['us_per_tile']:.4f} us per tile)", flush=True)

    def bound(case, k, int8, rank=0, spectra=False):
        ms, by = fx_bound(case, k, int8, rank, spectra)
        return {"bound_ms": ms, "bound_by": by, "library_ms": None}

    # the rank of the 32-tap window's factors at each deep shape
    ranks = {tag: next(r["rank"] for r in recs if "stage" in r)
             for tag, recs in probe_records.items()
             if tag.endswith("_svd")}
    wide_rank = ranks["ablate_wideband_1_complex64_svd"]
    deep_rank = ranks[f"ablate_deep_{MULTI_K}_complex64_svd"]
    kernels = []
    for name, sfx, ingest in (("fx_fused", "", "complex64"),
                              ("fx_fused_i8", "_i8", "int8")):
        many_bound = fx_bound(MANY_PAIRS, 1, ingest == "int8", 0)
        kernels.append({
            **bound(FLAGSHIP, 1, ingest == "int8"),
            "wideband_bound_ms": fx_bound(WIDEBAND, 1, ingest == "int8",
                                          0)[0],
            # the two-pass form of the step (two_pass_steps)
            "step_device_launches": sp_launches["step_old" + sfx],
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": kt["kernel" + sfx], "plain_ms": kt["plain" + sfx],
            "step_ms": spt["step_old" + sfx],
            "plain_step_ms": st["plain" + sfx], "h2d_ms": h2d[ingest],
            "wideband_ms": wkt["direct" + sfx],
            "wideband_plain_ms": wkt["plain_direct" + sfx],
            "many_pairs_ms": kt["kernel_many" + sfx],
            "many_pairs_device_us": kt["device_us_many" + sfx],
            "many_pairs_plain_ms": kt["plain_many" + sfx],
            "many_pairs_bound_ms": many_bound[0],
            "many_pairs_bound_by": many_bound[1],
        })
    for name, sfx, ingest in (("fx_fused_svd", "", "complex64"),
                              ("fx_fused_i8_svd", "_i8", "int8")):
        kernels.append({
            **bound(WIDEBAND, 1, ingest == "int8", wide_rank),
            "svd_form_operations_ms": svd_form_ms(WIDEBAND, 1, wide_rank),
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": wkt["svd" + sfx], "plain_ms": wkt["plain_svd" + sfx],
            "direct_ms": wkt["direct" + sfx],
            "step_device_launches": step_launches["wideband_step" + sfx],
            "step_ms": wst["kernel" + sfx],
            "plain_step_ms": wst["plain" + sfx], "h2d_ms": wh2d[ingest],
        })
    for name, sfx, ingest in (("fx_fused_multi", "", "complex64"),
                              ("fx_fused_i8_multi", "_i8", "int8")):
        fl, dp = mkt["flagship" + sfx], mkt["deep" + sfx]
        per_block = {key: v / MULTI_K if key == "bound_ms" else v
                     for key, v in bound(FLAGSHIP, MULTI_K,
                                         ingest == "int8").items()}
        kernels.append({
            **per_block,
            "deep_svd_bound_ms": fx_bound(DEEP_CLI, MULTI_K, ingest == "int8",
                                          deep_rank)[0] / MULTI_K,
            "deep_svd_form_operations_ms": svd_form_ms(DEEP_CLI, 1,
                                                       deep_rank),
            "step_device_launches": sp_launches["multi_step_old" + sfx],
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "k": MULTI_K, "ms": fl["multi"], "plain_ms": fl["plain"],
            "one_block_launches_ms": fl["singles"],
            "deep_svd_ms": dp["multi"], "deep_svd_plain_ms": dp["plain"],
            "deep_svd_one_block_launches_ms": dp["singles"],
            "step_ms": spt["multi_step_old" + sfx],
            "one_block_step_ms": spt["step_old" + sfx],
            "pinned_copy_ms": mct["pinned" + sfx],
            "pageable_copy_ms": mct["pageable" + sfx],
            "pipeline": {f"k{k}": {key: v for key, v in
                                   pipe[f"{ingest}_k{k}"].items()
                                   if key != "launches"}
                         for k in (1, MULTI_K)},
        })
    kernels.append({
        **bound(SPEC_CASES[-1], 1, False, spectra=True),
        "name": "spectrometer", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["spectrometer"],
        "launches": launches["spectrometer"],
        "max_abs_err": errs["spectrometer"][0],
        "max_rel_err": errs["spectrometer"][1],
        "ms": kt["kernel_spec"], "plain_ms": kt["plain_spec"],
        "device_launches": step_launches["spectrometer_fused"],
    })
    for name, sfx, int8 in (("fx_parts", "", False),
                            ("fx_parts_i8", "_i8", True)):
        ms, by = fx_bound(FLAGSHIP, 1, int8, 0, parts=True)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": spt["parts" + sfx],
            "plain_ms": spt["parts" + sfx + "_plain"],
            "bound_ms": ms, "bound_by": by, "library_ms": None,
            "pipeline_bound_ms": fx_bound(PIPELINE_BLOCK, 1, int8, 0,
                                          parts=True)[0],
            "dc_bin_max_rel_err": dc_bin[name],
            "device_us": {"flagship": sp_us["step_new" + sfx],
                          "flagship_k8_per_block":
                              sp_us["multi_step_new" + sfx],
                          "pipeline": sp_us["step_new_pipeline" + sfx]},
            "two_pass_device_us": {
                "flagship": sp_us["step_old" + sfx],
                "flagship_k8_per_block": sp_us["multi_step_old" + sfx],
                "pipeline": sp_us["step_old_pipeline" + sfx]},
            "step_device_launches": sp_launches["step_new" + sfx],
            "two_pass_step_device_launches": sp_launches["step_old" + sfx],
            "step_ms": spt["step_new" + sfx],
            "two_pass_step_ms": spt["step_old" + sfx],
            "multi_step_ms": spt["multi_step_new" + sfx],
            "two_pass_multi_step_ms": spt["multi_step_old" + sfx],
            "pipeline_step_ms": spt["step_new_pipeline" + sfx],
            "two_pass_pipeline_step_ms": spt["step_old_pipeline" + sfx],
            "copy_ms": {key: spt["copy_" + key + sfx]
                        for key in ("pinned", "pageable")},
            "pipeline_copy_ms": {
                key: spt[f"copy_{key}_pipeline{sfx}"]
                for key in ("pinned", "pageable", "pinned_numpy")},
            "pipeline_copy_events_ms": {
                key: spt[f"copy_events_{key}_pipeline{sfx}"]
                for key in ("pinned", "pageable")},
        })
    for name, sfx, int8 in (("fx_parts_wide", "", False),
                            ("fx_parts_wide_i8", "_i8", True)):
        ms, by = fx_bound(NCHAN8, 1, int8, 0, parts=True)
        deep_ms, deep_by = fx_bound(DEEP8, 1, int8, deep_rank, parts=True)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": wdt["parts_nchan8" + sfx],
            "plain_ms": wdt["plain_nchan8" + sfx],
            "bound_ms": ms, "bound_by": by, "library_ms": None,
            "shape": "nchan8", "device_us": wd_us["nchan8" + sfx],
            "deep8_ms": wdt["parts_deep8" + sfx],
            "deep8_plain_ms": wdt["plain_deep8" + sfx],
            "deep8_bound_ms": deep_ms, "deep8_bound_by": deep_by,
            "deep8_device_us": wd_us["deep8" + sfx],
            "cli8_ms": wdt["parts_cli8" + sfx],
            "cli8_plain_ms": wdt["plain_cli8" + sfx],
            "cli8_device_us": wd_us["cli8" + sfx],
            "dc_bin_max_rel_err": dc_bin[name],
            "step_ms": wdt["step_kernel" + sfx],
            "plain_step_ms": wdt["step_plain" + sfx],
            "step_device_launches": wd_launches["step" + sfx],
            "step_device_us": wd_us["step" + sfx],
            # the two X stages at shapes both take, timed in one process
            "x_stage_ab_ms": {k: v for k, v in xrt.items()
                              if ("_i8_" in k) == int8},
            "x_stage_ab_device_us": {k: v for k, v in xr_us.items()
                                     if ("_i8_" in k) == int8},
        })
    ms, by = xstage_bound(NCHAN8, 1)
    cli8_ms, cli8_by = xstage_bound(CLI8, 1)
    kernels.append({
        "name": "fx_xstage", "route": "cuda", "source": XSTAGE_SOURCE,
        "replaces": REPLACES["fx_xstage"], "launches": launches["fx_xstage"],
        "max_abs_err": errs["fx_xstage"][0],
        "max_rel_err": errs["fx_xstage"][1],
        "ms": wdt["xstage"], "plain_ms": wdt["xstage_plain"],
        "bound_ms": ms, "bound_by": by,
        "library_ms": wdt["xstage_library"],
        "library": "torch.matmul [nbins, nch, S] @ [nbins, S, nch]^H",
        "shape": "nchan8", "device_us": wd_us["xstage_alone"],
        # the wide route's main path (--nchan 8 at the CLI defaults)
        "cli8_ms": wdt["xstage_cli8"],
        "cli8_plain_ms": wdt["xstage_plain_cli8"],
        "cli8_bound_ms": cli8_ms, "cli8_bound_by": cli8_by,
        "cli8_library_ms": wdt["xstage_library_cli8"],
        "cli8_device_us": wd_us["xstage_alone_cli8"],
        "library_device_us": {"nchan8": wd_us["xstage_library"],
                              "cli8": wd_us["xstage_library_cli8"]},
        # the X kernel inside the wide route's call, each ingest
        "in_call_device_us": {key: wd_us[key].get("xstage") for key in (
            "nchan8", "nchan8_i8", "cli8", "cli8_i8")},
        # LEDA's block (512 channels, one block): the band instance alone
        "nchan512_ms": n512_ms["xstage"],
        "nchan512_device_us": n512_us["xstage"],
        "nchan512_bound_ms": xstage_bound(NCHAN512, 1)[0],
        "nchan512_bound_by": xstage_bound(NCHAN512, 1)[1],
    })
    ms, by = parts_reduce_bound(FLAGSHIP, 1)
    kernels.append({
        "name": "fx_parts_reduce", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["fx_parts_reduce"],
        "launches": launches["fx_parts_reduce"],
        "max_abs_err": errs["fx_parts_reduce"][0],
        "max_rel_err": errs["fx_parts_reduce"][1],
        "ms": rdt["flagship"], "plain_ms": rdt["plain_flagship"],
        "bound_ms": ms, "bound_by": by,
        "library_ms": rdt["library_flagship"],
        "library": "torch.sum(partial, dim=1) over [K, n_groups, nbl + 2 "
                   "nch, nbins] complex64 (the GJ rows of every group; the "
                   "kernel reads those of n_gj groups)",
        "shape": "flagship",
        "times_ms": {key: v for key, v in rdt.items()},
        "device_us": rd_us,
        "bound_ms_by_shape": {
            tag + ("_i8" if i8 else ""): parts_reduce_bound(case, k, i8)[0]
            for tag, case, k in REDUCE_CASES for i8 in (False, True)},
    })
    ms, by = finish_bound(FLAGSHIP, 1)
    kernels.append({
        "name": "fx_finish", "route": "cuda", "source": FINISH_SOURCE,
        "replaces": REPLACES["fx_finish"], "launches": launches["fx_finish"],
        "max_abs_err": errs["fx_finish"][0],
        "max_rel_err": errs["fx_finish"][1],
        "ms": spt["finish"], "plain_ms": spt["finish_plain"],
        "bound_ms": ms, "bound_by": by, "library_ms": None,
        # launched alone; in a step its record also holds its wait
        "device_us": spt["finish_device_us"],
        "step_device_us": sp_us["step_new"].get("finish"),
        "step_exposed_us": {key: rec["one_call"]["exposed_us"]
                            for key, rec in step_ab.items()},
        "two_call_exposed_us": {key: rec["two_call"]["exposed_us"]
                                for key, rec in step_ab.items()},
        # the step's one C call, whose third kernel it is
        "entry": "fxt_fx_step, fxt_fx_step_i8", "step_source": STEP_SOURCE,
        "step_max_diff_vs_two_call": step_diff,
        "step_max_rel_err_vs_plain_epilogue": step_fin,
        "step_routes": step_routes,
        "bound_ms_by_shape": {
            tag: finish_bound(case, k)[0]
            for tag, case, k, _, _ in STEP_CASES},
        "step_ab": step_ab, "host_split_us": split,
        "resume_max_rel_err": resume_err,
        # LEDA's block (512 channels, one block): the narrow pair-tiled
        # instance alone
        "nchan512_ms": n512_ms["finish"],
        "nchan512_device_us": n512_us["finish"],
        "nchan512_bound_ms": finish_bound(NCHAN512, 1)[0],
        "nchan512_bound_by": finish_bound(NCHAN512, 1)[1],
    })
    kernels += probe_kernel_entries(table, probe_records, launches, errs,
                                    mkt, device)
    # the bin counts of ROADMAP K.3, by the entry that ran each
    bins = {}
    for tag, case, fir in BIN_CASES:
        for int8 in (False, True):
            key = tag + ("_i8" if int8 else "")
            wide = "xstage" in bt_us[key]
            name = ("fx_parts_wide" if wide else "fx_parts") + (
                "_i8" if int8 else "")
            bins.setdefault(name, {})[tag] = {
                "nbins": case["nbins"], "ntaps": case["ntaps"],
                "fir_mode": fir, "ms": bt["parts_" + key],
                "plain_ms": bt["plain_" + key], "device_us": bt_us[key],
                "bound_ms": bins_bounds[key][0],
                "bound_by": bins_bounds[key][1], "library_ms": None,
                "dc_bin_max_rel_err": bins_dc[key]}
    bins["spectrometer"] = {
        f"r{case['nbins']}": {
            "nbins": case["nbins"], "ms": bt[f"spec_r{case['nbins']}"],
            "plain_ms": bt[f"plain_spec_r{case['nbins']}"],
            "device_us": bt_us[f"spec_r{case['nbins']}"],
            "bound_ms": bins_bounds[f"spec_r{case['nbins']}"][0],
            "bound_by": bins_bounds[f"spec_r{case['nbins']}"][1],
            "library_ms": None} for case in BIN_SPEC_CASES}
    bins["fx_xstage"] = {"r16384": {
        "nbins": 16384, "ms": bt["xstage_r16384"],
        "plain_ms": bt["xstage_plain_r16384"],
        "device_us": bt_us["xstage_r16384"],
        "bound_ms": bins_bounds["xstage_r16384"][0],
        "bound_by": bins_bounds["xstage_r16384"][1],
        "library_ms": bt["xstage_library_r16384"],
        "library_device_us": bt_us["xstage_library_r16384"]}}
    fir_bounds = {tag + ("_i8" if i8 else ""): fir_bound(case, k, i8)
                  for tag, case, k, _ in FIR_CASES for i8 in (False, True)}
    kernels.append({
        "name": "fir_rows", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["fir_rows"], "launches": launches["fir_rows"],
        "max_abs_err": errs["fir_rows"][0],
        "max_rel_err": errs["fir_rows"][1],
        # the deep CLI block (--resolution 8192 --ntaps 32, 2 x 2^18
        # samples), the main path's deep-tap shape, complex64
        "shape": "deep", "ms": ft["deep"], "plain_ms": ft["plain_deep"],
        "bound_ms": fir_bounds["deep"][0], "bound_by": fir_bounds["deep"][1],
        "library_ms": None,
        "library": "none: a per-bin FIR along the frame axis is a grouped "
                   "convolution only in another layout",
        "device_us": ft_us, "times_ms": ft,
        "bound_ms_by_shape": {key: b[0] for key, b in fir_bounds.items()},
    })
    for entry in kernels:
        if entry["name"] in bins:
            entry["bin_counts"] = bins[entry["name"]]
        if entry["name"] == "fx_parts":
            # the scale-out phase: each shard's single pass is this entry
            entry["scaleout"] = scaleout
        # the launch counts of one multi_step call at each engine cell
        for cell, moved in cell_counts.items():
            for key, n in moved.items():
                if key.split(".")[0] == entry["name"]:
                    entry.setdefault("cells", {}).setdefault(cell, {})[
                        key] = n
        if entry["name"] == "fx_finish":
            entry["k8_r3072_max_rel_err_vs_steps"] = k_blocks_err
            entry["k8_deep_max_rel_err_vs_steps"] = k_blocks_deep_err
    for entry in kernels:
        missing = {"name", "route", "source", "replaces", "launches",
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms"} - set(entry)
        if missing or not entry["launches"] >= 1:
            raise AssertionError(f"kernel entry {entry.get('name')}: missing "
                                 f"{missing} or never launched")
    print(f"  whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"scaling_bench": surface, "card": card}), flush=True)
    print(json.dumps({"bench": bench_record, "card": card}), flush=True)
    print(json.dumps({"host_plane": host_record, "card": card}), flush=True)
    print(json.dumps({"stage_table": table, "card": card,
                      "build_seconds": cuda_build.build_seconds}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
