// The X stage of the single-pass FX step over spectra in device memory:
// the route for channel counts whose spectra of one frame do not fit in
// one CTA's shared memory together.  Built by fxtpu_torch/cuda_build.py,
// launched through fxt_xstage / fxt_xstage_i8 (fxtpu_torch/ops/fx_xstage.py)
// after fx_fused.cu's fxt_fx_wide_frames / fxt_fx_wide_frames_i8 (WideOut:
// each channel's spectrum written out as it is done), and alone
// (fx_xstage.fx_xstage).
//
// Replaces: the X loop of fxtpu/ops/pfb_pallas.py _fx_kernel (:1078-1118,
// any pair list, autos with no imaginary part) and its single-pass
// accumulators tout_ref and uout_ref (:993-1076) for nch up to
// MAX_FUSED_NCHAN = 64 (:87), where the TPU kernel keeps every channel's
// spectra of a tile of frames in VMEM; a CTA's 227 KiB cannot hold nch
// spectra of 4096 or 8192 bins beyond 6 or 2 channels.  The port's wide
// route goes on to fx_fused.MAX_WIDE_NCHAN = 512 channels (LEDA's 256
// dual-polarisation antennas: 131,328 pairs with autos).
//
// Contract, per block k, bin b and frame f = 0 .. S-1 of spec [K, nch, S,
// nbins]:
//   parts[k, l, b]         = sum_f spec[k, p_l, f, b] conj(spec[k, q_l, f, b])
//                            (l < nbl; imaginary part exactly 0 where
//                            p_l = q_l);
//   parts[k, nbl + c, b]   = sum_f spec[k, c, f, b]                     (T);
//   parts[k, nbl + nch + c, b]
//                          = sum_{f < halo} spec[k, c, f, b] conj(da[f, b])
//                                                                     (GJ);
// each summed in frame order, f = 0 first, in float32.  With `x` set the
// launch also does what the shared route's reduce does: mu[k, c] from the
// frame kernel's sample sums [K, n_groups, nch] (in group order, double
// for complex64 samples and exact integers for 8-bit ones, rounded once)
// and the new history from the last block's last halo rows.
//
// Three instances of one contract, one launch point and one plan type
// (fx_xstage.xstage_plan picks by shape; the plan's `rows` names the
// instance):
//
// * The row instance (fx_xstage_kernel<T, kRows>, rows 2, 4 or 8), below
//   fx_xstage.XSTAGE_TILED_NCH channels.  What bounds it is bytes:
//   bench.py's nchan8 block (8 channels, 256 frames of 4096 bins, 36 pairs
//   with autos) reads 64 MiB of spectra and writes 1.6 MiB of parts: 20 us
//   at 3.35 TB/s, against 0.34 GFLOP, 5 us at 67 TFLOP/s.  A CTA owns a
//   tile of bins of one block and every row of parts for it (grid (nbins /
//   tile, K)), so each spectrum byte crosses device memory once; thread t
//   sums bin t % tile of the rows slot, slot + slots, ... (slot = t /
//   tile), 2, 4 or 8 of them, in registers, its loads of 4 frames issued
//   before their adds and no branch on a row in the loop.  Each product
//   takes two 8-byte shared loads for a complex multiply-add's four
//   operations, so shared memory caps it near a quarter of the float32
//   rate; 576 threads of 8 rows hold 2,304 rows in one CTA
//   (fx_xstage.XSTAGE_ROW_CAPACITY).  It forms a pair's product as the
//   shared route (PartsOut and its reduce) does, so below the threshold the
//   two routes agree bit for bit wherever the compiler forms it alike.
//
// * The register-tiled instance (fx_xstage_kernel_tiled<T, kU>, rows 64),
//   from XSTAGE_TILED_NCH = 36 channels on (every count past 64 with
//   it).  What bounds it is float32 operations: MeerKAT's block (128
//   channels, 64 frames of 4096 bins, 8,256 pairs) is 17.3 GFLOP, 0.258 ms
//   at 67 TFLOP/s, against 268 MB of spectra and 279 MB of parts, 0.163 ms
//   at 3.35 TB/s.  The design is the classic correlator's register tile
//   (xGPU: Clark, La Plante and Greenhill 2011), kept on the CUDA cores,
//   where float32's 67 TFLOP/s is the ceiling, and on float32 products
//   throughout:
//     - the channels fall into groups of 8 (the last one padded with
//       zeros); thread t owns bin t % tile of one tile of pairs, a group gp
//       against a group gq, 8 x 8 products whose 128 sums stay in
//       registers over all S frames.  Each frame it loads the 16 values
//       once, as four 16-byte loads a group, and forms 64 complex
//       multiply-adds: 0.125 shared loads (0.25 values) a multiply-add,
//       against 2 in the row instance.  8 warps a CTA at most, two a
//       sub-partition, so a thread may take 255 registers;
//     - the tiles run through the triangle of groups by diagonals, gq =
//       (gp + d) mod ng, ng(ng + 1) / 2 of them; where ng is even and at
//       least 8 the half diagonal's ng / 2 tiles are cut into units of 2 x
//       2 pairs spread over every thread (the tail), so that MeerKAT's 16
//       groups fill 8 warps, not 8 and a half.  One CTA takes a tile of
//       bins, or two take it, half the tiles each (grid (nbins / tile, K,
//       split)), so each spectrum byte crosses device memory at most
//       twice, and at a tile of 4 bins each row's 32 bytes, a whole
//       sector, come from one CTA.  A warp's neighbouring slots take
//       neighbouring groups, whose runs in the ring (a bin's 8 channels at
//       a stride of kBinStride = 10 values) land on distinct banks at
//       every tile the plan takes;
//     - the ring of `stages` chunks is filled by 8-byte cp.async copies,
//       which put a bin's 8 channels of a group side by side;
//     - each output goes through the row map [np, np] int32 (np = nch
//       rounded up to whole groups; -1 where the pair list has no row;
//       fx_xstage.row_map, built once a pair list and kept with it), so
//       any list of distinct pairs works: a tile writes its product (p, q)
//       to row map[p][q] and its conjugate to row map[q][p]; a diagonal
//       tile (gp = gq) forms the mirrored products too and writes only p
//       <= q;
//     - T and GJ ride on every thread: nch x tile sums over the split, kU
//       (1 or 2, the instance) a thread with the tail's units, each one
//       more load a frame;
//     - each product is an FFMA chain, re = fma(p.re, q.re, re); re =
//       fma(p.im, q.im, re); im = fma(p.im, q.re, im); im = fma(-p.re,
//       q.im, im), summed in frame order: it rounds no worse than the row
//       instance's product-then-add, but not alike, so from the threshold
//       on the routes agree within the suite's tolerances, not bit for
//       bit.
//   No tensor cores: TF32 or a bf16 split would be a lower precision than
//   the float32 the configuration states.
//
// * The band instance (fx_xstage_kernel_bands<T>, rows kBandRows), past
//   fx_xstage.XSTAGE_TILED_MAX_NCH = 128 channels, where the triangle of
//   groups no longer fits 8 warps on two CTAs a bin tile.  LEDA's block
//   (512 channels, 64 frames of 4096 bins, 131,328 pairs) is 275 GFLOP, 4.1
//   ms at 67 TFLOP/s, against 1.07 GB of spectra and 4.3 GB of parts, 1.6
//   ms at 3.35 TB/s: float32 operations bound it.  Split the tiled
//   instance's way, each of the 16 to 32 CTAs a bin tile would need would
//   stage every channel (a frame of 512 channels is 160 KiB at 32 bins) and
//   read each spectrum byte once a CTA: 2 complex multiply-adds a byte
//   staged, where the tiled instance at 128 channels has 4.  Here the
//   channels fall into bands of kBand = 8 groups (64 channels) and a CTA
//   takes a pair of bands (P, Q), P <= Q, at a tile of 4 bins: its 64
//   tiles (gp, gq) = (8 P + i, 8 Q + j), one a slot, each thread one tile at
//   one bin with the tiled instance's loads and FFMA chains; where P = Q
//   the 36 tiles with i <= j (the rest of the slots sum and write nothing)
//   and the band's T and GJ sums, one a thread.  A CTA stages only its two
//   bands (16 groups, 5 KiB a frame at 4 bins), 4 multiply-adds a byte
//   staged, and each spectrum byte is read by the nb CTAs whose pair holds
//   its band (8 at 512 channels: fx_xstage.XStagePlan.reads).  The grid is
//   (band pairs, nbins / tile, K), the pairs fastest, so a bin tile's
//   CTAs run together and its re-reads come from L2.  A band past nch (the
//   last one ragged) has slots that own no tile; they sum like the others.

// Every instance streams the frames through a ring of `stages` buffers in
// shared memory, each `frames` frames of the CTA's channels (every channel
// but on the band instance) at the tile's bins, filled by cp.async `stages
// - 1` chunks ahead of the one being summed (the last chunk may be ragged
// and copies no frame past S).  The tile, slots,
// instance, frames a stage, stages and threads are planned in Python alone
// (fx_xstage.xstage_plan); here the plan is only checked against the shape
// and the instance's fixed limits.  A plan that does not fit, or shared
// memory the card refuses, is an error, never another kernel.  No atomics:
// every output element has one owner.  The fold of mu and of the new
// history is done once a bin tile (by its first CTA).

#include <cuda_runtime.h>

#include "fx_common.cuh"   // cadd, cmulconj, cp_async16, warp_block_mean

namespace {

// A row instance sums kRows = 2, 4 or 8 rows a thread (the plan's `rows`),
// every one of them on every frame, so the loop has no branch on a row,
// and takes at most RowThreads<kRows> threads a CTA (its
// __launch_bounds__, fx_xstage.XSTAGE_ROW_THREADS): 256 at 2 and 4 rows;
// 576 at 8, which cover 64 channels' 2,208 rows at a tile of 2 bins (552
// threads) and leave a thread 112 registers.
constexpr int kMaxRows = 8;
template <int kRows>
struct RowThreads {
  static constexpr int value = kRows < kMaxRows ? 256 : 576;
};
constexpr int kMaxStages = 8;

// The register-tiled instance: groups of kGroup channels, a thread's tile
// kGroup x kGroup pairs (the plan's `rows`, kTiledRows, names it), at most
// kTiledThreads threads a CTA (fx_xstage.XSTAGE_TILED_THREADS: 8 warps,
// two a sub-partition, so a thread may take 255 registers for its 128
// sums and 16 operands), kMaxTiledTile bins a tile, a bin's channels of a
// group kBinStride values apart in the ring, at most kMaxUnits tail units
// and T and GJ sums a thread.
constexpr int kGroup = 8;
constexpr int kTiledRows = kGroup * kGroup;
constexpr int kTiledThreads = 256;
constexpr int kMaxTiledTile = 32;
constexpr int kBinStride = kGroup + 2;
constexpr int kMaxUnits = 2;

// The band instance: bands of kBand groups, a CTA's kBandSlots tiles (a
// thread one tile at one bin), the plan's `rows` naming it (kBandRows).
constexpr int kBand = 8;
constexpr int kBandSlots = kBand * kBand;
constexpr int kBandRows = 2 * kTiledRows;

// The launch's shape (fx_xstage.XStagePlan): bins of a CTA's tile, slots
// (row slots: rows slot, slot + slots, ... a thread; tiled: tiles of
// pairs), rows a thread (the instance: 2, 4 or 8; kTiledRows), frames a
// stage of the ring, stages, threads a CTA (a multiple of 32, at least
// tile * slots).
struct XStagePlan {
  int tile, slots, rows, frames, stages, threads;
};

// What one launch reads and writes.  T is the sample type of the step it
// ends (float2: complex64 samples; char2: 8-bit ones).
template <typename T>
struct XStageArgs {
  const float2* spec;   // [K, nch, S, nbins] the frames' spectra
  const int* pairs;     // [nbl, 2]
  const float2* da;     // [halo, nbins] dA (dc_posthoc.dc_constants)
  float2* parts;        // [K, nbl + 2 nch, nbins]: xp_raw, T, GJ
  int nch, K, S, nbins, nbl, halo;
  // What the shared route's reduce forms, folded into the same launch; x
  // NULL: the X stage alone.  mu [K, nch] from the frame kernel's sample
  // sums (double2 or longlong2 [K, n_groups, nch]) and the new history
  // [nch, halo, nbins] from x [nch, K, S, nbins] (complex64: the last
  // block's last rows minus its mean; int8: those rows as they arrived).
  const T* x;
  const void* sums;
  float2* mu;
  T* new_hist;
  int n_groups;
  double step;
  XStagePlan plan;
};

// The tiled instance's arguments: a launch's, and the row map [np, np]
// (np = nch rounded up to whole groups) of a pair's row or -1.  Apart, so
// that the row instances' arguments stay as they were: one pointer more
// there cost the 8-row instance 5% at array8's K = 32 (an H100, 438 us ->
// 459 us a call).
template <typename T>
struct TiledArgs {
  XStageArgs<T> a;
  const int* rowmap;
};

// 8 bytes from device memory to shared memory, not through registers.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Whether this CTA, of bin tile bt, folds mu and the new history (`x`
// set): the first bin tile forms mu, the last block's tiles the history at
// their bins.
template <typename T>
__device__ __forceinline__ bool folds(const XStageArgs<T>& a, int k, int bt) {
  return a.x != nullptr && (bt == 0 || k == a.K - 1);
}

// The reduce's share, while the first chunks are in flight: block k's
// means into `means` [nch], a warp a channel.
template <typename T>
__device__ __forceinline__ void fold_means(const XStageArgs<T>& a, float2* means, int k) {
  using Pair = typename SumOf<T>::pair;
  const int warps = blockDim.x >> 5;
  for (int c = threadIdx.x >> 5; c < a.nch; c += warps) {
    const float2 m = warp_block_mean<T>(
        static_cast<const Pair*>(a.sums)
            + static_cast<size_t>(k) * a.n_groups * a.nch + c,
        a.n_groups, a.nch, static_cast<long long>(a.S) * a.nbins, a.step);
    if ((threadIdx.x & 31) == 0) means[c] = m;
  }
}

// mu from the first bin tile (bt 0) and the new history at this CTA's bins
// [b0, b0 + 2^lt) from the last block, once a barrier has made `means`
// visible.
template <typename T>
__device__ __forceinline__ void fold_out(const XStageArgs<T>& a, const float2* means, int k,
                         int b0, int lt, int bt) {
  constexpr bool kC64 = sizeof(T) == sizeof(float2);
  const int nch = a.nch, S = a.S, nbins = a.nbins, halo = a.halo;
  const int tile = 1 << lt;
  if (bt == 0) {
    for (int c = threadIdx.x; c < nch; c += blockDim.x) {
      a.mu[static_cast<size_t>(k) * nch + c] = means[c];
    }
  }
  if (k != a.K - 1) return;
  const long long n = static_cast<long long>(S) * nbins;
  for (int i = threadIdx.x; i < nch * halo * tile; i += blockDim.x) {
    const int b = i & (tile - 1);
    const int r = (i >> lt) % halo;
    const int c = (i >> lt) / halo;
    const T v = a.x[(static_cast<long long>(c) * a.K + k) * n
                    + static_cast<long long>(S - halo + r) * nbins + b0 + b];
    T* out = a.new_hist + (static_cast<size_t>(c) * halo + r) * nbins
             + b0 + b;
    if constexpr (kC64) {
      *out = csub(v, means[c]);
    } else {
      *out = v;
    }
  }
}

// ---- the row instance ---------------------------------------------------

// Chunk i (frames i << lf ..) of every channel of one block at a tile's
// bins into stage i % stages of the ring (`sk`: the block's spectra from
// the tile's first bin), 16 bytes (2 bins) a copy, by every thread of the
// CTA; one commit
// group a chunk, an empty one past the last, so that every thread counts
// the same groups.  The tile and the frames a stage are powers of two
// (2^lt, 2^lf), so a copy's place is shifts and masks.
__device__ __forceinline__ void stage_chunk(float2* ring, const float2* sk,
                                            int i, int n_chunks, int stages,
                                            int lf, int lt, int nch, int S,
                                            int nbins) {
  if (i < n_chunks) {
    float2* dst = ring + (i % stages) * (nch << (lf + lt));
    const int f0 = i << lf;
    const int nf = min(1 << lf, S - f0);
    const int lh = lt - 1;                  // 16-byte copies a frame's run
    const int units = nch << (lf + lh);
#pragma unroll 4
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int w = u & ((1 << lh) - 1);
      const int ff = (u >> lh) & ((1 << lf) - 1);
      const int c = u >> (lh + lf);
      if (ff < nf) {
        cp_async16(dst + (u << 1),
                   sk + (static_cast<size_t>(c) * S + f0 + ff) * nbins
                       + 2 * w);
      }
    }
  }
  cp_async_commit();
}

// kU frames f, f + 1, ... of a thread's rows at one bin (`at`: the first
// frame's element of the bin in the stage, a channel's run 2^lc elements):
// every row's loads of the kU frames issued before its adds, which run in
// frame order.  Pairs add spec_p conj(spec_q) (an auto pair's imaginary
// part is dropped at the end), T rows spec_c conj(1) = spec_c exactly; with
// kGj (one frame f < halo) the GJ rows add spec_c conj(dA[f]).  No branch
// on a row: every row loads and a row that does not add keeps its sum, so
// the compiler may overlap one row's loads with another's adds.
template <int kRows, int kU, bool kGj>
__device__ __forceinline__ void sum_frames(
    float2 (&acc)[kRows], const int (&chans)[kRows], int npair, int nt,
    int nrows, const float2* ring, int at, int tile, int lc, int f,
    const float2* __restrict__ da, int nbins, int bin) {
  const float2 one = make_float2(1.f, 0.f);
  float2 d = one;
  if constexpr (kGj) {
    d = __ldg(da + static_cast<size_t>(f) * nbins + bin);
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int pa = at + ((chans[j] & 255) << lc);
    const int pb = at + ((chans[j] >> 8) << lc);
    // rows j < npair: pairs; npair <= j < nt: T; nt <= j < nrows: GJ
    // (loads it does not need read channel 0: cheaper than predicating)
    const bool pair = j < npair, gj = kGj && j >= nt && j < nrows;
    const bool used = j < nt || gj;
    float2 vp[kU], vq[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      vp[u] = ring[pa + u * tile];
      vq[u] = ring[pb + u * tile];
      vq[u] = pair ? vq[u] : (gj ? d : one);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float2 sum = cadd(acc[j], cmulconj(vp[u], vq[u]));
      acc[j] = used ? sum : acc[j];
    }
  }
}

// Grid (nbins / tile, K), plan.threads threads; dynamic shared memory
// stages x nch x frames x tile float2 of the ring, then nch float2 of the
// block's means (with `x`).  A thread's rows run cross and auto pairs
// first, then T, then GJ (r = slot + j slots), so their kinds are the same
// across a row slot (a warp where the tile is 32 bins or more): the
// branches on them do not diverge.
template <typename T, int kRows>
__global__ void __launch_bounds__(RowThreads<kRows>::value, 1)
fx_xstage_kernel(const XStageArgs<T> a) {
  extern __shared__ __align__(16) float2 ring[];   // [stages][nch][frames][tile]
  const XStagePlan p = a.plan;
  const int tile = p.tile, stages = p.stages;
  const int nch = a.nch, S = a.S, nbins = a.nbins, halo = a.halo;
  const int lt = __ffs(tile) - 1, lf = __ffs(p.frames) - 1;
  const int l = threadIdx.x & (tile - 1);
  const int slot = threadIdx.x >> lt;
  const int k = blockIdx.y;
  const int b0 = blockIdx.x * tile;
  const int bin = b0 + l;
  const int rows = a.nbl + 2 * nch;
  const int lc = lf + lt;                  // a channel's run in a stage
  const int stage_len = nch << lc;
  const int n_chunks = (S + p.frames - 1) >> lf;
  float2* means = ring + stages * stage_len;       // [nch], with x

  // the thread's rows: j < npair pairs (autos among them), then T rows
  // up to nt, then GJ rows up to nrows; a row's channels ca | cb << 8
  int chans[kRows];
  unsigned autos = 0;
  int npair = 0, nt = 0, nrows = 0;
  float2 acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = slot + j * p.slots;
    int ca = 0, cb = 0;
    if (slot < p.slots && r < rows) {
      nrows = j + 1;
      if (r < a.nbl) {
        ca = __ldg(a.pairs + 2 * r);
        cb = __ldg(a.pairs + 2 * r + 1);
        autos |= static_cast<unsigned>(ca == cb) << j;
        npair = nt = j + 1;
      } else if (r < a.nbl + nch) {
        ca = r - a.nbl;
        nt = j + 1;
      } else {
        ca = r - a.nbl - nch;
      }
    }
    chans[j] = ca | cb << 8;
    acc[j] = make_float2(0.f, 0.f);
  }

  // launched by a step as a dependent of the wide frame kernel: the
  // spectra and sums are read only once it has completed; the epilogue may
  // then be scheduled behind this grid
  wait_for_predecessor();
  release_dependent();
  const float2* sk = a.spec + static_cast<size_t>(k) * nch * S * nbins + b0;
  for (int i = 0; i < stages - 1; ++i) {
    stage_chunk(ring, sk, i, n_chunks, stages, lf, lt, nch, S, nbins);
  }
  const bool fold = folds(a, k, blockIdx.x);
  if (fold) fold_means(a, means, k);

  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait_pending(stages - 2);   // chunk i has landed (this thread)
    __syncthreads();                     // ... for every thread, and chunk
                                         // i-1's stage is free
    stage_chunk(ring, sk, i + stages - 1, n_chunks, stages, lf, lt, nch, S,
                nbins);
    const int f0 = i << lf;
    const int nf = min(1 << lf, S - f0);
    const int at = (i % stages) * stage_len + l;
    constexpr int kAhead = 4;   // frames whose loads run ahead of the adds
    int ff = 0;
    if (f0 < halo) {      // the block's first halo frames: GJ rows too
      for (const int stop = min(nf, halo - f0); ff < stop; ++ff) {
        sum_frames<kRows, 1, true>(acc, chans, npair, nt, nrows, ring,
                                   at + ff * tile, tile, lc, f0 + ff, a.da,
                                   nbins, bin);
      }
    }
    for (; ff + kAhead <= nf; ff += kAhead) {
      sum_frames<kRows, kAhead, false>(acc, chans, npair, nt, nrows, ring,
                                       at + ff * tile, tile, lc, f0 + ff,
                                       a.da, nbins, bin);
    }
    for (; ff < nf; ++ff) {
      sum_frames<kRows, 1, false>(acc, chans, npair, nt, nrows, ring,
                                  at + ff * tile, tile, lc, f0 + ff, a.da,
                                  nbins, bin);
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (j < nrows) {
      const int r = slot + j * p.slots;
      // an auto pair's imaginary part is 0 (its sum of the products'
      // imaginary parts is only their roundings)
      a.parts[(static_cast<size_t>(k) * rows + r) * nbins + bin] =
          (autos >> j) & 1u ? make_float2(acc[j].x, 0.f) : acc[j];
    }
  }
  if (fold) fold_out(a, means, k, b0, lt, blockIdx.x);
}

// ---- the register-tiled instance ------------------------------------------

// Chunk i of every channel of one block at a tile's bins into stage i %
// stages of the ring, 8 bytes (one bin of one channel) a copy so that a
// bin's channels of a group land side by side: channel c, frame ff, bin b
// at ff frame_len + (c / 8) gs + b kBinStride + c % 8 (gs = tile
// kBinStride, a group's run).  One commit group a chunk, an empty one past
// the last.
__device__ __forceinline__ void stage_chunk_tiled(
    float2* ring, const float2* sk, int i, int n_chunks, int stages, int lf,
    int lt, int nch, int S, int nbins, int frame_len, int stage_len) {
  if (i < n_chunks) {
    float2* dst = ring + (i % stages) * stage_len;
    const int f0 = i << lf;
    const int nf = min(1 << lf, S - f0);
    const int gs = kBinStride << lt;
    const int units = nch << (lf + lt);
#pragma unroll 4
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int b = u & ((1 << lt) - 1);
      const int ff = (u >> lt) & ((1 << lf) - 1);
      const int c = u >> (lt + lf);
      if (ff < nf) {
        cp_async8(dst + ff * frame_len + (c / kGroup) * gs + b * kBinStride
                      + c % kGroup,
                  sk + (static_cast<size_t>(c) * S + f0 + ff) * nbins + b);
      }
    }
  }
  cp_async_commit();
}

// A thread's sums in the tiled instance: its tile's 8 x 8 products, kU
// tail units of 2 x 2 and kU T and GJ sums (a unit or sum past the CTA's
// share sums a valid place and is not written).
template <int kU>
struct TiledSums {
  float re[kGroup][kGroup], im[kGroup][kGroup];
  float ure[kU][4], uim[kU][4];
  float2 t[kU], gj[kU];
};

// What a thread reads of one frame: its groups' 8 values each (four
// 16-byte loads a group), each tail unit's two pairs of channels, each T
// sum's value, and dA at its bin (a frame f < halo).
template <int kU>
struct TiledOperands {
  float4 p[kGroup / 2], q[kGroup / 2], up[kU], uq[kU];
  float2 t[kU], dv;
};

// The thread's places in a frame of the ring: its tile's groups, its
// tail units' pairs and its T sums' channels (offsets at its bin).
template <int kU>
struct TiledPlaces {
  int op, oq, up[kU], uq[kU], ot[kU];
};

// (kTail false: the band instance, which has no tail units.)
template <int kU, bool kGj, bool kTail = true>
__device__ __forceinline__ void load_frame(TiledOperands<kU>& o,
                                           const float2* fr,
                                           const TiledPlaces<kU>& w,
                                           const float2* da_f) {
#pragma unroll
  for (int h = 0; h < kGroup / 2; ++h) {
    o.p[h] = reinterpret_cast<const float4*>(fr + w.op)[h];
    o.q[h] = reinterpret_cast<const float4*>(fr + w.oq)[h];
  }
#pragma unroll
  for (int m = 0; m < kU; ++m) {
    if constexpr (kTail) {
      o.up[m] = *reinterpret_cast<const float4*>(fr + w.up[m]);
      o.uq[m] = *reinterpret_cast<const float4*>(fr + w.uq[m]);
    }
    o.t[m] = fr[w.ot[m]];
  }
  if constexpr (kGj) o.dv = __ldg(da_f);
}

// acc += a conj(b) as an FFMA chain: re = fma(a.re, b.re, re); re =
// fma(a.im, b.im, re); im = fma(a.im, b.re, im); im = fma(-a.re, b.im, im).
__device__ __forceinline__ void cmac(float& re, float& im, float ar, float ai,
                                     float br, float bi) {
  re = fmaf(ar, br, re);
  re = fmaf(ai, bi, re);
  im = fmaf(ai, br, im);
  im = fmaf(-ar, bi, im);
}

// One frame's operands into a thread's sums: 64 products of the tile, 4 a
// tail unit (kTail), each T sum and, with kGj (a frame f < halo), its GJ
// sum.
template <int kU, bool kGj, bool kTail = true>
__device__ __forceinline__ void sum_frame(TiledSums<kU>& s,
                                          const TiledOperands<kU>& o) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float qr = j & 1 ? o.q[j >> 1].z : o.q[j >> 1].x;
    const float qi = j & 1 ? o.q[j >> 1].w : o.q[j >> 1].y;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float pr = i & 1 ? o.p[i >> 1].z : o.p[i >> 1].x;
      const float pi = i & 1 ? o.p[i >> 1].w : o.p[i >> 1].y;
      cmac(s.re[i][j], s.im[i][j], pr, pi, qr, qi);
    }
  }
#pragma unroll
  for (int m = 0; m < kU; ++m) {
    if constexpr (kTail) {
      const float4 a = o.up[m], b = o.uq[m];
      cmac(s.ure[m][0], s.uim[m][0], a.x, a.y, b.x, b.y);
      cmac(s.ure[m][1], s.uim[m][1], a.x, a.y, b.z, b.w);
      cmac(s.ure[m][2], s.uim[m][2], a.z, a.w, b.x, b.y);
      cmac(s.ure[m][3], s.uim[m][3], a.z, a.w, b.z, b.w);
    }
    s.t[m] = cadd(s.t[m], o.t[m]);
    if constexpr (kGj) {
      cmac(s.gj[m].x, s.gj[m].y, o.t[m].x, o.t[m].y, o.dv.x, o.dv.y);
    }
  }
}

// Product (pc, qc) summed as re + i im to row r as it is (imaginary part
// 0 where pc = qc) and to row rm conjugated; -1: no row.
__device__ __forceinline__ void put_pair(float2* out, int nbins, int r,
                                         int rm, bool autos, float re,
                                         float im) {
  if (r >= 0) {
    out[static_cast<size_t>(r) * nbins] = make_float2(re, autos ? 0.f : im);
  }
  if (rm >= 0) out[static_cast<size_t>(rm) * nbins] = make_float2(re, -im);
}

// A thread's tile (gp, gq) at its bin, d = gq - gp groups apart (0: a
// diagonal tile, whose mirrored products are its own): the rows of (gp 8 +
// i, gq 8 + j) as formed and of (gq 8 + j, gp 8 + i) conjugated, through
// the row map's runs of 8, two 16-byte loads each; a diagonal tile writes
// only p <= q.
template <int kU>
__device__ __forceinline__ void put_tile(float2* out, int nbins,
                                         const int* __restrict__ rowmap,
                                         int np, int gp, int gq, int d,
                                         const TiledSums<kU>& s) {
  int r[kGroup][kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const int4* run = reinterpret_cast<const int4*>(
        rowmap + (gp * kGroup + i) * np + gq * kGroup);
    const int4 lo = __ldg(run), hi = __ldg(run + 1);
    r[i][0] = lo.x; r[i][1] = lo.y; r[i][2] = lo.z; r[i][3] = lo.w;
    r[i][4] = hi.x; r[i][5] = hi.y; r[i][6] = hi.z; r[i][7] = hi.w;
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (d > 0 || i <= j) {
        put_pair(out, nbins, r[i][j], -1, d == 0 && i == j, s.re[i][j],
                 s.im[i][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const int4* run = reinterpret_cast<const int4*>(
        rowmap + (gq * kGroup + j) * np + gp * kGroup);
    const int4 lo = __ldg(run), hi = __ldg(run + 1);
    const int rm[kGroup] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (d > 0 || i < j) {
        put_pair(out, nbins, -1, rm[i], false, s.re[i][j], s.im[i][j]);
      }
    }
  }
}

// Grid (nbins / tile, K, split), plan.threads threads; dynamic shared
// memory stages x frames x ng groups x tile x kBinStride float2 of the
// ring, then nch float2 of the block's means (with `x`).  The tiles of
// the triangle of ng groups on slots: tile s holds gp = s mod ng against
// gq = (gp + s / ng) mod ng, all ng (ng + 1) / 2 of them, or, where ng is
// even and at least 8, the ng / 2 whole diagonals' ng^2 / 2, the half
// diagonal's ng / 2 tiles (gp, gp + ng / 2) going to the tail: 16 units
// of 2 x 2 pairs a tile and bin, spread over every thread.  `split` = 1
// or 2 CTAs share a bin tile: CTA z takes tiles z slots .. (z + 1) slots -
// 1 (a thread the one t / tile at bin t % tile; threads past them sum like
// the others and write nothing) and the z-th share of the tail's units and
// of the T and GJ sums (channels z cs .. (z + 1) cs - 1, cs = ceil(nch /
// split), at every bin), kU of each at most a thread.  With split 1 and
// tile 2, MeerKAT's 128 channels fill 8 warps (a ninth would leave one
// sub-partition three warps to the others' two, and a thread 168
// registers); split 2 at a tile of 4 bins writes each row's 32 bytes, a
// whole sector, where a tile of 2 writes half of one.
template <typename T, int kU>
__global__ void __launch_bounds__(kTiledThreads, 1)
fx_xstage_kernel_tiled(const __grid_constant__ TiledArgs<T> args) {
  extern __shared__ __align__(16) float2 ring[];
  const XStageArgs<T>& a = args.a;
  const int* __restrict__ rowmap = args.rowmap;
  const XStagePlan p = a.plan;
  const int tile = p.tile, stages = p.stages;
  const int nch = a.nch, S = a.S, nbins = a.nbins, halo = a.halo;
  const int lt = __ffs(tile) - 1, lf = __ffs(p.frames) - 1;
  const int ng = (nch + kGroup - 1) / kGroup;
  const int np = ng * kGroup;                      // the row map's side
  const int gs = kBinStride << lt;
  const int frame_len = ng * gs;
  const int stage_len = frame_len << lf;
  const int l = threadIdx.x & (tile - 1);
  const int z = blockIdx.z, split = gridDim.z;
  const int k = blockIdx.y;
  const int b0 = blockIdx.x * tile;
  const int bin = b0 + l;
  const int n_chunks = (S + p.frames - 1) >> lf;
  float2* means = ring + stages * stage_len;       // [nch], with x

  // the thread's tile
  const bool own = (threadIdx.x >> lt) < p.slots;
  const int slot = own ? (threadIdx.x >> lt) + z * p.slots : 0;
  const int d = slot / ng;
  const int gp = slot - d * ng;
  const int gq = (gp + d) % ng;
  TiledPlaces<kU> w;
  w.op = gp * gs + l * kBinStride;
  w.oq = gq * gs + l * kBinStride;
  // the tail's units of this CTA: unit u -> tile tt = (u / tile) mod half,
  // sub-tile (u / tile) / half = 0 .. 15, channels 2 (sub mod 4) .. of gp
  // = tt against 2 (sub / 4) .. of gq = tt + half
  const int half = ng >> 1;
  const int units = p.slots * split * 2 < ng * (ng + 1)
                        ? ((half * 16) << lt) / split : 0;
  // the T and GJ sums of this CTA: channel z cs + (t + m threads) / tile
  const int cs = (nch + split - 1) / split;
  const int c_end = min(nch, (z + 1) * cs);
#pragma unroll
  for (int m = 0; m < kU; ++m) {
    const int v = threadIdx.x + m * blockDim.x;
    const int rest = (v < units ? z * units + v : 0) >> lt;
    const int tt = rest % max(half, 1), sub = rest / max(half, 1);
    w.up[m] = tt * gs + l * kBinStride + 2 * (sub & 3);
    w.uq[m] = (tt + half) * gs + l * kBinStride + 2 * (sub >> 2);
    const int c = z * cs + (v >> lt);
    w.ot[m] = c < c_end ? (c / kGroup) * gs + l * kBinStride + c % kGroup
                        : 0;
  }

  // the last group's channels past nch read 0 in every stage (no copy
  // writes them)
  const int pad = np - nch;
  for (int u = threadIdx.x; u < (stages << (lf + lt)) * pad;
       u += blockDim.x) {
    const int b = u & (tile - 1);
    const int c = nch + (u >> lt) % pad;
    const int fr = (u >> lt) / pad;
    ring[fr * frame_len + (c / kGroup) * gs + b * kBinStride + c % kGroup] =
        make_float2(0.f, 0.f);
  }

  wait_for_predecessor();
  release_dependent();
  const float2* sk = a.spec + static_cast<size_t>(k) * nch * S * nbins + b0;
  for (int i = 0; i < stages - 1; ++i) {
    stage_chunk_tiled(ring, sk, i, n_chunks, stages, lf, lt, nch, S, nbins,
                      frame_len, stage_len);
  }
  const bool fold = z == 0 && folds(a, k, blockIdx.x);
  if (fold) fold_means(a, means, k);

  TiledSums<kU> s;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) s.re[i][j] = s.im[i][j] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < kU; ++m) {
#pragma unroll
    for (int u = 0; u < 4; ++u) s.ure[m][u] = s.uim[m][u] = 0.f;
    s.t[m] = s.gj[m] = make_float2(0.f, 0.f);
  }
  const float2* da = a.da + bin;
  for (int i = 0, at = 0; i < n_chunks; ++i) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    stage_chunk_tiled(ring, sk, i + stages - 1, n_chunks, stages, lf, lt,
                      nch, S, nbins, frame_len, stage_len);
    const int f0 = i << lf;
    const int nf = min(1 << lf, S - f0);
    const float2* fr = ring + at * stage_len;
    at = at + 1 == stages ? 0 : at + 1;
    TiledOperands<kU> o;
    int ff = 0;
    for (const int stop = min(nf, halo - f0); ff < stop; ++ff) {
      load_frame<kU, true>(o, fr + ff * frame_len, w,
                           da + static_cast<size_t>(f0 + ff) * nbins);
      sum_frame<kU, true>(s, o);
    }
    for (; ff < nf; ++ff) {
      load_frame<kU, false>(o, fr + ff * frame_len, w, da);
      sum_frame<kU, false>(s, o);
    }
  }

  const size_t rows = static_cast<size_t>(a.nbl) + 2 * nch;
  float2* out = a.parts + static_cast<size_t>(k) * rows * nbins + bin;
  if (own) put_tile(out, nbins, rowmap, np, gp, gq, d, s);
#pragma unroll
  for (int m = 0; m < kU; ++m) {
    const int v = threadIdx.x + m * blockDim.x;
    if (v < units) {
      const int rest = (z * units + v) >> lt;
      const int tt = rest % half, sub = rest / half;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pc = tt * kGroup + 2 * (sub & 3) + (u >> 1);
        const int qc = (tt + half) * kGroup + 2 * (sub >> 2) + (u & 1);
        put_pair(out, nbins, __ldg(rowmap + pc * np + qc),
                 __ldg(rowmap + qc * np + pc), false, s.ure[m][u],
                 s.uim[m][u]);
      }
    }
    const int c = z * cs + (v >> lt);
    if (c < c_end) {
      out[(static_cast<size_t>(a.nbl) + c) * nbins] = s.t[m];
      out[(static_cast<size_t>(a.nbl) + nch + c) * nbins] = s.gj[m];
    }
  }
  if (fold) fold_out(a, means, k, b0, lt, blockIdx.x);
}


// ---- the band instance ------------------------------------------------------

// Chunk i of a band pair's channels (P's ncp from c0p, then Q's ncq from
// c0q; ncq 0 where P = Q) at a tile's bins into stage i % stages of the
// ring, 8 bytes a copy as stage_chunk_tiled puts them: a frame holds P's
// kBand groups, then Q's, each group tile x kBinStride values.  One commit
// group a chunk, an empty one past the last.
__device__ __forceinline__ void stage_chunk_bands(
    float2* ring, const float2* sk, int i, int n_chunks, int stages, int lf,
    int lt, int c0p, int ncp, int c0q, int ncq, int S, int nbins,
    int frame_len, int stage_len) {
  if (i < n_chunks) {
    float2* dst = ring + (i % stages) * stage_len;
    const int f0 = i << lf;
    const int nf = min(1 << lf, S - f0);
    const int gs = kBinStride << lt;
    const int units = (ncp + ncq) << (lf + lt);
#pragma unroll 4
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int b = u & ((1 << lt) - 1);
      const int ff = (u >> lt) & ((1 << lf) - 1);
      const int cc = u >> (lt + lf);
      const bool q = cc >= ncp;
      const int c = q ? c0q + cc - ncp : c0p + cc;
      const int place = q ? kBand * kGroup + cc - ncp : cc;
      if (ff < nf) {
        cp_async8(dst + ff * frame_len + (place / kGroup) * gs
                      + b * kBinStride + place % kGroup,
                  sk + (static_cast<size_t>(c) * S + f0 + ff) * nbins + b);
      }
    }
  }
  cp_async_commit();
}

// Grid (nb (nb + 1) / 2 band pairs, nbins / tile, K), plan.threads = tile
// kBandSlots threads; dynamic shared memory stages x frames x 2 kBand groups
// x tile x kBinStride float2 of the ring, then nch float2 of the block's
// means (with `x`).  Band pair z is (P, Q), P <= Q, row by row of the
// triangle of the nb = ceil(ng / kBand) bands.  Thread t sums slot s = t /
// tile, tile (gp, gq) = (kBand P + s / kBand, kBand Q + s % kBand) at bin
// t % tile, owned where both groups exist and, where P = Q, s / kBand <= s
// % kBand; where P = Q it also sums T and GJ of the band's channel t /
// tile.  The first band pair (0, 0) folds mu and the history.
template <typename T>
__global__ void __launch_bounds__(kTiledThreads, 1)
fx_xstage_kernel_bands(const __grid_constant__ TiledArgs<T> args) {
  extern __shared__ __align__(16) float2 ring[];
  const XStageArgs<T>& a = args.a;
  const int* __restrict__ rowmap = args.rowmap;
  const XStagePlan p = a.plan;
  const int tile = p.tile, stages = p.stages;
  const int nch = a.nch, S = a.S, nbins = a.nbins, halo = a.halo;
  const int lt = __ffs(tile) - 1, lf = __ffs(p.frames) - 1;
  const int ng = (nch + kGroup - 1) / kGroup;
  const int np = ng * kGroup;                      // the row map's side
  const int nb = (ng + kBand - 1) / kBand;
  const int gs = kBinStride << lt;
  const int frame_len = 2 * kBand * gs;
  const int stage_len = frame_len << lf;
  const int l = threadIdx.x & (tile - 1);
  int bp = 0, bq = blockIdx.x;
  while (bq >= nb - bp) {
    bq -= nb - bp;
    ++bp;
  }
  bq += bp;
  const bool diag = bp == bq;
  const int bt = blockIdx.y;
  const int k = blockIdx.z;
  const int b0 = bt * tile;
  const int bin = b0 + l;
  const int n_chunks = (S + p.frames - 1) >> lf;
  float2* means = ring + stages * stage_len;       // [nch], with x
  const int c0p = bp * kBand * kGroup, c0q = bq * kBand * kGroup;
  const int ncp = min(kBand * kGroup, nch - c0p);
  const int ncq = diag ? 0 : min(kBand * kGroup, nch - c0q);

  // the thread's tile, and its T and GJ channel where P = Q
  const int slot = threadIdx.x >> lt;
  const int ti = slot / kBand, tj = slot % kBand;
  const int gp = bp * kBand + ti, gq = bq * kBand + tj;
  const bool own = gp < ng && gq < ng && (!diag || ti <= tj);
  TiledPlaces<1> w;
  w.op = (own ? ti * gs : 0) + l * kBinStride;
  w.oq = (own ? ((diag ? 0 : kBand) + tj) * gs : 0) + l * kBinStride;
  const bool sums = diag && slot < ncp;
  w.ot[0] = sums ? (slot / kGroup) * gs + l * kBinStride + slot % kGroup
                 : 0;

  // the last group's channels past nch read 0 in every stage (no copy
  // writes them): in P's half where P is the last band, else in Q's
  const int pad = np - nch;
  const int last = (ng - 1) - (nb - 1) * kBand;    // its group in its band
  const int half = bp == nb - 1 ? 0 : (bq == nb - 1 ? kBand : -1);
  if (half >= 0) {
    for (int u = threadIdx.x; u < (stages << (lf + lt)) * pad;
         u += blockDim.x) {
      const int b = u & (tile - 1);
      const int c = kGroup - pad + (u >> lt) % pad;
      const int fr = (u >> lt) / pad;
      ring[fr * frame_len + (half + last) * gs + b * kBinStride + c] =
          make_float2(0.f, 0.f);
    }
  }

  wait_for_predecessor();
  release_dependent();
  const float2* sk = a.spec + static_cast<size_t>(k) * nch * S * nbins + b0;
  for (int i = 0; i < stages - 1; ++i) {
    stage_chunk_bands(ring, sk, i, n_chunks, stages, lf, lt, c0p, ncp, c0q,
                      ncq, S, nbins, frame_len, stage_len);
  }
  const bool fold = blockIdx.x == 0 && folds(a, k, bt);
  if (fold) fold_means(a, means, k);

  TiledSums<1> s;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) s.re[i][j] = s.im[i][j] = 0.f;
  }
  s.t[0] = s.gj[0] = make_float2(0.f, 0.f);
  const float2* da = a.da + bin;
  for (int i = 0, at = 0; i < n_chunks; ++i) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    stage_chunk_bands(ring, sk, i + stages - 1, n_chunks, stages, lf, lt,
                      c0p, ncp, c0q, ncq, S, nbins, frame_len, stage_len);
    const int f0 = i << lf;
    const int nf = min(1 << lf, S - f0);
    const float2* fr = ring + at * stage_len;
    at = at + 1 == stages ? 0 : at + 1;
    TiledOperands<1> o;
    int ff = 0;
    for (const int stop = min(nf, halo - f0); ff < stop; ++ff) {
      load_frame<1, true, false>(o, fr + ff * frame_len, w,
                                 da + static_cast<size_t>(f0 + ff) * nbins);
      sum_frame<1, true, false>(s, o);
    }
    for (; ff < nf; ++ff) {
      load_frame<1, false, false>(o, fr + ff * frame_len, w, da);
      sum_frame<1, false, false>(s, o);
    }
  }

  const size_t rows = static_cast<size_t>(a.nbl) + 2 * nch;
  float2* out = a.parts + static_cast<size_t>(k) * rows * nbins + bin;
  if (own) put_tile(out, nbins, rowmap, np, gp, gq, gq - gp, s);
  if (sums) {
    const int c = c0p + slot;
    out[(static_cast<size_t>(a.nbl) + c) * nbins] = s.t[0];
    out[(static_cast<size_t>(a.nbl) + nch + c) * nbins] = s.gj[0];
  }
  if (fold) fold_out(a, means, k, b0, lt, bt);
}

// ---- launchers ------------------------------------------------------------

// A kernel instance on `st` (with `dependent`, a programmatic dependent
// of the kernel before it) over a grid (x, y, z) of `threads` threads,
// given its argument and dynamic shared memory.
template <typename Args>
cudaError_t launch_instance(void (*kernel)(Args), const Args& args, int x,
                            int y, int z, int threads, size_t smem,
                            bool dependent, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return launch_kernel(kernel, dim3(x, y, z), dim3(threads), smem, st,
                       dependent, args);
}

// A row instance: its slots of `rows` rows hold every row, and it takes
// the threads.
template <typename T, int kRows>
cudaError_t launch_rows(const XStageArgs<T>& a, bool dependent,
                        cudaStream_t st) {
  const XStagePlan& p = a.plan;
  const long long rows = static_cast<long long>(a.nbl) + 2 * a.nch;
  if (a.nch > 255 || p.threads > RowThreads<kRows>::value
      || static_cast<long long>(p.slots) * kRows < rows) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = (static_cast<size_t>(p.stages) * a.nch * p.frames
                          * p.tile + a.nch) * sizeof(float2);
  return launch_instance(&fx_xstage_kernel<T, kRows>, a, a.nbins / p.tile,
                         a.K, 1, p.threads, smem, dependent, st);
}

// The tiled instance: `split` = 1 or 2 CTAs a bin tile share the tiles
// of the triangle of groups on their slots (all ng (ng + 1) / 2, or the
// whole diagonals' ng^2 / 2 where ng is even and at least 8, the half
// diagonal in the tail), the tail's units and the T and GJ sums, kU of
// each at most a thread (the instance), with a row map wherever there are
// pairs.
template <typename T>
cudaError_t launch_tiled(const XStageArgs<T>& a, const int* rowmap,
                         bool dependent, cudaStream_t st) {
  const XStagePlan& p = a.plan;
  const int ng = (a.nch + kGroup - 1) / kGroup;
  const bool halves = ng % 2 == 0 && ng >= 8;
  const int tiles = halves ? ng * ng / 2 : ng * (ng + 1) / 2;
  const int split = tiles / p.slots;
  const int units = halves ? ng / 2 * 16 * p.tile / split : 0;
  const int sums = (a.nch + split - 1) / split * p.tile;
  const int need = (max(units, sums) + p.threads - 1) / p.threads;
  if (a.nch > 255 || p.tile > kMaxTiledTile || split < 1 || split > 2
      || split * p.slots != tiles || p.threads > kTiledThreads
      || need > kMaxUnits || (a.nbl > 0 && rowmap == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = (static_cast<size_t>(p.stages) * p.frames * ng
                          * p.tile * kBinStride + a.nch) * sizeof(float2);
  auto* kernel = need == 1 ? &fx_xstage_kernel_tiled<T, 1>
                           : &fx_xstage_kernel_tiled<T, 2>;
  return launch_instance(kernel, TiledArgs<T>{a, rowmap}, a.nbins / p.tile,
                         a.K, split, p.threads, smem, dependent, st);
}

// The band instance: a CTA each of the nb (nb + 1) / 2 pairs of bands at
// each bin tile, kBandSlots tiles of tile (2 or 4) bins over as many
// threads, the band's T and GJ sums one a thread, with a row map wherever
// there are pairs.
template <typename T>
cudaError_t launch_bands(const XStageArgs<T>& a, const int* rowmap,
                         bool dependent, cudaStream_t st) {
  const XStagePlan& p = a.plan;
  const int ng = (a.nch + kGroup - 1) / kGroup;
  const int nb = (ng + kBand - 1) / kBand;
  if (p.tile > 4 || p.slots != kBandSlots
      || p.threads != p.tile * kBandSlots || a.nbins / p.tile > 65535
      || (a.nbl > 0 && rowmap == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = (static_cast<size_t>(p.stages) * p.frames * 2 * kBand
                          * p.tile * kBinStride + a.nch) * sizeof(float2);
  return launch_instance(&fx_xstage_kernel_bands<T>, TiledArgs<T>{a, rowmap},
                         nb * (nb + 1) / 2, a.nbins / p.tile, a.K,
                         p.threads, smem, dependent, st);
}

// The plan is checked against the shape: it must cover every bin and
// frame, and its instance every row (one CTA a bin tile).
template <typename T>
cudaError_t launch_xstage(const XStageArgs<T>& a, const int* rowmap,
                          bool dependent, cudaStream_t st) {
  const XStagePlan& p = a.plan;
  if (a.K < 1 || a.K > 65535 || a.S < 1 || a.nch < 1 || a.nbl < 0 || a.halo < 0 || a.halo > a.S || p.tile < 2
      || (p.tile & (p.tile - 1)) != 0 || a.nbins % p.tile != 0
      || p.frames < 1 || (p.frames & (p.frames - 1)) != 0 || p.slots < 1
      || p.rows < 1 || p.threads % 32 != 0 || p.threads < p.tile * p.slots
      || p.stages < 2 || p.stages > kMaxStages) {
    return cudaErrorInvalidValue;
  }
  switch (p.rows) {
    case 2: return launch_rows<T, 2>(a, dependent, st);
    case 4: return launch_rows<T, 4>(a, dependent, st);
    case 8: return launch_rows<T, 8>(a, dependent, st);
    case kTiledRows: return launch_tiled<T>(a, rowmap, dependent, st);
    case kBandRows: return launch_bands<T>(a, rowmap, dependent, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace fxt {

int xstage(bool int8, const void* spec, const void* pairs, const void* rowmap,
           const void* da, void* parts, const void* x, const void* sums,
           void* mu, void* new_hist, int nch, int K, int S, int nbins,
           int nbl, int halo, int n_groups, int tile, int slots, int rows,
           int frames, int stages, int threads, double step, bool dependent,
           cudaStream_t st) {
  const XStagePlan plan{tile, slots, rows, frames, stages, threads};
  if (int8) {
    const XStageArgs<char2> a{static_cast<const float2*>(spec),
                              static_cast<const int*>(pairs),
                              static_cast<const float2*>(da),
                              static_cast<float2*>(parts),
                              nch, K, S, nbins, nbl, halo,
                              static_cast<const char2*>(x), sums,
                              static_cast<float2*>(mu),
                              static_cast<char2*>(new_hist), n_groups, step,
                              plan};
    return static_cast<int>(
        launch_xstage(a, static_cast<const int*>(rowmap), dependent, st));
  }
  const XStageArgs<float2> a{static_cast<const float2*>(spec),
                             static_cast<const int*>(pairs),
                             static_cast<const float2*>(da),
                             static_cast<float2*>(parts),
                             nch, K, S, nbins, nbl, halo,
                             static_cast<const float2*>(x), sums,
                             static_cast<float2*>(mu),
                             static_cast<float2*>(new_hist), n_groups, 1.0,
                             plan};
  return static_cast<int>(
      launch_xstage(a, static_cast<const int*>(rowmap), dependent, st));
}

}  // namespace fxt

// The X stage on `stream` (fx_xstage.py): spec complex64 [K, nch, S, nbins],
// pairs int32 [nbl, 2], rowmap int32 [np, np] (fx_xstage.row_map: pair
// (p, q)'s row or -1; read by the tiled and band instances, NULL allowed
// for the row instances), da complex64 [halo, nbins] (halo <= S); writes parts [K,
// nbl + 2 nch, nbins].  With x NULL that is all (fx_xstage alone; sums,
// mu, new_hist and n_groups unused).  Else it ends the wide route's step
// after fxt_fx_wide_frames: x complex64 [nch, K, S, nbins] and the frame
// kernel's sums double2 [K, n_groups, nch] give mu [K, nch] and the new
// history [nch, halo, nbins].  tile, slots, rows, frames, stages and
// threads are the launch's plan (fx_xstage.xstage_plan), checked here
// against the shape (an invalid plan returns cudaErrorInvalidValue).  The
// caller has checked shapes, types and contiguity.  Returns
// cudaGetLastError().
extern "C" int fxt_xstage(const void* spec, const void* pairs,
                          const void* rowmap, const void* da, void* parts,
                          const void* x, const void* sums, void* mu,
                          void* new_hist, int nch, int K, int S, int nbins,
                          int nbl, int halo, int n_groups, int tile,
                          int slots, int rows, int frames, int stages,
                          int threads, void* stream) {
  return fxt::xstage(false, spec, pairs, rowmap, da, parts, x, sums, mu,
                     new_hist, nch, K, S, nbins, nbl, halo, n_groups, tile,
                     slots, rows, frames, stages, threads, 1.0, false,
                     static_cast<cudaStream_t>(stream));
}

// The X stage after fxt_fx_wide_frames_i8: fxt_xstage's contract with x
// int8 [nch, K, S, nbins, 2], sums longlong2 (exact integer sums), mu in
// real units (times `step`) and the new tail the last rows as they arrived.
extern "C" int fxt_xstage_i8(const void* spec, const void* pairs,
                             const void* rowmap, const void* da, void* parts,
                             const void* x, const void* sums, void* mu,
                             void* new_tail, int nch, int K, int S,
                             int nbins, int nbl, int halo, int n_groups,
                             int tile, int slots, int rows, int frames,
                             int stages, int threads, double step,
                             void* stream) {
  return fxt::xstage(true, spec, pairs, rowmap, da, parts, x, sums, mu,
                     new_tail, nch, K, S, nbins, nbl, halo, n_groups, tile,
                     slots, rows, frames, stages, threads, step, false,
                     static_cast<cudaStream_t>(stream));
}

// The plan's integers fxt_xstage and fxt_xstage_i8 take, in
// fx_xstage.XStagePlan.args()'s order, and the pointers before them (a
// tool that drives two builds of this file asks each how to call it; a
// build without fxt_xstage_pointers takes 8, no row map).
extern "C" int fxt_xstage_plan_ints(void) { return 6; }
extern "C" int fxt_xstage_pointers(void) { return 9; }
