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
// route goes on to fx_fused.MAX_WIDE_NCHAN = 128 channels (MeerKAT's 64
// dual-polarisation dishes: 8,256 pairs with autos), whose rows one CTA
// cannot hold: they are split over a third grid axis (below).
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
// each summed in frame order, f = 0 first, in float32: the order in which
// the shared-memory route (PartsOut and its reduce) sums them when a CTA
// holds one frame, and with the same complex product, so the two routes
// agree there bit for bit wherever the compiler forms the product alike.
// With `x` set the launch also does what that route's reduce does: mu[k, c]
// from the frame kernel's sample sums [K, n_groups, nch] (in group order,
// double for complex64 samples and exact integers for 8-bit ones, rounded
// once) and the new history from the last block's last halo rows.
//
// What bounds it on the H100: its bytes.  bench.py's nchan8 block (8
// channels, 256 frames of 4096 bins, 36 pairs with autos) reads 64 MiB of
// spectra and writes 1.6 MiB of parts: 20 us at 3.35 TB/s, against 0.34
// GFLOP, 5 us at 67 TFLOP/s; per frame and bin it does about 4 nch^2
// operations for 8 nch bytes, under float32's 20 operations a byte until
// nch ~ 40, so the tensor cores would pay only above that (not taken here).
// Design, for the copies:
//   * a CTA owns a tile of bins of one block and a tile of rows of parts
//     for it (grid (nbins / tile, K, row tiles)); up to 64 channels one
//     row tile holds every row (the grid's third axis is 1), so each
//     spectrum byte crosses device memory once a launch.  Past what 576
//     threads of 8 rows hold (2,304 rows at a tile of 2 bins: 66
//     channels with autos and more), the rows are cut into the fewest
//     tiles of near-equal size, each CTA staging every channel's spectra
//     at its bins: a spectrum byte crosses device memory once a row tile
//     (4 at 128 channels: 1.07 GB a 2^18 block, 0.32 ms at 3.35 TB/s,
//     against the products' 17.3 GFLOP, 0.26 ms at 67 TFLOP/s).  The
//     rows' order, and so each row's sums, do not depend on the tiling;
//   * the frames stream through a ring of `stages` buffers in shared
//     memory, each `frames` frames of every channel at the tile's bins,
//     filled by 16-byte cp.async copies `stages - 1` chunks ahead of the
//     one being summed (no synchronous staging loop; the last chunk may be
//     ragged and copies no frame past S);
//   * thread t sums bin t % tile of the rows slot, slot + slots, ... (slot
//     = t / tile), 2, 4 or 8 of them, in registers, its loads of 4 frames
//     issued before their adds and no branch on a row in the loop; 256
//     threads a CTA, two CTAs an SM (576 at 8 rows a thread, where 64
//     channels' 2,208 rows need them, at a tile of 2 bins);
//   * the tile, the slots, the rows a thread (the kernel instance), the
//     frames a stage and the stages are planned in Python alone
//     (fx_xstage.xstage_plan: the grid near 128 CTAs or more, the ring
//     within 96 KiB); here the plan is only checked against the shape and
//     the instance's fixed limits; the row tiles are the fewest that the
//     plan's slots of `rows` rows cover (ceil(rows / (slots x rows))).  A
//     plan that does not fit, or shared memory the card refuses, is an
//     error, never another kernel.
// No atomics: every output element has one owner.  The fold of mu and of
// the new history is done once a bin tile, by row tile 0.

#include <cuda_runtime.h>

#include "fx_common.cuh"   // cadd, cmulconj, cp_async16, warp_block_mean

namespace {

// A kernel instance sums kRows = 2, 4 or 8 rows a thread (the plan's
// `rows`), every one of them on every frame, so the loop has no branch on
// a row, and takes at most RowThreads<kRows> threads a CTA (its
// __launch_bounds__, fx_xstage.XSTAGE_ROW_THREADS): 256 at 2 and 4 rows;
// 576 at 8, which cover 64 channels' 2,208 rows at a tile of 2 bins (552
// threads) and leave a thread 112 registers.
constexpr int kMaxRows = 8;
template <int kRows>
struct RowThreads {
  static constexpr int value = kRows < kMaxRows ? 256 : 576;
};
constexpr int kMaxStages = 8;


// The launch's shape (fx_xstage.XStagePlan): bins of a CTA's tile, row
// slots (rows slot, slot + slots, ... a thread), rows a thread (the kernel
// instance: 2, 4 or 8), frames a stage of the ring, stages, threads a CTA
// (a multiple of 32, at least tile * slots).
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

// Grid (nbins / tile, K, row tiles), plan.threads threads; dynamic shared
// memory stages x nch x frames x tile float2 of the ring, then nch float2
// of the block's means (with `x`).  Row tile z holds rows z slots kRows
// onwards; a thread's rows run cross and auto pairs first, then T, then GJ
// (r = z slots kRows + slot + j slots), so their kinds are the same across
// a row slot (a warp where the tile is 32 bins or more): the branches on
// them do not diverge.
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
  const int r0 = static_cast<int>(blockIdx.z) * p.slots * kRows;
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
    const int r = r0 + slot + j * p.slots;
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
  // the reduce's share, while the first chunks are in flight: block k's
  // means, for mu (bin tile 0) and the new history (the last block), in
  // row tile 0 alone
  constexpr bool kC64 = sizeof(T) == sizeof(float2);
  using Pair = typename SumOf<T>::pair;
  const bool fold = a.x != nullptr && blockIdx.z == 0
                    && (blockIdx.x == 0 || k == a.K - 1);
  if (fold) {
    const int warps = blockDim.x >> 5;
    for (int c = threadIdx.x >> 5; c < nch; c += warps) {
      const float2 m = warp_block_mean<T>(
          static_cast<const Pair*>(a.sums)
              + static_cast<size_t>(k) * a.n_groups * nch + c,
          a.n_groups, nch, static_cast<long long>(S) * nbins, a.step);
      if ((threadIdx.x & 31) == 0) means[c] = m;
    }
  }

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
      const int r = r0 + slot + j * p.slots;
      // an auto pair's imaginary part is 0 (its sum of the products'
      // imaginary parts is only their roundings)
      a.parts[(static_cast<size_t>(k) * rows + r) * nbins + bin] =
          (autos >> j) & 1u ? make_float2(acc[j].x, 0.f) : acc[j];
    }
  }

  if (!fold) return;
  if (blockIdx.x == 0) {
    for (int c = threadIdx.x; c < nch; c += blockDim.x) {
      a.mu[static_cast<size_t>(k) * nch + c] = means[c];
    }
  }
  if (k != a.K - 1) return;
  // the new history at this CTA's bins
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

// The plan's kernel instance on `st` (with `dependent`, a programmatic
// dependent of the kernel before it) over `row_tiles` tiles of rows; more
// threads than it takes is an error.
template <typename T, int kRows>
cudaError_t launch_rows(const XStageArgs<T>& a, size_t smem, int row_tiles,
                        bool dependent, cudaStream_t st) {
  if (a.plan.threads > RowThreads<kRows>::value) return cudaErrorInvalidValue;
  auto* kernel = &fx_xstage_kernel<T, kRows>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return launch_kernel(kernel, dim3(a.nbins / a.plan.tile, a.K, row_tiles),
                       dim3(a.plan.threads), smem, st, dependent, a);
}

// The plan is checked against the shape: it must cover every bin and
// frame, its row tiles every row (at most 65535 of them), and its ring
// must hold the history's means after the last chunk.
template <typename T>
cudaError_t launch_xstage(const XStageArgs<T>& a, bool dependent,
                          cudaStream_t st) {
  const XStagePlan& p = a.plan;
  const long long rows = static_cast<long long>(a.nbl) + 2 * a.nch;
  if (a.K < 1 || a.K > 65535 || a.S < 1 || a.nch < 1 || a.nch > 255
      || a.nbl < 0 || a.halo < 0 || a.halo > a.S || p.tile < 2
      || (p.tile & (p.tile - 1)) != 0 || a.nbins % p.tile != 0
      || p.frames < 1 || (p.frames & (p.frames - 1)) != 0 || p.slots < 1
      || p.rows < 1 || p.threads % 32 != 0 || p.threads < p.tile * p.slots
      || p.stages < 2 || p.stages > kMaxStages) {
    return cudaErrorInvalidValue;
  }
  const long long per_tile = static_cast<long long>(p.slots) * p.rows;
  const long long row_tiles = (rows + per_tile - 1) / per_tile;
  if (row_tiles < 1 || row_tiles > 65535) return cudaErrorInvalidValue;
  const int z = static_cast<int>(row_tiles);
  const size_t smem = (static_cast<size_t>(p.stages) * a.nch * p.frames
                          * p.tile + a.nch) * sizeof(float2);
  switch (p.rows) {
    case 2: return launch_rows<T, 2>(a, smem, z, dependent, st);
    case 4: return launch_rows<T, 4>(a, smem, z, dependent, st);
    case 8: return launch_rows<T, 8>(a, smem, z, dependent, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace fxt {

int xstage(bool int8, const void* spec, const void* pairs, const void* da,
           void* parts, const void* x, const void* sums, void* mu,
           void* new_hist, int nch, int K, int S, int nbins, int nbl,
           int halo, int n_groups, int tile, int slots, int rows, int frames,
           int stages, int threads, double step, bool dependent,
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
    return static_cast<int>(launch_xstage(a, dependent, st));
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
  return static_cast<int>(launch_xstage(a, dependent, st));
}

}  // namespace fxt

// The X stage on `stream` (fx_xstage.py): spec complex64 [K, nch, S, nbins],
// pairs int32 [nbl, 2], da complex64 [halo, nbins] (halo <= S); writes parts
// [K, nbl + 2 nch, nbins].  With x NULL that is all (fx_xstage alone; sums,
// mu, new_hist and n_groups unused).  Else it ends the wide route's step
// after fxt_fx_wide_frames: x complex64 [nch, K, S, nbins] and the frame
// kernel's sums double2 [K, n_groups, nch] give mu [K, nch] and the new
// history [nch, halo, nbins].  tile, slots, rows, frames, stages and
// threads are the launch's plan (fx_xstage.xstage_plan; its row tiles
// follow from slots and rows), checked here against the shape (an invalid
// plan returns cudaErrorInvalidValue).  The
// caller has checked shapes, types and contiguity.  Returns
// cudaGetLastError().
extern "C" int fxt_xstage(const void* spec, const void* pairs,
                          const void* da, void* parts, const void* x,
                          const void* sums, void* mu, void* new_hist,
                          int nch, int K, int S, int nbins, int nbl,
                          int halo, int n_groups, int tile, int slots,
                          int rows, int frames, int stages, int threads,
                          void* stream) {
  return fxt::xstage(false, spec, pairs, da, parts, x, sums, mu, new_hist,
                     nch, K, S, nbins, nbl, halo, n_groups, tile, slots, rows,
                     frames, stages, threads, 1.0, false,
                     static_cast<cudaStream_t>(stream));
}

// The X stage after fxt_fx_wide_frames_i8: fxt_xstage's contract with x
// int8 [nch, K, S, nbins, 2], sums longlong2 (exact integer sums), mu in
// real units (times `step`) and the new tail the last rows as they arrived.
extern "C" int fxt_xstage_i8(const void* spec, const void* pairs,
                             const void* da, void* parts, const void* x,
                             const void* sums, void* mu, void* new_tail,
                             int nch, int K, int S, int nbins, int nbl,
                             int halo, int n_groups, int tile, int slots,
                             int rows, int frames, int stages, int threads,
                             double step, void* stream) {
  return fxt::xstage(true, spec, pairs, da, parts, x, sums, mu, new_tail, nch,
                     K, S, nbins, nbl, halo, n_groups, tile, slots, rows,
                     frames, stages, threads, step, false,
                     static_cast<cudaStream_t>(stream));
}

// The plan's integers fxt_xstage and fxt_xstage_i8 take, in
// fx_xstage.XStagePlan.args()'s order (a tool that drives two builds of
// this file asks each how to call it).
extern "C" int fxt_xstage_plan_ints(void) { return 6; }
