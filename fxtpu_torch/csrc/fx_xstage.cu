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
// spectra of 4096 or 8192 bins beyond 6 or 2 channels.
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
// What bounds it on the H100: bench.py's nchan8 block (8 channels, 256
// frames of 4096 bins, 36 pairs with autos) reads 64 MiB of spectra and
// writes 1.6 MiB of parts: 20 us at 3.35 TB/s, against 0.34 GFLOP of
// products, 5 us at 67 TFLOP/s.  It is a per-bin Hermitian product
// [nch x S][S x nch], so at 64 channels the operations grow as nch^2 and
// the tensor cores would be the way there (not taken here).  Design: a CTA
// owns 32 bins (one a lane) of one block and a tile of 32 rows of parts
// (four a warp, warp-uniform, so the branch on a row's kind does not
// diverge); it stages each chunk of 8 frames of every channel's spectra at
// its bins in shared memory (nch x 8 x 32 x 8 bytes, 128 KiB at 64
// channels) and each thread keeps its rows' sums in registers.  The row
// tile is the grid's fastest axis, so the CTAs of one bin tile run
// together and a second row tile reads the spectra from L2.  No atomics:
// every output element has one owner.

#include <cuda_runtime.h>

#include "fx_common.cuh"   // cadd, csub, cmulconj, SumOf

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBins = 32;                       // one bin a lane
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kRowsPerWarp * kWarps;    // rows of a CTA
constexpr int kChunk = 8;                           // frames staged at once
constexpr int kStride = kChunk * kTileBins;         // a channel's staged run

// What a row of parts is.
enum : int { kNone = 0, kCross, kAuto, kTotal, kGj };

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
};

// A block's mean of one channel from its groups' sums, by one warp: the
// lanes load 32 groups' sums at a time and every lane adds them in group
// order from the shuffles, formed in double and rounded once: fx_fused.cu's
// parts_mean to the bit, without one dependent load per group.
template <typename T>
__device__ float2 warp_block_mean(
    const typename SumOf<T>::pair* __restrict__ sums, int n_groups, int nch,
    long long n, double step) {
  using A = typename SumOf<T>::type;
  const int lane = threadIdx.x & 31;
  A r = 0, i = 0;
  for (int g0 = 0; g0 < n_groups; g0 += 32) {
    A vr = 0, vi = 0;
    if (g0 + lane < n_groups) {
      const typename SumOf<T>::pair v =
          sums[static_cast<size_t>(g0 + lane) * nch];
      vr = v.x;
      vi = v.y;
    }
    const int m = min(32, n_groups - g0);
    for (int j = 0; j < m; ++j) {
      r += __shfl_sync(0xffffffffu, vr, j);
      i += __shfl_sync(0xffffffffu, vi, j);
    }
  }
  const double nd = static_cast<double>(n);
  return make_float2(static_cast<float>(static_cast<double>(r) / nd * step),
                     static_cast<float>(static_cast<double>(i) / nd * step));
}

// Grid (row tiles, nbins / kTileBins, K); dynamic shared memory nch x
// kChunk x kTileBins float2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fx_xstage_kernel(const XStageArgs<T> a) {
  extern __shared__ float2 tile[];   // [nch][kChunk][kTileBins]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.z;
  const int b0 = blockIdx.y * kTileBins;
  const int bin = b0 + lane;
  const int rows = a.nbl + 2 * a.nch;

  int kind[kRowsPerWarp], ca[kRowsPerWarp], cb[kRowsPerWarp];
  float2 acc[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = blockIdx.x * kTileRows + j * kWarps + warp;
    kind[j] = kNone;
    ca[j] = cb[j] = 0;
    if (r < a.nbl) {
      ca[j] = __ldg(a.pairs + 2 * r);
      cb[j] = __ldg(a.pairs + 2 * r + 1);
      kind[j] = ca[j] == cb[j] ? kAuto : kCross;
    } else if (r < a.nbl + a.nch) {
      kind[j] = kTotal;
      ca[j] = r - a.nbl;
    } else if (r < rows) {
      kind[j] = kGj;
      ca[j] = r - a.nbl - a.nch;
    }
    acc[j] = make_float2(0.f, 0.f);
  }

  const float2* sk = a.spec + static_cast<size_t>(k) * a.nch * a.S * a.nbins
                     + b0;
  for (int f0 = 0; f0 < a.S; f0 += kChunk) {
    const int nf = min(kChunk, a.S - f0);
    for (int i = threadIdx.x; i < a.nch * kStride; i += kThreads) {
      const int l = i % kTileBins;
      const int ff = (i / kTileBins) % kChunk;
      const int c = i / kStride;
      if (ff < nf) {
        tile[i] = __ldg(sk + (static_cast<size_t>(c) * a.S + f0 + ff) * a.nbins
                        + l);
      }
    }
    __syncthreads();
    for (int ff = 0; ff < nf; ++ff) {
      const int f = f0 + ff;
      const float2* at = tile + ff * kTileBins + lane;
      const float2 d =
          f < a.halo ? __ldg(a.da + static_cast<size_t>(f) * a.nbins + bin)
                     : make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const float2 vp = at[ca[j] * kStride];
        if (kind[j] == kCross) {
          acc[j] = cadd(acc[j], cmulconj(vp, at[cb[j] * kStride]));
        } else if (kind[j] == kAuto) {
          acc[j] = cadd(acc[j], make_float2(cmulconj(vp, vp).x, 0.f));
        } else if (kind[j] == kTotal) {
          acc[j] = cadd(acc[j], vp);
        } else if (kind[j] == kGj && f < a.halo) {
          acc[j] = cadd(acc[j], cmulconj(vp, d));
        }
      }
    }
    __syncthreads();   // the next chunk overwrites the tile
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    if (kind[j] != kNone) {
      const int r = blockIdx.x * kTileRows + j * kWarps + warp;
      a.parts[(static_cast<size_t>(k) * rows + r) * a.nbins + bin] = acc[j];
    }
  }

  // the reduce's share, in the first row tile: each block's means (bin
  // tile 0) and the new history at this CTA's bins (the last block)
  if (a.x == nullptr || blockIdx.x != 0) return;
  constexpr bool kC64 = sizeof(T) == sizeof(float2);
  using Pair = typename SumOf<T>::pair;
  const Pair* sums = static_cast<const Pair*>(a.sums);
  const long long n = static_cast<long long>(a.S) * a.nbins;
  // a warp per channel (warp-uniform loops: the shuffles see every lane)
  if (blockIdx.y == 0) {
    for (int c = warp; c < a.nch; c += kWarps) {
      const float2 m = warp_block_mean<T>(
          sums + static_cast<size_t>(k) * a.n_groups * a.nch + c,
          a.n_groups, a.nch, n, a.step);
      if (lane == 0) a.mu[static_cast<size_t>(k) * a.nch + c] = m;
    }
  }
  if (k != a.K - 1) return;
  float2* mu_last = tile;   // [nch], the tile is free after the last chunk
  if constexpr (kC64) {
    for (int c = warp; c < a.nch; c += kWarps) {
      const float2 m = warp_block_mean<T>(
          sums + static_cast<size_t>(k) * a.n_groups * a.nch + c,
          a.n_groups, a.nch, n, a.step);
      if (lane == 0) mu_last[c] = m;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < a.nch * a.halo * kTileBins;
       i += kThreads) {
    const int l = i % kTileBins;
    const int r = (i / kTileBins) % a.halo;
    const int c = i / (kTileBins * a.halo);
    const T v = a.x[(static_cast<long long>(c) * a.K + k) * n
                    + static_cast<long long>(a.S - a.halo + r) * a.nbins
                    + b0 + l];
    T* out = a.new_hist + (static_cast<size_t>(c) * a.halo + r) * a.nbins
             + b0 + l;
    if constexpr (kC64) {
      *out = csub(v, mu_last[c]);
    } else {
      *out = v;
    }
  }
}

template <typename T>
cudaError_t launch_xstage(const XStageArgs<T>& a, cudaStream_t st) {
  if (a.K < 1 || a.K > 65535 || a.S < 1 || a.nch < 1 || a.nbl < 0
      || a.halo < 0 || a.halo > a.S || a.nbins < kTileBins
      || a.nbins % kTileBins != 0) {
    return cudaErrorInvalidValue;
  }
  const int rows = a.nbl + 2 * a.nch;
  const size_t smem =
      static_cast<size_t>(a.nch) * kStride * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&fx_xstage_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kTileRows - 1) / kTileRows, a.nbins / kTileBins,
                  a.K);
  fx_xstage_kernel<T><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The X stage on `stream` (fx_xstage.py): spec complex64 [K, nch, S, nbins],
// pairs int32 [nbl, 2], da complex64 [halo, nbins] (halo <= S); writes parts
// [K, nbl + 2 nch, nbins].  With x NULL that is all (fx_xstage alone; sums,
// mu, new_hist and n_groups unused).  Else it ends the wide route's step
// after fxt_fx_wide_frames: x complex64 [nch, K, S, nbins] and the frame
// kernel's sums double2 [K, n_groups, nch] give mu [K, nch] and the new
// history [nch, halo, nbins].  The caller has checked shapes, types and
// contiguity, and that nbins is a multiple of 32.  Returns
// cudaGetLastError().
extern "C" int fxt_xstage(const void* spec, const void* pairs,
                          const void* da, void* parts, const void* x,
                          const void* sums, void* mu, void* new_hist,
                          int nch, int K, int S, int nbins, int nbl,
                          int halo, int n_groups, void* stream) {
  const XStageArgs<float2> a{static_cast<const float2*>(spec),
                             static_cast<const int*>(pairs),
                             static_cast<const float2*>(da),
                             static_cast<float2*>(parts),
                             nch, K, S, nbins, nbl, halo,
                             static_cast<const float2*>(x), sums,
                             static_cast<float2*>(mu),
                             static_cast<float2*>(new_hist), n_groups, 1.0};
  return static_cast<int>(
      launch_xstage(a, static_cast<cudaStream_t>(stream)));
}

// The X stage after fxt_fx_wide_frames_i8: fxt_xstage's contract with x
// int8 [nch, K, S, nbins, 2], sums longlong2 (exact integer sums), mu in
// real units (times `step`) and the new tail the last rows as they arrived.
extern "C" int fxt_xstage_i8(const void* spec, const void* pairs,
                             const void* da, void* parts, const void* x,
                             const void* sums, void* mu, void* new_tail,
                             int nch, int K, int S, int nbins, int nbl,
                             int halo, int n_groups, double step,
                             void* stream) {
  const XStageArgs<char2> a{static_cast<const float2*>(spec),
                            static_cast<const int*>(pairs),
                            static_cast<const float2*>(da),
                            static_cast<float2*>(parts),
                            nch, K, S, nbins, nbl, halo,
                            static_cast<const char2*>(x), sums,
                            static_cast<float2*>(mu),
                            static_cast<char2*>(new_tail), n_groups, step};
  return static_cast<int>(
      launch_xstage(a, static_cast<cudaStream_t>(stream)));
}
