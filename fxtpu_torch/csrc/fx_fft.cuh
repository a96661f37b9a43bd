// The frame kernel's FFT (fx_fused.cu: fft_sized runs it over a slot of
// its shared memory) at the powers of two in [256, 8192]: radix-16
// Stockham passes in registers.  One copy, included by fx_fused.cu and by
// probes.cu, whose overlap probe runs the frame kernel's body (its FIR,
// then this FFT) on rows it copies into shared memory.  The passes take
// the threads that run them as a policy: the whole CTA of 256 threads in
// the frame kernel (WholeCta), a team of 256 threads with a named barrier
// of its own in the probe.
//
// The FFT: an in-place Stockham FFT of radix 16 in registers.  nbins =
// 16 * 16 * r with r = 1 (256 bins: two passes), 2, 4, 8, 16 or 32 (512 to
// 8192 bins: three passes).  Pass p of radix R over n points runs the n / R
// butterflies j: each thread loads its R points j + r n / R from the slot
// into registers, multiplies point r by exp(-2 pi i r k / (Ns R)) (k = j mod
// Ns, Ns the product of the radices before it; the table tw, formed in
// float64, staged in shared memory once a CTA), runs an R-point DFT in
// registers (radix-2 decimation in frequency with constant twiddles, no
// sincos), and after a barrier writes output r to (j - k) R + k + r Ns:
// natural order after the last pass.  Two barriers a pass (every load of a
// pass before any store, every store before the next pass's loads), so the
// slot is its own work buffer.  Pass 0's stores (stride 16) would put a
// half-warp on one bank; they and pass 1's loads go through the swizzle
// L ^ ((L >> 4) & 15) instead, which leaves both conflict-free.  A thread
// holds 16 points (1 butterfly at up to 4096 bins, 2 at 8192 in passes 0
// and 1; 32 points in pass 2 at 8192); below 4096 bins n / 16 threads work
// and the rest wait.  fx_fused.fft_passes is the same index arithmetic in
// torch.
#pragma once

#include <cuda_runtime.h>

#include "fx_common.cuh"   // cadd, csub

namespace {

// Threads of one FFT: a pass's butterfly j runs on thread j mod 256.
constexpr int kFftThreads = 256;

// The FFT run by the whole CTA of kFftThreads threads.
struct WholeCta {
  __device__ static int tid() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(-2 pi i j / 32) = kCos32[j] - i kSin32[j], rounded from float64.
__constant__ float kCos32[16] = {
    1.0f, 0.9807852506637573f, 0.9238795042037964f, 0.8314695954322815f,
    0.7071067690849304f, 0.5555702447891235f, 0.3826834261417389f,
    0.19509032368659973f, 0.0f, -0.19509032368659973f, -0.3826834261417389f,
    -0.5555702447891235f, -0.7071067690849304f, -0.8314695954322815f,
    -0.9238795042037964f, -0.9807852506637573f};
__constant__ float kSin32[16] = {
    0.0f, 0.19509032368659973f, 0.3826834261417389f, 0.5555702447891235f,
    0.7071067690849304f, 0.8314695954322815f, 0.9238795042037964f,
    0.9807852506637573f, 1.0f, 0.9807852506637573f, 0.9238795042037964f,
    0.8314695954322815f, 0.7071067690849304f, 0.5555702447891235f,
    0.3826834261417389f, 0.19509032368659973f};

// d * exp(-2 pi i j / 32) for a j known at compile time once unrolled.
__device__ __forceinline__ float2 rot32(float2 d, int j) {
  if (j == 0) return d;
  if (j == 8) return make_float2(d.y, -d.x);
  const float c = kCos32[j], s = kSin32[j];
  return make_float2(d.x * c + d.y * s, d.y * c - d.x * s);
}

// The radix-2 stages of span Span, Span / 2, ..., 1 of an R-point DFT by
// decimation in frequency: v ends holding the DFT in bit-reversed order.
template <int R, int Span>
__device__ __forceinline__ void dif_stages(float2 (&v)[R]) {
#pragma unroll
  for (int s = 0; s < R; s += 2 * Span) {
#pragma unroll
    for (int k = 0; k < Span; ++k) {
      const float2 a = v[s + k];
      const float2 b = v[s + k + Span];
      v[s + k] = cadd(a, b);
      v[s + k + Span] = rot32(csub(a, b), k * (16 / Span));
    }
  }
  if constexpr (Span > 1) dif_stages<R, Span / 2>(v);
}

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n >> 1);
}

__host__ __device__ constexpr int bitrev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r = (r << 1) | ((i >> b) & 1);
  return r;
}

template <bool kSwizzle>
__device__ __forceinline__ int swz(int i) {
  if constexpr (kSwizzle) {
    return i ^ ((i >> 4) & 15);
  } else {
    return i;
  }
}

// exp(-2 pi i m / n) for 0 <= m < n from the table of its first half (in
// shared memory).
__device__ __forceinline__ float2 twiddle(const float2* tw, int m,
                                          int half) {
  const float2 t = tw[m & (half - 1)];
  return (m & half) ? make_float2(-t.x, -t.y) : t;
}

// One pass of radix R with stride Ns over the n points of buf, kPer
// butterflies a thread (header above).
template <int R, int kPer, bool kSwzIn, bool kSwzOut, class Team = WholeCta>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* tw,
                                         int n, int ns) {
  constexpr int kLog = ilog2(R);
  const int nb = n / R;
  float2 v[kPer][R];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int j = Team::tid() + p * kFftThreads;
    if (j < nb) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[p][r] = buf[swz<kSwzIn>(j + r * nb)];
      if (ns > 1) {
        const int step = (j & (ns - 1)) * (n / (ns * R));
#pragma unroll
        for (int r = 1; r < R; ++r) {
          v[p][r] = cmul(v[p][r], twiddle(tw, r * step, n >> 1));
        }
      }
      dif_stages<R, R / 2>(v[p]);
    }
  }
  Team::sync();
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int j = Team::tid() + p * kFftThreads;
    if (j < nb) {
      const int k = j & (ns - 1);
      const int base = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        buf[swz<kSwzOut>(base + r * ns)] = v[p][bitrev(r, kLog)];
      }
    }
  }
  Team::sync();
}

// How many radix passes an FFT of 2^log2n points makes.
__host__ __device__ constexpr int fft_pass_count(int log2n) {
  return log2n <= 8 ? 2 : 3;
}

// The first `npasses` passes of the FFT of 2^kLog points over `buf` (in
// shared memory) with the twiddle table `tw` there, run by Team's 256
// threads.
template <int kLog, class Team = WholeCta>
__device__ __forceinline__ void fft_run(float2* buf, const float2* tw,
                                        int npasses) {
  constexpr int n = 1 << kLog;
  constexpr int kPer = n > 16 * kFftThreads ? 2 : 1;  // radix-16 butterflies
  fft_pass<16, kPer, false, true, Team>(buf, tw, n, 1);
  if (npasses > 1) fft_pass<16, kPer, true, false, Team>(buf, tw, n, 16);
  if constexpr (kLog > 8) {
    if (npasses > 2) {
      fft_pass<(n >> 8), 1, false, false, Team>(buf, tw, n, 256);
    }
  }
}

}  // namespace
