// Measurement kernels of fxtpu_torch.probes: how fast a CTA brings rows from
// device memory into shared memory, whether that copy hides behind the
// frame's arithmetic, and what a shared-memory layout costs.  Built by
// fxtpu_torch/cuda_build.py with the rest of csrc/, called through
// fxtpu_torch/probes/{copy_rate,overlap,retile}.py.  Each kernel writes a
// checksum that is a defined function of its input; the plain PyTorch
// version beside each wrapper computes the same function, so a leg that
// skips the work it claims to time fails the comparison.
//
// Replaces the TPU probes
//   scripts/dma_width_probe.py make_fn      -> fxt_copy_probe (width sweep)
//   scripts/dma_shape_probe.py make_kernel  -> fxt_copy_probe (shape sweep)
//   scripts/dma_overlap_probe.py make_kernel / make_2d_kernel
//                                           -> fxt_overlap_probe
//   scripts/retile_probe.py make_fn         -> fxt_retile_probe
// They keep each probe's question, its byte accounting and its method (the
// walk repeated inside one launch, the slope between two repeat counts);
// the legs are Hopper's: loads through registers, cp.async, and the bulk
// copy (TMA's 1-D cp.async.bulk completing on an mbarrier), against the
// TPU's DMA descriptors and slot indexing.
//
// What bounds them on the H100: fxt_copy_probe moves each tile's bytes
// once from device memory (or L2) to shared memory and reads them once
// there; its bound is bytes / 3.35 TB/s (the L2's rate when the walk fits
// the 50 MB L2), and GB/s against that is what it reports.
// fxt_overlap_probe's legs are bounded by the larger of the copy (bytes)
// and the body (shared-memory traffic and one barrier per Stockham stage,
// not flops: 5 n log2 n flops per frame is far below the fp32 peak); the
// probe reports which of sum(copy, body) and max(copy, body) a leg reaches.
// fxt_retile_probe reads 16 KB per frame from L2 and does 2 n1 n flops per
// frame in its body; its legs differ by shared-memory bank conflicts alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fx_common.cuh"   // cadd, csub, cp_async16, cp_async_wait_pending

namespace {

constexpr int kThreads = 256;

// Copy mechanisms.
enum : int { kLdg = 0, kCpAsync = 1, kBulk = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses before the bulk
// copies it starts next into the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory to shared memory by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One radix-2 Stockham stage of the frame kernel (fx_fused.cu), with its
// own indexing: a -> b over n points, stage s (ns = 1 << s).
__device__ __forceinline__ void stockham_stage(const float2* a, float2* b,
                                               const float2* tw, int n,
                                               int log2n, int s, int tid,
                                               int nthreads) {
  const int half = n >> 1;
  const int ns = 1 << s;
  const int tshift = log2n - 1 - s;
  for (int j = tid; j < half; j += nthreads) {
    const int k = j & (ns - 1);
    const float2 v0 = a[j];
    const float2 v1 = cmul(a[j + half], __ldg(tw + (k << tshift)));
    const int d = ((j - k) << 1) + k;
    b[d] = cadd(v0, v1);
    b[d + ns] = csub(v0, v1);
  }
}

// ---------------------------------------------------------------------
// fxt_copy_probe.  Tile t is nch x rows runs of `width` contiguous bytes.
// Run (c, i) of tile t starts at
//   src + (t / tpb) blk_stride + (t % tpb) tile_stride + c chan_stride
//       + i row_stride
// and lands in shared memory at c dst_chan_stride + i dst_row_stride (the
// runs tile the CTA's nch rows width bytes exactly, in either order).  CTA
// b takes tiles b, b + gridDim.x, ...; the walk over all tiles is repeated
// `reps` times.  After each tile has arrived the CTA sums its 32-bit words
// (mod 2^32) and adds the sum to out[t]: out[t] = reps x (sum of tile t's
// words), whatever the mechanism.
struct CopyArgs {
  const unsigned char* src;
  unsigned int* out;
  long long blk_stride, tile_stride, chan_stride, row_stride;
  int ntiles, tpb, nch, rows, width, dst_chan_stride, dst_row_stride, reps;
};

// V is the type a thread loads at a time: 2, 8 or 16 bytes for kLdg (the
// frame kernel loads one char2 or float2 per thread), 16 for kCpAsync.
template <int Mech, typename V>
__global__ void __launch_bounds__(kThreads) copy_probe_kernel(CopyArgs p) {
  extern __shared__ __align__(128) unsigned char tile[];
  __shared__ uint64_t bar;
  __shared__ unsigned int red[kThreads / 32];
  const int tid = threadIdx.x;
  const int nruns = p.nch * p.rows;
  const int tile_bytes = nruns * p.width;
  uint32_t parity = 0;
  if constexpr (Mech == kBulk) {
    if (tid == 0) {
      mbar_init(&bar, 1);
      mbar_fence_init();
    }
    __syncthreads();
  }
  for (int rep = 0; rep < p.reps; ++rep) {
    for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
      const unsigned char* base = p.src + (t / p.tpb) * p.blk_stride +
                                  (t % p.tpb) * p.tile_stride;
      if constexpr (Mech == kBulk) {
        if (tid < 32) {
          fence_proxy_async();
          if (tid == 0) {
            mbar_expect_tx(&bar, static_cast<uint32_t>(tile_bytes));
          }
          __syncwarp();
          for (int run = tid; run < nruns; run += 32) {
            const int c = run / p.rows, i = run - c * p.rows;
            bulk_copy(tile + c * p.dst_chan_stride + i * p.dst_row_stride,
                      base + c * p.chan_stride + i * p.row_stride,
                      static_cast<uint32_t>(p.width), &bar);
          }
        }
        mbar_wait(&bar, parity);
        parity ^= 1;
      } else {
        const int cpr = p.width / static_cast<int>(sizeof(V));
        const int sh = 31 - __clz(cpr);   // width is a power of two
        for (int q = tid; q < nruns * cpr; q += kThreads) {
          const int run = q >> sh, off = q & (cpr - 1);
          const int c = run / p.rows, i = run - c * p.rows;
          const V* s = reinterpret_cast<const V*>(
                           base + c * p.chan_stride + i * p.row_stride) +
                       off;
          V* d = reinterpret_cast<V*>(tile + c * p.dst_chan_stride +
                                      i * p.dst_row_stride) +
                 off;
          if constexpr (Mech == kLdg) {
            *d = __ldg(s);
          } else {
            cp_async16(d, s);
          }
        }
        if constexpr (Mech == kCpAsync) {
          cp_async_commit();
          cp_async_wait<0>();
        }
        __syncthreads();
      }
      unsigned int sum = 0;
      const uint4* w4 = reinterpret_cast<const uint4*>(tile);
      for (int q = tid; q < tile_bytes / 16; q += kThreads) {
        const uint4 v = w4[q];
        sum += v.x + v.y + v.z + v.w;
      }
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_down_sync(0xffffffffu, sum, o);
      }
      if ((tid & 31) == 0) red[tid >> 5] = sum;
      __syncthreads();
      if (tid == 0) {
        unsigned int total = 0;
        for (int k = 0; k < kThreads / 32; ++k) total += red[k];
        p.out[t] = rep == 0 ? total : p.out[t] + total;
      }
      __syncthreads();  // the next tile overwrites `tile` and `red`
    }
  }
}

template <int Mech, typename V>
cudaError_t launch_copy(const CopyArgs& p, int grid, int smem,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&copy_probe_kernel<Mech, V>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  copy_probe_kernel<Mech, V><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// fxt_overlap_probe.  CTA b works on `frames` frames of an [R, n]
// complex64 array; frame f reads rows f .. f + ntaps - 1 (as the frame
// kernel's FIR does), in chunks of cb bins: chunk (f, q) is ntaps runs of
// cb x 8 bytes.  The chunks stream through a ring of nbuf slots in shared
// memory; the walk over the CTA's frames is repeated `reps` times.
//   copy = 1, nbuf = 1: a chunk is asked for after the body has used the
//     one before, and waited for (serial; with two CTAs on an SM the
//     scheduler overlaps them);
//   copy = 1, nbuf > 1: chunks g + 1 .. g + nbuf - 1 are in flight while
//     the body runs on chunk g (pipelined; nbuf = n / cb brings in the
//     whole next frame behind the Stockham stages);
//   copy = 0: the first nbuf chunks are brought in once and the body runs
//     on them again and again (the body alone).
// Bodies: kBodyTouch adds 256 values of each chunk's first row (the copy
// alone); kBodyFma runs `passes` multiply-add passes through shared memory
// on the chunk's first two rows; kBodyFx is the frame kernel in miniature,
// a FIR over the ntaps rows with taps 0.25 + 0.01 t, then at the frame's
// last chunk log2 n Stockham stages.  out[b, :] is the sum over the CTA's
// frames of the body's n values (kBodyTouch: its 256).
enum : int { kBodyTouch = 0, kBodyFma = 1, kBodyFx = 2 };
constexpr int kMaxOwn = 32;  // bins a thread owns: n <= kMaxOwn * kThreads
constexpr int kMaxRing = 8;  // slots of the ring

struct OverlapArgs {
  const float2* src;
  float2* out;
  const float2* tw;
  int n, log2n, cb, ntaps, frames, reps, nbuf, copy, passes;
};

template <int Body, int Mech>
__global__ void __launch_bounds__(kThreads)
overlap_probe_kernel(OverlapArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t bars[kMaxRing];
  float2* ring = reinterpret_cast<float2*>(smem_raw);  // [nbuf][ntaps][cb]
  float2* a = ring + static_cast<size_t>(p.nbuf) * p.ntaps * p.cb;
  float2* b = a + p.n;
  const int tid = threadIdx.x;
  const int cpf = p.n / p.cb;
  const int total = p.reps * p.frames * cpf;
  const long long f_base = static_cast<long long>(blockIdx.x) * p.frames;
  uint32_t phases = 0;  // bit s: the parity slot s's barrier completes next

  if constexpr (Mech == kBulk) {
    if (tid == 0) {
      for (int s = 0; s < kMaxRing; ++s) mbar_init(&bars[s], 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  auto fetch = [&](int g, int slot) {
    const int fl = (g / cpf) % p.frames, q = g % cpf;
    const float2* s0 = p.src + (f_base + fl) * p.n + q * p.cb;
    float2* d0 = ring + static_cast<size_t>(slot) * p.ntaps * p.cb;
    if constexpr (Mech == kCpAsync) {
      const int cpr = p.cb / 2;  // 16-byte pieces of one run
      for (int i = tid; i < p.ntaps * cpr; i += kThreads) {
        const int t = i / cpr, off = i - t * cpr;
        cp_async16(reinterpret_cast<uint4*>(d0 + t * p.cb) + off,
                   reinterpret_cast<const uint4*>(
                       s0 + static_cast<long long>(t) * p.n) +
                       off);
      }
      cp_async_commit();
    } else {
      if (tid == 0) {
        fence_proxy_async();
        mbar_expect_tx(&bars[slot],
                       static_cast<uint32_t>(p.ntaps * p.cb * 8));
        for (int t = 0; t < p.ntaps; ++t) {
          bulk_copy(d0 + t * p.cb, s0 + static_cast<long long>(t) * p.n,
                    static_cast<uint32_t>(p.cb * 8), &bars[slot]);
        }
      }
    }
  };
  // Chunk in `slot` has arrived for every thread; `younger` chunks are
  // in flight behind it.
  auto wait = [&](int slot, int younger) {
    if constexpr (Mech == kCpAsync) {
      cp_async_wait_pending(younger);
      __syncthreads();
    } else {
      mbar_wait(&bars[slot], (phases >> slot) & 1u);
      phases ^= 1u << slot;
    }
  };

  const int depth = p.nbuf > 1 ? p.nbuf - 1 : 1;  // chunks asked for ahead
  if (p.copy) {
    for (int s = 0; s < depth && s < total; ++s) fetch(s, s);
  } else {
    for (int s = 0; s < p.nbuf; ++s) fetch(s, s);
    for (int s = 0; s < p.nbuf; ++s) wait(s, 0);
  }

  float2 acc[kMaxOwn];
#pragma unroll
  for (int j = 0; j < kMaxOwn; ++j) acc[j] = make_float2(0.f, 0.f);
  float2 touch = make_float2(0.f, 0.f);

  for (int g = 0; g < total; ++g) {
    const int slot = g % p.nbuf;
    const int q = g % cpf;
    const bool next = g + 1 < total;
    if (p.copy) {
      int younger = 0;
      if (p.nbuf > 1) {
        const int h = g + depth;
        if (h < total) fetch(h, h % p.nbuf);
        younger = min(depth, total - 1 - g);
      }
      wait(slot, younger);
    }
    const float2* chunk = ring + static_cast<size_t>(slot) * p.ntaps * p.cb;
    if constexpr (Body == kBodyTouch) {
      touch = cadd(touch, chunk[tid]);
    } else if constexpr (Body == kBodyFma) {
      // every operand a shared-memory load, every result a store
      volatile float* va = reinterpret_cast<volatile float*>(a + q * p.cb);
      volatile float* vb = reinterpret_cast<volatile float*>(b + q * p.cb);
      for (int e = tid; e < p.cb; e += kThreads) {
        const float2 x0 = chunk[e], y0 = chunk[p.cb + e];
        va[2 * e] = x0.x;
        va[2 * e + 1] = x0.y;
        vb[2 * e] = y0.x;
        vb[2 * e + 1] = y0.y;
        for (int k = 0; k < p.passes; ++k) {
          float xr = va[2 * e], xi = va[2 * e + 1];
          float yr = vb[2 * e], yi = vb[2 * e + 1];
          xr = xr * 1.0000001f + yr;
          xi = xi * 1.0000001f + yi;
          yr = yr * 0.9999999f + xr;
          yi = yi * 0.9999999f + xi;
          va[2 * e] = xr;
          va[2 * e + 1] = xi;
          vb[2 * e] = yr;
          vb[2 * e + 1] = yi;
        }
      }
    } else {
      for (int e = tid; e < p.cb; e += kThreads) {
        float2 s = make_float2(0.f, 0.f);
        for (int t = 0; t < p.ntaps; ++t) {
          const float w = 0.25f + 0.01f * t;
          const float2 v = chunk[t * p.cb + e];
          s.x += w * v.x;
          s.y += w * v.y;
        }
        a[q * p.cb + e] = s;
      }
    }
    __syncthreads();
    if (Body != kBodyTouch && q == cpf - 1) {
      const float2* res = a;
      if constexpr (Body == kBodyFx) {
        float2* from = a;
        float2* to = b;
        for (int s = 0; s < p.log2n; ++s) {
          stockham_stage(from, to, p.tw, p.n, p.log2n, s, tid, kThreads);
          __syncthreads();
          float2* tmp = from;
          from = to;
          to = tmp;
        }
        res = from;
      }
#pragma unroll
      for (int j = 0; j < kMaxOwn; ++j) {
        const int bin = tid + j * kThreads;
        if (bin < p.n) acc[j] = cadd(acc[j], res[bin]);
      }
    }
    __syncthreads();  // the slot and the work buffers are free again
    if (p.copy && p.nbuf == 1 && next) fetch(g + 1, 0);
  }

  float2* out = p.out + static_cast<size_t>(blockIdx.x) * p.n;
#pragma unroll
  for (int j = 0; j < kMaxOwn; ++j) {
    const int bin = tid + j * kThreads;
    if (bin < p.n) {
      if constexpr (Body == kBodyTouch) {
        out[bin] = j == 0 ? touch : make_float2(0.f, 0.f);
      } else {
        out[bin] = acc[j];
      }
    }
  }
}

template <int Body, int Mech>
cudaError_t launch_overlap(const OverlapArgs& p, int grid, int smem,
                           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&overlap_probe_kernel<Body, Mech>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  overlap_probe_kernel<Body, Mech><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int Body>
cudaError_t launch_overlap_mech(int mech, const OverlapArgs& p, int grid,
                                int smem, cudaStream_t st) {
  if (mech == kCpAsync) return launch_overlap<Body, kCpAsync>(p, grid, smem, st);
  if (mech == kBulk) return launch_overlap<Body, kBulk>(p, grid, smem, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// fxt_retile_probe.  One frame's FIR output, kRetileBins floats, is the
// [n1, n2] = [32, 128] matrix of a four-step FFT's first stage; thread i2
// of a 128-thread CTA owns column i2 and runs the same body on it in every
// leg: acc[k] += sum_j m[k, j] * bf16(x[j, i2]) (m a [32, 32] matrix of
// bf16 values, sums in f32).  The legs differ in how the column reaches
// the thread's registers:
//   kControl       it arrives pre-tiled in device memory, [n2, n1]: eight
//                  16-byte loads of the thread's own 128 bytes;
//   kTranspose     coalesced loads of the [n1, n2] frame, stored to shared
//                  memory as [n2][n1] (every thread on one bank) and read
//                  back from there;
//   kTransposePad  the same with rows padded to n1 + 1 floats (no two
//                  threads on one bank);
//   kGather        each thread loads its 32 elements, 512 bytes apart,
//                  itself: coalesced across the warp, no shared memory.
// All four write the same checksum, out[b, k, i2] = acc[k] (summed over the
// CTAs by the caller).  kStockham instead runs the frame kernel's radix-2
// Stockham stages (stockham_stage: b[d], b[d + ns]) over the frame taken
// as 2048 complex points and folds the result into the same [32, 128]
// floats: out[b, 2 j, i2], out[b, 2 j + 1, i2] = the sum over frames of
// point i2 + 128 j.
// CTA b takes frame slots b, b + gridDim.x, ... of nt x reps; slot g reads
// source frame g % nsrc.
enum : int {
  kControl = 0,
  kTranspose,
  kTransposePad,
  kGather,
  kStockham
};
constexpr int kN1 = 32, kN2 = 128;
constexpr int kRetileBins = kN1 * kN2;
constexpr int kRetileThreads = kN2;

struct RetileArgs {
  const float* x;    // [nsrc, n1, n2]
  const float* xt;   // [nsrc, n2, n1]: the same values pre-tiled
  const float* m;    // [n1, n1]
  const float2* tw;  // kRetileBins / 4 twiddles of a 2048-point FFT
  float* out;        // [grid, n1, n2]
  int nsrc, nt, reps;
};

template <int Form>
__global__ void __launch_bounds__(kRetileThreads)
retile_probe_kernel(RetileArgs p) {
  extern __shared__ __align__(16) float sm[];
  float* ms = sm;              // [n1][n1]
  float* stage = sm + kN1 * kN1;
  const int tid = threadIdx.x;
  for (int i = tid; i < kN1 * kN1; i += kRetileThreads) ms[i] = p.m[i];
  __syncthreads();
  float acc[kN1];
#pragma unroll
  for (int k = 0; k < kN1; ++k) acc[k] = 0.f;
  const int total = p.nt * p.reps;
  for (int g = blockIdx.x; g < total; g += gridDim.x) {
    const size_t fr = static_cast<size_t>(g % p.nsrc) * kRetileBins;
    if constexpr (Form == kStockham) {
      constexpr int nc = kRetileBins / 2, lg = 11;  // 2048 points
      float2* a = reinterpret_cast<float2*>(stage);
      float2* b = a + nc;
      const float2* src = reinterpret_cast<const float2*>(p.x + fr);
      for (int j = tid; j < nc; j += kRetileThreads) a[j] = __ldg(src + j);
      __syncthreads();
      for (int s = 0; s < lg; ++s) {
        stockham_stage(a, b, p.tw, nc, lg, s, tid, kRetileThreads);
        __syncthreads();
        float2* tmp = a;
        a = b;
        b = tmp;
      }
#pragma unroll
      for (int j = 0; j < kN1 / 2; ++j) {
        const float2 v = a[tid + j * kRetileThreads];
        acc[2 * j] += v.x;
        acc[2 * j + 1] += v.y;
      }
      __syncthreads();  // the next frame overwrites both buffers
    } else {
      float v[kN1];
      if constexpr (Form == kControl) {
        const float4* src =
            reinterpret_cast<const float4*>(p.xt + fr + tid * kN1);
#pragma unroll
        for (int q = 0; q < kN1 / 4; ++q) {
          const float4 u = __ldg(src + q);
          v[4 * q] = u.x;
          v[4 * q + 1] = u.y;
          v[4 * q + 2] = u.z;
          v[4 * q + 3] = u.w;
        }
      } else if constexpr (Form == kGather) {
        const float* src = p.x + fr + tid;
#pragma unroll
        for (int j = 0; j < kN1; ++j) v[j] = __ldg(src + j * kN2);
      } else {
        constexpr int pitch = Form == kTransposePad ? kN1 + 1 : kN1;
        const float* src = p.x + fr + tid;
#pragma unroll
        for (int j = 0; j < kN1; ++j) {
          stage[tid * pitch + j] = __ldg(src + j * kN2);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kN1; ++j) v[j] = stage[tid * pitch + j];
        __syncthreads();  // the next frame overwrites `stage`
      }
#pragma unroll
      for (int j = 0; j < kN1; ++j) {
        v[j] = __bfloat162float(__float2bfloat16_rn(v[j]));
      }
#pragma unroll
      for (int k = 0; k < kN1; ++k) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kN1; ++j) s += ms[k * kN1 + j] * v[j];
        acc[k] += s;
      }
    }
  }
  float* out = p.out + static_cast<size_t>(blockIdx.x) * kRetileBins;
#pragma unroll
  for (int k = 0; k < kN1; ++k) out[k * kN2 + tid] = acc[k];
}

template <int Form>
cudaError_t launch_retile(const RetileArgs& p, int grid, int smem,
                          cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&retile_probe_kernel<Form>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  retile_probe_kernel<Form><<<grid, kRetileThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The copy probe on `stream`.  The caller (probes/copy_rate.py) has
// checked that every stride, the width and both addresses are multiples of
// 16, that width is a power of two, that nch * rows * width <= smem <= 227
// KB and that out holds ntiles uint32.  mech 0: loads of `vec` bytes (2, 8
// or 16) a thread through registers; 1: 16-byte cp.async; 2: bulk copies,
// one per run.  Returns cudaGetLastError().
extern "C" int fxt_copy_probe(const void* src, void* out,
                              long long blk_stride, long long tile_stride,
                              long long chan_stride, long long row_stride,
                              int ntiles, int tpb, int nch, int rows,
                              int width, int dst_chan_stride,
                              int dst_row_stride, int reps, int mech, int vec,
                              int grid, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const CopyArgs p{static_cast<const unsigned char*>(src),
                   static_cast<unsigned int*>(out),
                   blk_stride,
                   tile_stride,
                   chan_stride,
                   row_stride,
                   ntiles,
                   tpb,
                   nch,
                   rows,
                   width,
                   dst_chan_stride,
                   dst_row_stride,
                   reps};
  cudaError_t err = cudaErrorInvalidValue;
  if (mech == kLdg && vec == 2) {
    err = launch_copy<kLdg, unsigned short>(p, grid, smem, st);
  } else if (mech == kLdg && vec == 8) {
    err = launch_copy<kLdg, uint2>(p, grid, smem, st);
  } else if (mech == kLdg && vec == 16) {
    err = launch_copy<kLdg, uint4>(p, grid, smem, st);
  } else if (mech == kCpAsync) {
    err = launch_copy<kCpAsync, uint4>(p, grid, smem, st);
  } else if (mech == kBulk) {
    err = launch_copy<kBulk, uint4>(p, grid, smem, st);
  }
  return static_cast<int>(err);
}

// The overlap probe on `stream`.  The caller (probes/overlap.py) has
// checked that n is a power of two <= 8192, cb a multiple of 256 dividing
// n, 2 <= ntaps, nbuf a power of two <= min(8, n / cb), that src holds grid *
// frames + ntaps - 1 rows, out [grid, n] and tw n / 2 twiddles, and that
// smem >= (nbuf ntaps cb + 2 n) * 8.  body 0 touch, 1 fma, 2 fx; mech 1
// cp.async, 2 bulk.  Returns cudaGetLastError().
extern "C" int fxt_overlap_probe(const void* src, void* out, const void* tw,
                                 int n, int log2n, int cb, int ntaps,
                                 int frames, int reps, int nbuf, int copy,
                                 int passes, int body, int mech, int grid,
                                 int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const OverlapArgs p{static_cast<const float2*>(src),
                      static_cast<float2*>(out),
                      static_cast<const float2*>(tw),
                      n,
                      log2n,
                      cb,
                      ntaps,
                      frames,
                      reps,
                      nbuf,
                      copy,
                      passes};
  cudaError_t err = cudaErrorInvalidValue;
  if (body == kBodyTouch) {
    err = launch_overlap_mech<kBodyTouch>(mech, p, grid, smem, st);
  } else if (body == kBodyFma) {
    err = launch_overlap_mech<kBodyFma>(mech, p, grid, smem, st);
  } else if (body == kBodyFx) {
    err = launch_overlap_mech<kBodyFx>(mech, p, grid, smem, st);
  }
  return static_cast<int>(err);
}

// The retile probe on `stream`: x [nsrc, 32, 128] f32, xt the same values
// as [nsrc, 128, 32], m [32, 32] f32, tw 1024 twiddles of a 2048-point
// FFT, out [grid, 32, 128] f32.  form 0 control, 1 transpose, 2
// transpose_pad, 3 gather, 4 stockham.  Returns cudaGetLastError().
extern "C" int fxt_retile_probe(const void* x, const void* xt, const void* m,
                                const void* tw, void* out, int nsrc, int nt,
                                int reps, int form, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RetileArgs p{static_cast<const float*>(x),
                     static_cast<const float*>(xt),
                     static_cast<const float*>(m),
                     static_cast<const float2*>(tw),
                     static_cast<float*>(out),
                     nsrc,
                     nt,
                     reps};
  // m, and the larger of the padded staging matrix and two 2048-point
  // buffers
  const int smem = kN1 * kN1 * 4 + kRetileBins * 8;
  switch (form) {
    case kControl:
      return static_cast<int>(launch_retile<kControl>(p, grid, smem, st));
    case kTranspose:
      return static_cast<int>(launch_retile<kTranspose>(p, grid, smem, st));
    case kTransposePad:
      return static_cast<int>(
          launch_retile<kTransposePad>(p, grid, smem, st));
    case kGather:
      return static_cast<int>(launch_retile<kGather>(p, grid, smem, st));
    case kStockham:
      return static_cast<int>(launch_retile<kStockham>(p, grid, smem, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
