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
// fxt_overlap_probe's legs are bounded by the larger of the copy (each row
// once over 3.35 TB/s) and the body (the frame kernel's FIR and radix-16
// FFT: shared-memory traffic and barriers, not flops); copies keep rows in
// flight and two teams of consumers keep two frames' FFTs in flight an SM,
// and the probe reports which of sum(copy, body) and max(copy, body)
// a leg reaches.  fxt_retile_probe reads 16 KB per frame slot from L2 and
// forms 2 n1 n products per slot on the tensor cores: bound by bytes at
// 3.35 TB/s once per repeat, in practice by the L2's rate, as every slot
// reads its frame again; its layout legs differ in how the frame reaches
// the mma's operand registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fx_common.cuh"   // cadd, csub, cp_async16, cp_async_commit, cp_async_wait
#include "fx_fft.cuh"      // cmul, fft_run, fft_pass_count: the frame kernel's FFT

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

// One radix-2 Stockham stage of the frame kernel's FFT before its radix-16
// redesign, with its own indexing: a -> b over n points, stage s (ns = 1 <<
// s).  The retile probe's stockham leg times it.
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
// complex64 array; frame f reads rows b frames + f .. + ntaps - 1 (as the
// frame kernel's FIR does); the walk over the CTA's frames is repeated
// `reps` times.  A CTA is one or two consumer teams of 256 threads, which
// run the body on the walk's frames in turn (team k takes frames k, k +
// teams, ...), and a producer warp.  Rows are copied from device memory
// into a ring of slots in shared memory; copy g of the walk goes to slot g
// mod S once the team that read the slot's previous copy last has
// released it.  Who issues a copy is the mechanism's: under bulk the
// producer warp (a lane starts a run's copy engine transfer), waiting on
// the slot's `empty` mbarrier, which the releasing team arrives on; under
// cp.async, whose copies are 16 bytes a thread, the releasing team itself,
// its 256 threads, as it releases the slot (team 0 the first S copies), and
// the producer warp idles.  A slot's `full` mbarrier completes when its copy
// has landed (the bulk copies' bytes, or the issuing team's 256 cp.async
// arrivals).  Every thread counts the bytes its copies asked for, and the
// CTA adds them to g_overlap_copied (read by fxt_overlap_copied).
// Two layouts (overlap_layout, exported as fxt_overlap_layout;
// probes/overlap.py's layout mirrors it and the card tests hold the two
// together):
//   rows once  a slot is a whole row, copied once a walk: frame f + 1 needs
//              one new row.  ntaps + teams + nbuf - 2 slots: each team's
//              frame's rows (ntaps + teams - 1 together) and nbuf - 1 rows
//              in flight beyond them.  A frame's FIR is written over its
//              first row, which no later frame reads, and its FFT runs
//              there in place.  With two teams, team k writes over row f
//              or frees a slot only after the other team's frame f - 1
//              has waited on and read its rows (named barrier 3 + k).
//              Without the copy, the first frame's rows
//              stay in slots 0 .. ntaps - 1 and team k's FIR goes to slot
//              ntaps + k.
//   chunked    where the rows do not fit: chunk (f, q) is the ntaps runs
//              of cb bins q cb .. of frame f's rows, so each row is copied
//              ntaps times; nbuf chunk slots, a work slot of n bins for the
//              FIR's output and the FFT, one team.
// copy = 1, nbuf = 1 (serial): a slot is reused only when the body that
//   read it has finished, so the frame's new row (chunk) is asked for after
//   the body before it and waited for; with two CTAs on an SM the
//   scheduler overlaps them (occupancy);
// copy = 1, nbuf > 1 (pipelined): nbuf - 1 rows (chunks) in flight while
//   the body runs, and two teams where the rows fit;
// copy = 0: the first frame's rows are copied once (chunk q of a row being
//   its chunk q mod nbuf) and the body runs on them again and again (the
//   body alone).
// Bodies: kBodyTouch adds, for each chunk q, the frame's first row at bin
// q cb + tid (the copy alone); kBodyFma runs `passes` multiply-add passes
// on the frame's first two rows, the first through shared memory (a load
// and a store of it every pass), the second in registers; kBodyFx is the
// frame kernel's body: the FIR over the ntaps rows with taps 0.25 + 0.01 t,
// then the frame kernel's radix-16 FFT (fx_fft.cuh) in place, its twiddle
// table staged in shared memory once a CTA.  out[b, :] is the sum over the
// CTA's frames of the body's n values (kBodyTouch: its 256).
enum : int { kBodyTouch = 0, kBodyFma = 1, kBodyFx = 2 };
constexpr int kTeam = 256;      // threads of a consumer team (one FFT's)
constexpr int kMaxSlots = 32;   // slots of the ring: its mbarrier pairs
constexpr int kBarBytes = 2 * kMaxSlots * 8;
constexpr int kMaxRing = 8;     // chunk slots of the chunked layout

struct OverlapArgs {
  const float2* src;
  float2* out;
  const float2* tw;
  int cb, ntaps, frames, reps, nbuf, copy, passes;
  int rows_once, teams, slots;  // the layout: slots allocated to the ring
};

// Whole-row slots of the rows-once ring: what a copying leg uses, or the
// first frame's rows and the teams' FIR slots without the copy.
int ring_rows(int ntaps, int nbuf, int teams) {
  return ntaps + teams - 1 + (nbuf > 1 ? nbuf - 1 : 1);
}

// Dynamic shared memory of a layout: the mbarriers, the ring (and the
// chunked layout's work slot), the n / 2 twiddles.
long long overlap_bytes(int n, int cb, int ntaps, int nbuf, int rows_once,
                        int teams) {
  const long long ring =
      rows_once ? static_cast<long long>(ring_rows(ntaps, nbuf, teams)) * n
                : static_cast<long long>(nbuf) * ntaps * cb + n;
  return kBarBytes + (ring + n / 2) * 8;
}

// The layout a CTA with `smem` bytes takes: rows once with two teams (nbuf
// > 1, n <= 4096: a thread's 16 bins and its FFT in registers beside its
// sums), rows once with one team, else chunked.  False if none fits.
bool overlap_layout(int n, int cb, int ntaps, int nbuf, int smem,
                    OverlapArgs* p) {
  const int cand[3][2] = {{1, 2}, {1, 1}, {0, 1}};
  for (const auto& c : cand) {
    if (c[1] == 2 && (nbuf < 2 || n > 4096)) continue;
    const int slots = c[0] ? ring_rows(ntaps, nbuf, c[1]) : nbuf;
    if (slots > kMaxSlots) continue;
    if (overlap_bytes(n, cb, ntaps, nbuf, c[0], c[1]) <= smem) {
      p->rows_once = c[0];
      p->teams = c[1];
      p->slots = slots;
      return true;
    }
  }
  return false;
}

// One arrival on `bar`.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have
// landed (counted against the barrier's arrivals: .noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Consumer team k: threads 256 k .. 256 k + 255, named barrier 1 + k (the
// FFT's passes take it as their Team).
struct ProbeTeam {
  __device__ static int tid() { return threadIdx.x & (kTeam - 1); }
  __device__ static void sync() { named_sync(1 + (threadIdx.x >> 8), kTeam); }
};

// Bytes the overlap probe's copies asked for, summed over every launch's
// CTAs until fxt_overlap_copied reads it and sets it to 0.
__device__ unsigned long long g_overlap_copied;

// Thread `lane` of `lanes` copies its share of `nruns` runs of `run_bytes`
// bytes (run i from src(i) to dst(i), 16-byte aligned) into one slot,
// completing on `bar`: under bulk a run a lane (lanes of one warp, whose
// lane 0 announces the bytes), under cp.async 16 bytes at a time, each of
// the `lanes` threads then arriving on `bar` once its copies have landed.
// Returns the 16-byte units this thread's copies asked for.
template <int Mech, class Src, class Dst>
__device__ __forceinline__ uint32_t fetch_runs(uint64_t* bar, int lane,
                                               int lanes, int nruns,
                                               int run_bytes, Src src,
                                               Dst dst) {
  uint32_t asked = 0;
  if constexpr (Mech == kBulk) {
    fence_proxy_async();  // the consumers' writes to the slot come first
    if (lane == 0) {
      mbar_expect_tx(bar, static_cast<uint32_t>(nruns * run_bytes));
    }
    __syncwarp();
    for (int i = lane; i < nruns; i += lanes) {
      bulk_copy(dst(i), src(i), static_cast<uint32_t>(run_bytes), bar);
      asked += run_bytes / 16;
    }
  } else {
    const int pieces = run_bytes / 16;
    for (int q = lane; q < nruns * pieces; q += lanes) {
      const int i = q / pieces, off = q - i * pieces;
      cp_async16(reinterpret_cast<uint4*>(dst(i)) + off,
                 reinterpret_cast<const uint4*>(src(i)) + off);
      ++asked;
    }
    cp_async_mbar_arrive(bar);
  }
  return asked;
}

// The ring slots a copying leg cycles through, and its copies a repeat.
__device__ __forceinline__ int walk_slots(const OverlapArgs& p) {
  return p.rows_once ? p.ntaps + p.teams + p.nbuf - 2 : p.nbuf;
}

__device__ __forceinline__ int walk_copies(const OverlapArgs& p, int n) {
  return p.rows_once ? p.frames + p.ntaps - 1 : p.frames * (n / p.cb);
}

// Copy g of a copying leg's walk into slot g mod walk_slots: the CTA's row
// h = g mod walk_copies in runs of cb bins (rows once), or chunk q of frame
// f, h = f n / cb + q, its ntaps runs (chunked).  Without the copy,
// resident slot g: the first frame's row g, its chunk q from chunk q mod
// nbuf (rows once), or chunk g of the first frame's rows (chunked).
template <int Mech>
__device__ __forceinline__ uint32_t overlap_fetch(const OverlapArgs& p, int n,
                                                  int g, uint64_t* full,
                                                  float2* ring, int lane,
                                                  int lanes) {
  const int T = p.ntaps, cb = p.cb, cpf = n / cb, nbuf = p.nbuf;
  const float2* src0 =
      p.src + static_cast<long long>(blockIdx.x) * p.frames * n;
  if (!p.copy) {
    if (p.rows_once) {
      const float2* s = src0 + static_cast<size_t>(g) * n;
      float2* d = ring + static_cast<size_t>(g) * n;
      return fetch_runs<Mech>(
          &full[g], lane, lanes, cpf, cb * 8,
          [=](int q) { return s + (q % nbuf) * cb; },
          [=](int q) { return d + q * cb; });
    }
    float2* d = ring + static_cast<size_t>(g) * T * cb;
    return fetch_runs<Mech>(
        &full[g], lane, lanes, T, cb * 8,
        [=](int t) { return src0 + static_cast<size_t>(t) * n + g * cb; },
        [=](int t) { return d + t * cb; });
  }
  const int slot = g % walk_slots(p), h = g % walk_copies(p, n);
  if (p.rows_once) {
    const float2* s = src0 + static_cast<size_t>(h) * n;
    float2* d = ring + static_cast<size_t>(slot) * n;
    return fetch_runs<Mech>(
        &full[slot], lane, lanes, cpf, cb * 8,
        [=](int q) { return s + q * cb; }, [=](int q) { return d + q * cb; });
  }
  const int f = h / cpf, q = h - f * cpf;
  const float2* s = src0 + static_cast<size_t>(f) * n + q * cb;
  float2* d = ring + static_cast<size_t>(slot) * T * cb;
  return fetch_runs<Mech>(
      &full[slot], lane, lanes, T, cb * 8,
      [=](int t) { return s + static_cast<size_t>(t) * n; },
      [=](int t) { return d + t * cb; });
}

// The producer warp under bulk: every copy of the walk in order, each into
// its slot once the slot's last reader has released it (without the copy,
// the resident slots).  Returns its lane's 16-byte units.
__device__ uint32_t overlap_produce(const OverlapArgs& p, int n,
                                    uint64_t* full, uint64_t* empty,
                                    float2* ring) {
  const int lane = threadIdx.x & 31;
  uint32_t asked = 0;
  if (!p.copy) {
    const int resident = p.rows_once ? p.ntaps : p.nbuf;
    for (int i = 0; i < resident; ++i) {
      asked += overlap_fetch<kBulk>(p, n, i, full, ring, lane, 32);
    }
    return asked;
  }
  const int S = walk_slots(p), total = p.reps * walk_copies(p, n);
  for (int g = 0; g < total; ++g) {
    if (g >= S) mbar_wait(&empty[g % S], (g / S - 1) & 1);
    asked += overlap_fetch<kBulk>(p, n, g, full, ring, lane, 32);
  }
  return asked;
}

// The multiply-add passes of bin b: x through shared memory at xs[b] (a
// load and a store each pass), y in registers.
__device__ __forceinline__ float2 fma_passes(float2* xs, int b, float2 x,
                                             float2 y, int passes) {
  volatile float* vx = reinterpret_cast<volatile float*>(xs);
  vx[2 * b] = x.x;
  vx[2 * b + 1] = x.y;
  for (int k = 0; k < passes; ++k) {
    float xr = vx[2 * b], xi = vx[2 * b + 1];
    xr = xr * 1.0000001f + y.x;
    xi = xi * 1.0000001f + y.y;
    y.x = y.x * 0.9999999f + xr;
    y.y = y.y * 0.9999999f + xi;
    vx[2 * b] = xr;
    vx[2 * b + 1] = xi;
  }
  return make_float2(vx[2 * b], vx[2 * b + 1]);
}

// At most two teams and the producer, 17 warps under either mechanism:
// five share one of the SM's four register files, so a thread holds 96
// registers (and the fx body spills at 4096 bins), and two CTAs of one team
// fit an SM (occupancy).  A CTA of 16 warps, every mechanism's copies
// started by the team that frees a slot, holds 128 without spills; the body
// moved 2%, the bulk legs took up to 1.4 times as long (PERF.md), and it
// was dropped.  At 8192 bins one team (a thread's 32 bins and 32 points of
// the FFT's last pass).
__host__ __device__ constexpr int overlap_threads(int log2n) {
  return (log2n <= 12 ? 2 : 1) * kTeam + 32;
}

template <int Body, int Mech, int kLog>
__global__ void __launch_bounds__(overlap_threads(kLog), 1)
    overlap_probe_kernel(OverlapArgs p) {
  constexpr int n = 1 << kLog;
  constexpr int kOwn = n / kTeam;  // a consumer's bins: tid + 256 j
  extern __shared__ __align__(128) unsigned char ov_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ov_smem);
  uint64_t* empty = full + kMaxSlots;
  float2* ring = reinterpret_cast<float2*>(ov_smem + kBarBytes);
  const int T = p.ntaps, cb = p.cb, cpf = n / cb;
  // the chunked layout's work slot; the twiddles after the ring
  float2* work = ring + static_cast<size_t>(p.nbuf) * T * cb;
  float2* tw_s = p.rows_once ? ring + static_cast<size_t>(p.slots) * n
                             : work + n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(&full[s], Mech == kBulk ? 1 : kTeam);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  if constexpr (Body == kBodyFx) {
    for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
      tw_s[i] = __ldg(p.tw + i);
    }
  }
  __syncthreads();

  const int team = threadIdx.x >> 8, tid = threadIdx.x & (kTeam - 1);
  float2 acc[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) acc[j] = make_float2(0.f, 0.f);
  float2 touch = make_float2(0.f, 0.f);
  uint32_t asked = 0;  // 16-byte units this thread's copies asked for
  const int S = walk_slots(p), total = p.reps * walk_copies(p, n);
  // the team is done with copy g's slot: the producer may reuse it (bulk),
  // or the team copies the slot's next row or chunk into it (cp.async)
  auto release = [&](int g) {
    if constexpr (Mech == kBulk) {
      if (tid == 0) mbar_arrive(&empty[g % S]);
    } else if (g + S < total) {
      asked += overlap_fetch<Mech>(p, n, g + S, full, ring, tid, kTeam);
    }
  };
  if constexpr (Mech == kCpAsync) {  // team 0 fills the ring
    if (team == 0) {
      const int first = p.copy ? min(S, total) : p.rows_once ? T : p.nbuf;
      for (int g = 0; g < first; ++g) {
        asked += overlap_fetch<Mech>(p, n, g, full, ring, tid, kTeam);
      }
    }
  }

  if (team >= p.teams) {
    if constexpr (Mech == kBulk) {
      asked = overlap_produce(p, n, full, empty, ring);
    }
  } else if (p.rows_once) {
    const int U = p.reps * p.frames;
    const int per_rep = walk_copies(p, n);
    for (int u = team; u < U; u += p.teams) {
      const int f = u % p.frames;
      const int g0 = (u / p.frames) * per_rep + f;  // the frame's first copy
      auto row = [&](int t) {
        return ring + static_cast<size_t>(p.copy ? (g0 + t) % S : t) * n;
      };
      for (int t = 0; t < T; ++t) {
        if (p.copy) {
          mbar_wait(&full[(g0 + t) % S], ((g0 + t) / S) & 1);
        } else {
          mbar_wait(&full[t], 0);
        }
      }
      // where the body's n values go: over the first row, or the team's slot
      float2* own = p.copy ? row(0) : ring + static_cast<size_t>(T + team) * n;
      float2 v[kOwn];  // the FIR's output, or the second row (fma)
      if constexpr (Body == kBodyTouch) {
        const float2* r0 = row(0);
        for (int q = 0; q < cpf; ++q) touch = cadd(touch, r0[q * cb + tid]);
      } else if constexpr (Body == kBodyFx) {
#pragma unroll
        for (int j = 0; j < kOwn; ++j) v[j] = make_float2(0.f, 0.f);
        for (int t = 0; t < T; ++t) {
          const float w = 0.25f + 0.01f * t;
          const float2* r = row(t);
#pragma unroll
          for (int j = 0; j < kOwn; ++j) {
            const float2 x = r[tid + j * kTeam];
            v[j].x += w * x.x;
            v[j].y += w * x.y;
          }
        }
      } else {
        const float2* r1 = row(1);
#pragma unroll
        for (int j = 0; j < kOwn; ++j) v[j] = r1[tid + j * kTeam];
      }
      // frame u - 1 of the other team has waited on and read its rows
      // before this frame writes over row u or frees a slot (whatever the
      // body: a slot refilled before a frame's wait on it would complete
      // the mbarrier's next phase, which that wait, by parity, cannot tell
      // from the one it waits for)
      if (p.copy && p.teams == 2) {
        if (u > 0) named_sync(3 + team, 2 * kTeam);
        if (u + 1 < U) named_arrive(4 - team, 2 * kTeam);
      }
      if constexpr (Body == kBodyFx) {
#pragma unroll
        for (int j = 0; j < kOwn; ++j) own[tid + j * kTeam] = v[j];
        ProbeTeam::sync();
        fft_run<kLog, ProbeTeam>(own, tw_s, fft_pass_count(kLog));
#pragma unroll
        for (int j = 0; j < kOwn; ++j) {
          acc[j] = cadd(acc[j], own[tid + j * kTeam]);
        }
      } else if constexpr (Body == kBodyFma) {
        const float2* r0 = row(0);
#pragma unroll
        for (int j = 0; j < kOwn; ++j) {
          const int b = tid + j * kTeam;
          acc[j] = cadd(acc[j], fma_passes(own, b, r0[b], v[j], p.passes));
        }
      }
      ProbeTeam::sync();  // the team is done with the frame's rows
      if (p.copy) {
        // the first row, and after the walk's last frame its other rows
        release(g0);
        if (f == p.frames - 1) {
          for (int t = 1; t < T; ++t) release(g0 + t);
        }
      }
    }
  } else {  // chunked, one team
    const int U = p.reps * p.frames;
    for (int u = 0; u < U; ++u) {
      for (int q = 0; q < cpf; ++q) {
        const int g = u * cpf + q;
        const int slot = p.copy ? g % p.nbuf : q % p.nbuf;
        mbar_wait(&full[slot], p.copy ? (g / p.nbuf) & 1 : 0);
        const float2* chunk = ring + static_cast<size_t>(slot) * T * cb;
        if constexpr (Body == kBodyTouch) {
          touch = cadd(touch, chunk[tid]);
        } else {
          for (int e = tid; e < cb; e += kTeam) {
            if constexpr (Body == kBodyFx) {
              float2 s = make_float2(0.f, 0.f);
              for (int t = 0; t < T; ++t) {
                const float w = 0.25f + 0.01f * t;
                const float2 x = chunk[t * cb + e];
                s.x += w * x.x;
                s.y += w * x.y;
              }
              work[q * cb + e] = s;
            } else {
              fma_passes(work, q * cb + e, chunk[e], chunk[cb + e], p.passes);
            }
          }
        }
        if (p.copy && q + 1 < cpf) {
          ProbeTeam::sync();
          release(g);
        }
      }
      if constexpr (Body != kBodyTouch) {
        ProbeTeam::sync();
        if constexpr (Body == kBodyFx) {
          fft_run<kLog, ProbeTeam>(work, tw_s, fft_pass_count(kLog));
        }
#pragma unroll
        for (int j = 0; j < kOwn; ++j) {
          acc[j] = cadd(acc[j], work[tid + j * kTeam]);
        }
      }
      ProbeTeam::sync();  // the frame's last chunk and the work slot are free
      if (p.copy) release(u * cpf + cpf - 1);
    }
  }

  __syncthreads();  // every team and the producer: the ring is free
  float2* red = ring;
  if (p.teams == 2 && team == 1) {
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      red[tid + j * kTeam] =
          Body == kBodyTouch
              ? (j == 0 ? touch : make_float2(0.f, 0.f))
              : acc[j];
    }
  }
  __syncthreads();
  if (team == 0) {
    float2* out = p.out + static_cast<size_t>(blockIdx.x) * n;
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int b = tid + j * kTeam;
      float2 v = Body == kBodyTouch
                     ? (j == 0 ? touch : make_float2(0.f, 0.f))
                     : acc[j];
      if (p.teams == 2) v = cadd(v, red[b]);
      out[b] = v;
    }
  }
  // the bytes the CTA's copies asked for, summed a warp at a time
  const uint32_t units = __reduce_add_sync(0xffffffffu, asked);
  if ((threadIdx.x & 31) == 0 && units) {
    atomicAdd(&g_overlap_copied, 16ull * units);
  }
}

template <int Body, int Mech, int kLog>
cudaError_t launch_overlap(const OverlapArgs& p, int grid, int smem,
                           cudaStream_t st) {
  auto* kern = &overlap_probe_kernel<Body, Mech, kLog>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, p.teams * kTeam + 32, smem, st>>>(p);
  return cudaGetLastError();
}

template <int Body, int Mech>
cudaError_t launch_overlap_n(int log2n, const OverlapArgs& p, int grid,
                             int smem, cudaStream_t st) {
  switch (log2n) {
    case 8: return launch_overlap<Body, Mech, 8>(p, grid, smem, st);
    case 9: return launch_overlap<Body, Mech, 9>(p, grid, smem, st);
    case 10: return launch_overlap<Body, Mech, 10>(p, grid, smem, st);
    case 11: return launch_overlap<Body, Mech, 11>(p, grid, smem, st);
    case 12: return launch_overlap<Body, Mech, 12>(p, grid, smem, st);
    case 13: return launch_overlap<Body, Mech, 13>(p, grid, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int Body>
cudaError_t launch_overlap_mech(int mech, int log2n, const OverlapArgs& p,
                                int grid, int smem, cudaStream_t st) {
  if (mech == kCpAsync) {
    return launch_overlap_n<Body, kCpAsync>(log2n, p, grid, smem, st);
  }
  if (mech == kBulk) {
    return launch_overlap_n<Body, kBulk>(log2n, p, grid, smem, st);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// fxt_retile_probe.  One frame's FIR output, kRetileBins floats, is the
// [n1, n2] = [32, 128] matrix x2 of a four-step FFT's first stage.  Every
// frame slot's product m @ bf16(x2) (m a [32, 32] matrix of bf16 values)
// runs on the tensor cores, as the TPU script's dot runs on the MXU:
// mma.m16n8k16 with bf16 operands and float32 sums.  A CTA is 4 warps; warp
// w forms columns 32 w .. 32 w + 31 of every slot's product: 2 x 4 tiles of
// 16 x 8 (M x N), each over 2 steps of 16 (K), 16 mma a slot.  m's
// fragments (A) are loaded once; the sums stay in registers across the
// CTA's slots, each slot's tile formed from zero and added in float32 (so
// the sum over slots rounds as float32 additions do).  x2 is rounded to
// bf16 (to nearest even) where a fragment is formed.  In K step kk, a
// fragment's row k and column n of tile t are x2's row j and column i2 by
// the form's index arithmetic (retile.fragment_checksum mirrors it):
//   control, gather    j = 16 kk + 4 ((k mod 8) / 2) + 2 (k / 8) + k mod 2,
//                      i2 = 32 w + 4 n + t: a thread's four values of one
//                      K step and tile are one float4 in either layout;
//   transpose(_pad)    j = 16 kk + k, i2 = 32 w + 8 t + n: ldmatrix's rows.
// The legs differ in how the frame reaches the B fragments:
//   kControl       pre-tiled in device memory, [n2, n1]: a thread's x2 rows
//                  16 kk + 4 c .. + 3 at one column are one float4 load;
//   kGather        the [n1, n2] frame loaded from device memory straight
//                  into fragments, no shared memory: one float4 a row j,
//                  columns 32 w + 4 r .. + 3 (r = lane / 4);
//   kTranspose     coalesced float4 loads of the warp's 32 x 32 block, stored
//                  to shared memory as bf16 [i2][j] in rows of 32 (64
//                  bytes), then ldmatrix: 8-way conflicts on the stores,
//                  4-way on ldmatrix;
//   kTransposePad  the same with rows of 40 (80 bytes): 4-way on the
//                  stores, ldmatrix's eight rows on eight bank groups.
// Every slot's frame is loaded from L2 (ld.global.cg: no L1 reuse when a
// CTA meets a source frame again) and every slot's products are formed:
// out[b, k, i2] = the CTA's sum (summed over the CTAs by the caller).
// kStockham instead runs radix-2 Stockham stages (stockham_stage: b[d],
// b[d + ns]) over the frame taken as 2048 complex points and folds the
// result into the same [32, 128] floats: out[b, 2 j, i2], out[b, 2 j + 1,
// i2] = the sum over frames of point i2 + 128 j.
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
constexpr int kRetileThreads = 128;
constexpr int kRetileWarps = kRetileThreads / 32;
static_assert(kN2 == 32 * kRetileWarps, "a warp forms 32 columns");

// bf16 elements in a row of a warp's staged [32][32] block.
__host__ __device__ constexpr int stage_pitch(int form) {
  return form == kTransposePad ? kN1 + 8 : kN1;
}

struct RetileArgs {
  const float* x;    // [nsrc, n1, n2]
  const float* xt;   // [nsrc, n2, n1]: the same values pre-tiled
  const float* m;    // [n1, n1]
  const float2* tw;  // kRetileBins / 4 twiddles of a 2048-point FFT
  float* out;        // [grid, n1, n2]
  int nsrc, nt, reps;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// d += a b over one 16 x 8 x 16 tile (a row-major, b column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

template <int Form>
__global__ void __launch_bounds__(kRetileThreads, 4)
    retile_mma_kernel(RetileArgs p) {
  extern __shared__ __align__(16) unsigned char rt_smem[];
  constexpr bool kPerm = Form == kControl || Form == kGather;
  constexpr int P = stage_pitch(Form);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, c = lane & 3;  // fragment row / column group
  const int nbase = 32 * warp;
  // x2's row (in a K step) of a fragment's k
  auto kj = [](int k) {
    return kPerm ? 4 * ((k & 7) >> 1) + 2 * (k >> 3) + (k & 1) : k;
  };
  uint32_t a[2][2][4];  // m's fragments: [M tile][K step][register]
#pragma unroll
  for (int mu = 0; mu < 2; ++mu) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* m0 = p.m + (16 * mu + r) * kN1 + 16 * kk;
      const float* m1 = m0 + 8 * kN1;
      a[mu][kk][0] = pack_bf16(m0[kj(2 * c)], m0[kj(2 * c + 1)]);
      a[mu][kk][1] = pack_bf16(m1[kj(2 * c)], m1[kj(2 * c + 1)]);
      a[mu][kk][2] = pack_bf16(m0[kj(2 * c + 8)], m0[kj(2 * c + 9)]);
      a[mu][kk][3] = pack_bf16(m1[kj(2 * c + 8)], m1[kj(2 * c + 9)]);
    }
  }
  float acc[2][4][4];  // [M tile][N tile][accumulator]
#pragma unroll
  for (int mu = 0; mu < 2; ++mu) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mu][t][e] = 0.f;
    }
  }
  // the warp's staged block (transposes): bf16 [i2 - nbase][j], pitch P
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(rt_smem) + warp * 32 * P;
  float4 ld[8];  // one slot's loads
  auto load = [&](int g) {
    const float* fr = (Form == kControl ? p.xt : p.x) +
                      static_cast<size_t>(g % p.nsrc) * kRetileBins;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* s;
      if constexpr (Form == kGather) {  // row 16 kk + 4 c + j4, 4 columns
        const int kk = i >> 2, j4 = i & 3;
        s = fr + (16 * kk + 4 * c + j4) * kN2 + nbase + 4 * r;
      } else if constexpr (Form == kControl) {  // column 4 r + t, 4 rows
        const int kk = i >> 2, t = i & 3;
        s = fr + (nbase + 4 * r + t) * kN1 + 16 * kk + 4 * c;
      } else {  // row 2 rp + (i & 1), rp = lane / 8 + 4 (i / 2)
        const int row = 2 * ((lane >> 3) + 4 * (i >> 1)) + (i & 1);
        s = fr + row * kN2 + nbase + 4 * (lane & 7);
      }
      ld[i] = __ldcg(reinterpret_cast<const float4*>(s));
    }
  };
  uint32_t b[2][4][2];  // the slot's fragments: [K step][N tile][register]
  auto fragments = [&]() {
    if constexpr (Form == kGather) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          b[kk][t][0] = pack_bf16(elem(ld[4 * kk], t), elem(ld[4 * kk + 1], t));
          b[kk][t][1] =
              pack_bf16(elem(ld[4 * kk + 2], t), elem(ld[4 * kk + 3], t));
        }
      }
    } else if constexpr (Form == kControl) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 v = ld[4 * kk + t];
          b[kk][t][0] = pack_bf16(v.x, v.y);
          b[kk][t][1] = pack_bf16(v.z, v.w);
        }
      }
    } else {
      uint32_t* words = reinterpret_cast<uint32_t*>(stage);
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows 2 rp, 2 rp + 1 as bf16 pairs
        const int rp = (lane >> 3) + 4 * i, q = lane & 7;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          words[(4 * q + e) * (P / 2) + rp] =
              pack_bf16(elem(ld[2 * i], e), elem(ld[2 * i + 1], e));
        }
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 4; ++t) {  // matrix mi: rows 8 t .., j 8 mi ..
        uint32_t m4[4];
        ldmatrix_x4(m4, stage + (8 * t + (lane & 7)) * P + 8 * (lane >> 3));
        b[0][t][0] = m4[0];
        b[0][t][1] = m4[1];
        b[1][t][0] = m4[2];
        b[1][t][1] = m4[3];
      }
      __syncwarp();  // the next slot's stores overwrite the stage
    }
  };
  const int total = p.nt * p.reps;
  int g = blockIdx.x;
  if (g < total) load(g);
  for (; g < total; g += gridDim.x) {
    fragments();
    if (g + static_cast<int>(gridDim.x) < total) load(g + gridDim.x);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int mu = 0; mu < 2; ++mu) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(d, a[mu][0], b[0][t][0], b[0][t][1]);
        mma_bf16(d, a[mu][1], b[1][t][0], b[1][t][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mu][t][e] += d[e];
      }
    }
  }
  float* out = p.out + static_cast<size_t>(blockIdx.x) * kRetileBins;
#pragma unroll
  for (int mu = 0; mu < 2; ++mu) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 2 * c + e;
        const int col = kPerm ? nbase + 4 * n + t : nbase + 8 * t + n;
        out[(16 * mu + r) * kN2 + col] = acc[mu][t][e];
        out[(16 * mu + r + 8) * kN2 + col] = acc[mu][t][2 + e];
      }
    }
  }
}

// The stockham leg: thread i2 of 128 owns points i2 + 128 j.
__global__ void __launch_bounds__(kRetileThreads)
    retile_stockham_kernel(RetileArgs p) {
  extern __shared__ __align__(16) unsigned char rt_smem[];
  constexpr int nc = kRetileBins / 2, lg = 11;  // 2048 points
  const int tid = threadIdx.x;
  float acc[kN1];
#pragma unroll
  for (int k = 0; k < kN1; ++k) acc[k] = 0.f;
  const int total = p.nt * p.reps;
  for (int g = blockIdx.x; g < total; g += gridDim.x) {
    float2* a = reinterpret_cast<float2*>(rt_smem);
    float2* b = a + nc;
    const float2* src = reinterpret_cast<const float2*>(
        p.x + static_cast<size_t>(g % p.nsrc) * kRetileBins);
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
  }
  float* out = p.out + static_cast<size_t>(blockIdx.x) * kRetileBins;
#pragma unroll
  for (int k = 0; k < kN1; ++k) out[k * kN2 + tid] = acc[k];
}

template <class Kernel>
cudaError_t launch_retile(Kernel* kern, const RetileArgs& p, int grid,
                          int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kRetileThreads, smem, st>>>(p);
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
// checked that n = 2^log2n in [256, 8192], cb a multiple of 256 dividing
// n, 2 <= ntaps, nbuf a power of two <= min(8, n / cb), that src holds grid
// * frames + ntaps - 1 rows, out [grid, n] and tw n / 2 twiddles, and that
// smem (at most 227 KB) holds a layout (overlap_layout: the same rule as
// overlap.layout).  body 0 touch, 1 fma, 2 fx; mech 1 cp.async, 2 bulk.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int fxt_overlap_probe(const void* src, void* out, const void* tw,
                                 int n, int log2n, int cb, int ntaps,
                                 int frames, int reps, int nbuf, int copy,
                                 int passes, int body, int mech, int grid,
                                 int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  OverlapArgs p{static_cast<const float2*>(src),
                static_cast<float2*>(out),
                static_cast<const float2*>(tw),
                cb,
                ntaps,
                frames,
                reps,
                nbuf,
                copy,
                passes,
                0,
                0,
                0};
  if (log2n < 8 || log2n > 13 || n != (1 << log2n) || cb < 256 ||
      cb % 256 != 0 || n % cb != 0 || ntaps < 2 || nbuf < 1 ||
      nbuf > kMaxRing || nbuf > n / cb || frames < 1 || reps < 1 ||
      !overlap_layout(n, cb, ntaps, nbuf, smem, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (body == kBodyTouch) {
    err = launch_overlap_mech<kBodyTouch>(mech, log2n, p, grid, smem, st);
  } else if (body == kBodyFma) {
    err = launch_overlap_mech<kBodyFma>(mech, log2n, p, grid, smem, st);
  } else if (body == kBodyFx) {
    err = launch_overlap_mech<kBodyFx>(mech, log2n, p, grid, smem, st);
  }
  return static_cast<int>(err);
}

// The layout overlap_layout gives a CTA of the overlap probe with `smem`
// bytes of dynamic shared memory, the one its launches take: out[0 .. 4] =
// rows once, teams, ring slots, threads, the layout's shared bytes (int32).
// Returns cudaErrorInvalidValue when no layout fits.
extern "C" int fxt_overlap_layout(int n, int cb, int ntaps, int nbuf,
                                  int smem, void* out) {
  OverlapArgs p{};
  if (n < 1 || cb < 1 || nbuf < 1 ||
      !overlap_layout(n, cb, ntaps, nbuf, smem, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* o = static_cast<int*>(out);
  o[0] = p.rows_once;
  o[1] = p.teams;
  o[2] = p.slots;
  o[3] = p.teams * kTeam + 32;
  o[4] = static_cast<int>(
      overlap_bytes(n, cb, ntaps, nbuf, p.rows_once, p.teams));
  return 0;
}

// The bytes the overlap probe's copies asked for since the last call,
// every launch's CTAs summed on the card, into out[0] (uint64); sets the
// count to 0.  Waits for the device first.
extern "C" int fxt_overlap_copied(void* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(out, g_overlap_copied,
                               sizeof(unsigned long long));
  }
  if (err == cudaSuccess) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(g_overlap_copied, &zero, sizeof(zero));
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
  // a warp's staged 32 x 32 block of bf16 in each transpose
  constexpr int stage = kRetileWarps * 32 * 2;
  switch (form) {
    case kControl:
      return static_cast<int>(
          launch_retile(&retile_mma_kernel<kControl>, p, grid, 0, st));
    case kTranspose:
      return static_cast<int>(
          launch_retile(&retile_mma_kernel<kTranspose>, p, grid,
                        stage * stage_pitch(kTranspose), st));
    case kTransposePad:
      return static_cast<int>(
          launch_retile(&retile_mma_kernel<kTransposePad>, p, grid,
                        stage * stage_pitch(kTransposePad), st));
    case kGather:
      return static_cast<int>(
          launch_retile(&retile_mma_kernel<kGather>, p, grid, 0, st));
    case kStockham:  // two 2048-point buffers
      return static_cast<int>(launch_retile(&retile_stockham_kernel, p, grid,
                                            kRetileBins * 8, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
