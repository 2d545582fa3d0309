// Rate-control cost grid of the MP3 encode path (kernel K5), written by
// hand for Hopper (sm_90a).
//
// Replaces the JAX package's mp3stego_tpu/ops/quant_batch.py::
// _cost_all_steps (:55), an XLA program (not a pallas_call) that costs every
// granule at all 128 quantizer steps at once. Its plain PyTorch version is
// mp3stego_tpu_torch/ops/quant_batch.py::cost_all_steps_torch; the kernel
// equals it bit for bit on every row of every cell, bailed cells included.
//
// A cell (granule, step s) holds what the reference's loop body would find
// at step s - 127 (MP3_Encoder.py:977-985), quantized through int2idx only:
//
//   bail      (xrmax * steptabi + 2^31) >> 32 > 165140, xrmax the largest
//             int32-WRAPPED |x| clipped at 0 (INT32_MIN gives 0);
//   quantize  ln = (|x| * steptabi + 2^31) >> 32 with |x| the TRUE
//             magnitude (2^31 for INT32_MIN); ix = int2idx[min(ln, 9999)]
//             and approx = some ln >= 10000 and not bail. The reference's
//             float64 fallback is not taken: the host re-evaluates approx
//             cells exactly, and ixmax, bv and every cost of such a cell
//             come from the clipped value (K4, csrc/search.cu, takes the
//             fallback instead);
//   runs      i0 = the last nonzero rounded up to even, lim = 1 + the last
//             sample above 1, c1 = min((i0 - lim) / 4, i0 / 4), bvr = i0 -
//             4 c1 = 2 bv. i0 >= lim, so both quotients are of non-negative
//             numbers and the shifts below are JAX's floor division;
//   subdivide scfb_anz = #(band < bvr), kmax = #(band <= bvr) - 1, the
//             SUBDV_TABLE row, and a1, a2 with the clips of the JAX program;
//             computed on every cell, bv == 0 included (the reference then
//             keeps stale addresses, so the host re-evaluates those cells);
//   regions   [0, a1), [a1, a2), [a2, bvr): per region the sums over the
//             pairs whose FIRST sample lies in it of the pair lengths under
//             tables 13/15/16/24 (with the signs) and of the escapes, and
//             the largest ix over the SAMPLES in it (a band edge may be odd);
//   count1    the c1 quads from sample bvr under both count1 tables (the
//             JAX program's quads at both alignments, picked by bvr & 3);
//   choice    15 when rc15 <= rc13 (m < 15), else the ESC families: t16 =
//             15 + #(linmax[15..23] < m - 15) (15 prices rc15), t24 = 24 +
//             #(linmax[24..31] < m - 15) with its linbits index clipped to
//             24..31, 24 only when strictly cheaper; an inactive region or m
//             == 0 chooses 0 and costs 0; bits_total = the regions' costs +
//             min(sum0, sum1).
//
// Layout: one thread costs one cell. A persistent grid of CTAs of 256
// threads walks the lanes (granules) four at a time, 64 threads a lane;
// thread t costs steps t and 127 - t, a fine step (much of the lane
// quantized) and a coarse one, so that a lane's warps carry alike, while a
// warp's 32 steps lie close together and loop alike. A lane's true |x| is
// staged once in shared memory with its suffix maxima (the largest |x|
// from each sample on; 32 chunks of 18 samples, scanned by the lane's
// first warp). In a cell:
//   - ln and int2idx grow with |x| (a test holds int2idx nondecreasing),
//     so ixmax and approx come from the lane's largest |x|, and, as
//     int2idx[ln] != 0 iff ln >= 1 and > 1 iff ln >= 2, the last nonzero
//     and the last sample above 1 from two 10-step binary searches over
//     the suffix maxima: no per-sample term;
//   - the subdivide is a read of a 289-entry table by bv, built once a CTA
//     by the JAX program's formula;
//   - the count1 quads lie past lim, so their ix are 0 or 1: ln >= 1, no
//     int2idx read;
//   - only the pairs below e = max(bvr, a2), the end of the last region
//     (a1 and a2 may lie past bvr), are quantized: a pair's lengths under
//     tables 13/15/16/24 with its signs and its escapes come in 13- and
//     10-bit fields of one 64-bit entry of a 256-entry table (built once a
//     CTA), summed over the prefixes p0 < a1, < a2 and < e in 64-bit adds
//     (the regions by difference); a region's largest ix is taken over the
//     pairs whose two samples lie in it, and the two samples across an odd
//     region edge are folded in after (no band row's subdivide picks one);
//   - no warp reduction: the thread chooses its regions' tables (t16, t24
//     and their linbits in one read of esc_table by the region's largest
//     ix) and writes its 7 or 27 values straight into the (rows, N, 128)
//     grid, a warp 64 contiguous bytes a row.
// The tables (int2idx as int16, the small int32 tables, esc_table and the
// band row, the pair and subdivide tables) are built in shared memory
// once a CTA. What bounds it: the instructions of the pair loop (~35 a
// pair a thread in the SASS), and the int2idx and pair table gathers at 32
// addresses. chip_smoke.grid_need_bound counts the work a cell needs in
// this form: the samples below max(i0, e), the pairs below e and the
// quads.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 128;
constexpr int kLanes = 4;                  // lanes a CTA costs at once
constexpr int kGroup = kSteps / 2;         // threads a lane: 2 steps each
constexpr int kThreads = kLanes * kGroup;
constexpr int kMinBlocks = 4;              // CTAs an SM must hold
constexpr int kSamples = 576;
constexpr int kChunk = 18;                 // samples a chunk, 32 a lane
constexpr int kBail = 165140;              // 8192^(4/3)
constexpr int kRowsClear = 7;
constexpr int kRowsHide = 27;
constexpr unsigned kFull = 0xffffffffu;

// the small tables (int32), in quant_batch._kernel_tables order
constexpr int kStepI = 0;
constexpr int kSubdv = 128;
constexpr int kQ0 = 174;
constexpr int kQ1 = 190;
constexpr int kBand = 206;
constexpr int kEsc = 229;
constexpr int kMaxIx = 1000;               // int2idx's largest entry
constexpr int kSmall = kEsc + kMaxIx + 1;

// a pair's fields in a 64-bit word: its lengths under tables 13, 15, 16
// and 24 with its signs (13 bits each: 288 pairs of at most 21 bits stay
// under 2^13), then its escapes (10 bits: at most 576)
constexpr int kField = 13;
constexpr int kEscShift = 4 * kField;

// the packed grid rows (quant_batch._BASE_KEYS, _HIDE_SCALAR, _HIDE_R3)
enum Row {
  kBailRow, kApprox, kIxmax, kBv, kA1, kA2, kBits,
  kSum0, kSum1, kChoice, kRc13 = kChoice + 3, kRc15 = kRc13 + 3,
  kRc16 = kRc15 + 3, kRc24 = kRc16 + 3, kRnesc = kRc24 + 3
};

struct Lane {
  alignas(16) unsigned absx[kSamples];     // the true |x|
  alignas(16) unsigned suffix[kSamples];   // the largest true |x| from i on
  unsigned xrmax;                          // the largest int32-wrapped |x|
};

struct Smem {
  alignas(16) int small[kSmall + 3];
  alignas(16) short int2idx[10000];
  // a pair (x, y), x and y clipped at 15, at x * 16 + y, in kField fields
  alignas(16) unsigned long long pair[256];
  // the subdivide of big_values bv (bvr = 2 bv): a1 | a2 << 16
  alignas(16) int sub[kSamples / 2 + 1];
  Lane lane[kLanes];
};

struct Args {
  const int* xr;                           // (n, 576)
  int n;
  int rows;                                // 7, or 27 with the hide channels
  const int* small;
  const short* int2idx;
  const unsigned char* hlen;
  short* out;                              // (rows, n, 128)
};

// ln = (|x| * scalei + 2^31) >> 32, the quantizer's index into int2idx
__device__ __forceinline__ int quant_ln(unsigned x, unsigned scalei) {
  return static_cast<int>(
      (static_cast<unsigned long long>(x) * scalei + 2147483648ULL) >> 32);
}

// ix = int2idx[min(ln, 9999)] of |x| at scalei
__device__ __forceinline__ int ix_of(const Smem& sm, unsigned x,
                                     unsigned scalei) {
  return sm.int2idx[min(quant_ln(x, scalei), 9999)];
}

// The subdivide of the JAX program for bvr: a1 | a2 << 16.
__device__ int subdivide(const Smem& sm, int bvr) {
  const int* band = sm.small + kBand;
  int anz = 0;
  int kmax = -1;
  for (int j = 0; j < 23; ++j) {
    anz += band[j] < bvr;
    kmax += band[j] <= bvr;
  }
  const int sa = min(anz, 22);
  const int tc0 = max(min(sm.small[kSubdv + 2 * sa], kmax - 1), 0);
  const int tc1 = max(min(sm.small[kSubdv + 2 * sa + 1], kmax - (tc0 + 1) - 1),
                      0);
  return band[tc0 + 1] | (band[min(max(tc0 + tc1 + 2, 0), 22)] << 16);
}

// One region's table choice and cost from its channels r (kField fields)
// and its largest ix m; 0 and 0 if the region is inactive or m == 0.
__device__ __forceinline__ int2 choose(const Smem& sm, unsigned long long r,
                                       int m, bool active) {
  const int rc13 = static_cast<int>(r) & 0x1fff;
  const int rc15 = static_cast<int>(r >> kField) & 0x1fff;
  const int rc16 = static_cast<int>(r >> (2 * kField)) & 0x1fff;
  const int rc24 = static_cast<int>(r >> (3 * kField)) & 0x1fff;
  const int rn = static_cast<int>(r >> kEscShift);
  // t16 | t24 << 8 | linbits(t16) << 16 | linbits(t24) << 24
  const int esc = sm.small[kEsc + min(m, kMaxIx)];
  const int t16 = esc & 0xff;
  const int cost16 = t16 == 15 ? rc15 : rc16 + ((esc >> 16) & 0xff) * rn;
  const int cost24 = rc24 + (esc >> 24) * rn;
  int2 c;
  c.x = 0;
  c.y = 0;
  if (active && m != 0 && m < 15) {
    c.x = rc15 <= rc13 ? 15 : 13;
    c.y = rc15 <= rc13 ? rc15 : rc13;
  } else if (active && m != 0) {
    c.x = cost24 < cost16 ? (esc >> 8) & 0xff : t16;
    c.y = cost24 < cost16 ? cost24 : cost16;
  }
  return c;
}

// One cell: step s of the lane in ln (its index `lane`), costed by one
// thread, which writes the cell's rows into the (rows, n, 128) grid.
__device__ void cost_cell(const Args& a, const Smem& sm, const Lane& ln,
                          int lane, int s) {
  const uint2* ax2 = reinterpret_cast<const uint2*>(ln.absx);
  const unsigned scalei = static_cast<unsigned>(sm.small[kStepI + s]);
  const bool bail = ((static_cast<unsigned long long>(ln.xrmax) * scalei
                      + 2147483648ULL) >> 32) > kBail;

  // ---- ln and int2idx grow with |x|, so the largest ix and the approx
  // flag come from the lane's largest |x|; int2idx[ln] != 0 iff ln >= 1 and
  // > 1 iff ln >= 2, so 1 + the last nonzero and 1 + the last sample above
  // 1 are the lengths of the prefixes of the suffix maxima that pass
  const int lmax = quant_ln(ln.suffix[0], scalei);
  const bool approx = lmax >= 10000 && !bail;
  const int ixmax = sm.int2idx[min(lmax, 9999)];
  int last = 0;
  int lim = 0;
#pragma unroll
  for (int step = 512; step > 0; step >>= 1) {
    if (last + step <= kSamples
        && quant_ln(ln.suffix[last + step - 1], scalei) >= 1) {
      last += step;
    }
    if (lim + step <= kSamples
        && quant_ln(ln.suffix[lim + step - 1], scalei) >= 2) {
      lim += step;
    }
  }

  // ---- run lengths; i0 >= lim >= 0, so >> 2 is the floor division
  const int i0 = ((last + 1) >> 1) << 1;
  const int c1 = min((i0 - lim) >> 2, i0 >> 2);
  const int bvr = i0 - 4 * c1;
  const int sub = sm.sub[bvr >> 1];
  const int a1 = sub & 0xffff;
  const int a2 = sub >> 16;
  // the regions end at e = max(bvr, a2): a1 and a2 may lie past bvr, so
  // regions 0 and 1 may reach into the count1 quads
  const int e = max(bvr, a2);

  // ---- count1 quads from bvr, both tables; bvr is even, so a quad is two
  // aligned pairs. bvr >= lim, so a quad's ix are 0 or 1: ix = (ln >= 1),
  // no gather, and the quad's index into the tables is at most 15
  int sum0 = 0;
  int sum1 = 0;
  for (int k = 0; k < c1; ++k) {
    const uint2 u = ax2[(bvr >> 1) + 2 * k];
    const uint2 t = ax2[(bvr >> 1) + 2 * k + 1];
    const int p = min(quant_ln(u.x, scalei), 1)
        | (min(quant_ln(u.y, scalei), 1) << 1)
        | (min(quant_ln(t.x, scalei), 1) << 2)
        | (min(quant_ln(t.y, scalei), 1) << 3);
    const int sb = __popc(p);
    sum0 += sm.small[kQ0 + p] + sb;
    sum1 += sm.small[kQ1 + p] + sb;
  }

  // ---- the pairs below e: channel sums over the prefixes p0 < a1, p0 <
  // a2 and p0 < e (regions by difference), and each region's largest ix
  // over the pairs that lie in it whole (a pair across an odd region edge
  // is folded in below)
  unsigned long long h0 = 0;
  unsigned long long h1 = 0;
  unsigned long long h2 = 0;
  int m0 = 0;
  int m1 = 0;
  int m2 = 0;
  for (int p0 = 0; p0 < e; p0 += 2) {
    const uint2 u = ax2[p0 >> 1];
    const int x = ix_of(sm, u.x, scalei);
    const int y = ix_of(sm, u.y, scalei);
    const unsigned long long t = sm.pair[min(x, 15) * 16 + min(y, 15)];
    h2 += t;
    if (p0 < a2) h1 += t;
    if (p0 < a1) h0 += t;
    const int pm = max(x, y);
    if (p0 + 1 < a1) {
      m0 = max(m0, pm);
    } else if (p0 >= a1 && p0 + 1 < a2) {
      m1 = max(m1, pm);
    } else if (p0 >= a2 && p0 < bvr) {
      m2 = max(m2, pm);
    }
  }
  // the samples on each side of an odd region edge, into their regions
  for (int k = 0; k < 2; ++k) {
    const int edge = k == 0 ? a1 : a2;
    if (edge & 1) {
      for (int i = edge - 1; i <= edge; ++i) {
        const int v = ix_of(sm, ln.absx[i], scalei);
        if (i < a1) {
          m0 = max(m0, v);
        } else if (i < a2) {
          m1 = max(m1, v);
        } else if (i < bvr) {
          m2 = max(m2, v);
        }
      }
    }
  }

  // ---- each region's table choice (prefix sums nest, so no field
  // borrows), and the cell's rows
  const int2 r0 = choose(sm, h0, m0, a1 > 0);
  const int2 r1 = choose(sm, h1 - h0, m1, a2 > a1);
  const unsigned long long g2 = a2 < bvr ? h2 - h1 : 0ull;
  const int2 r2 = choose(sm, g2, m2, bvr > a2);
  short* o = a.out + static_cast<long long>(lane) * kSteps + s;
  const long long row = static_cast<long long>(a.n) * kSteps;
  o[kBailRow * row] = bail;
  o[kApprox * row] = approx;
  o[kIxmax * row] = static_cast<short>(ixmax);
  o[kBv * row] = static_cast<short>(bvr >> 1);
  o[kA1 * row] = static_cast<short>(a1);
  o[kA2 * row] = static_cast<short>(a2);
  o[kBits * row] = static_cast<short>(r0.y + r1.y + r2.y + min(sum0, sum1));
  if (a.rows == kRowsHide) {
    o[kSum0 * row] = static_cast<short>(sum0);
    o[kSum1 * row] = static_cast<short>(sum1);
    const unsigned long long g[3] = {h0, h1 - h0, g2};
    const int choice[3] = {r0.x, r1.x, r2.x};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      o[(kChoice + r) * row] = static_cast<short>(choice[r]);
      o[(kRc13 + r) * row] = static_cast<short>(g[r] & 0x1fff);
      o[(kRc15 + r) * row] = static_cast<short>((g[r] >> kField) & 0x1fff);
      o[(kRc16 + r) * row] =
          static_cast<short>((g[r] >> (2 * kField)) & 0x1fff);
      o[(kRc24 + r) * row] =
          static_cast<short>((g[r] >> (3 * kField)) & 0x1fff);
      o[(kRnesc + r) * row] = static_cast<short>(g[r] >> kEscShift);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
cost_grid_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  for (int i = threadIdx.x; i < kSmall; i += kThreads) {
    sm.small[i] = a.small[i];
  }
  for (int i = threadIdx.x; i < 10000; i += kThreads) {
    sm.int2idx[i] = a.int2idx[i];
  }
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    const int x = i >> 4;
    const int y = i & 15;
    const unsigned signs = (x != 0) + (y != 0);
    unsigned long long t = 0;
    for (int k = 0; k < 4; ++k) {
      t |= static_cast<unsigned long long>(a.hlen[256 * k + i] + signs)
           << (kField * k);
    }
    sm.pair[i] = t | (static_cast<unsigned long long>((x == 15) + (y == 15))
                      << kEscShift);
  }
  __syncthreads();                         // the band row is in
  for (int i = threadIdx.x; i <= kSamples / 2; i += kThreads) {
    sm.sub[i] = subdivide(sm, 2 * i);
  }

  const int h = threadIdx.x / kGroup;      // the CTA's lane this thread costs
  const int t = threadIdx.x % kGroup;      // its steps t and 127 - t
  const int l = threadIdx.x & 31;
  Lane& ln = sm.lane[h];
  const int groups = (a.n + kLanes - 1) / kLanes;
  for (int q = blockIdx.x; q < groups; q += gridDim.x) {
    const int lane = kLanes * q + h;
    // the last lanes' cells are done
    __syncthreads();
    if (lane < a.n) {
      const int4* row = reinterpret_cast<const int4*>(
          a.xr + static_cast<long long>(lane) * kSamples);
      for (int i = t; i < kSamples / 4; i += kGroup) {
        const int4 v = row[i];
        const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ln.absx[4 * i + k] = e[k] < 0 ? 0u - static_cast<unsigned>(e[k])
                                        : static_cast<unsigned>(e[k]);
        }
      }
    }
    __syncthreads();
    // the first warp of each lane: thread t the suffix maxima of the true
    // |x| in its 18-sample chunk, then past it by a shuffle scan over the
    // chunks; the largest int32-wrapped |x| (INT32_MIN, |x| = 2^31, gives
    // 0) by a reduction
    if (t < 32) {
      unsigned cm = 0;
      unsigned wm = 0;
      for (int i = kChunk * l + kChunk - 1; i >= kChunk * l; --i) {
        const unsigned v = ln.absx[i];
        cm = max(cm, v);
        wm = max(wm, v == 0x80000000u ? 0u : v);
        ln.suffix[i] = cm;
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned o = __shfl_down_sync(kFull, cm, d);
        if (l + d < 32) cm = max(cm, o);
      }
      const unsigned next = __shfl_down_sync(kFull, cm, 1);
      const unsigned after = l == 31 ? 0u : next;   // chunks l + 1 .. 31
      for (int i = kChunk * l; i < kChunk * l + kChunk; ++i) {
        ln.suffix[i] = max(ln.suffix[i], after);
      }
      wm = __reduce_max_sync(kFull, wm);
      if (l == 0) ln.xrmax = wm;
    }
    __syncthreads();
    // a fine step (much of the lane quantized) and a coarse one, so that
    // the warps of a lane carry alike
    if (lane < a.n) {
      cost_cell(a, sm, ln, lane, t);
      cost_cell(a, sm, ln, lane, kSteps - 1 - t);
    }
  }
}

// Above 48 KB a launch may use dynamic shared memory only up to the
// kernel's raised limit.
cudaError_t raise_smem_limit() {
  return cudaFuncSetAttribute(cost_grid_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(Smem)));
}

}  // namespace

// The CTAs of cost_grid_kernel an SM holds at its dynamic shared memory (the
// runtime's occupancy query), its warps a CTA and its bytes of shared memory
// a CTA; returns the CUDA error (0 = success).
extern "C" int cost_grid_occupancy(int* ctas, int* warps, int* smem) {
  cudaError_t err = raise_smem_limit();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, cost_grid_kernel, kThreads, sizeof(Smem));
  }
  *warps = kThreads / 32;
  *smem = static_cast<int>(sizeof(Smem));
  return static_cast<int>(err);
}

// Launch on `stream` and return cudaGetLastError() (0 = launched). Device
// pointers: xr (n, 576) int32 and out (rows, n, 128) int16, both C-
// contiguous and 16-byte aligned; the tables as quant_batch._kernel_tables
// packs them. At most `blocks` CTAs of 8 warps walk the n lanes, four at a
// time.
extern "C" int cost_grid(const void* xr, int n, int rows, const void* small,
                         const void* int2idx, const void* hlen, void* out,
                         int blocks, void* stream) {
  if (n <= 0 || blocks <= 0 || (rows != kRowsClear && rows != kRowsHide)
      || !xr || !small || !int2idx || !hlen || !out
      || (reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(out))
          % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.xr = static_cast<const int*>(xr);
  a.n = n;
  a.rows = rows;
  a.small = static_cast<const int*>(small);
  a.int2idx = static_cast<const short*>(int2idx);
  a.hlen = static_cast<const unsigned char*>(hlen);
  a.out = static_cast<short*>(out);
  const int groups = (n + kLanes - 1) / kLanes;
  if (blocks > groups) blocks = groups;
  cost_grid_kernel<<<blocks, kThreads, sizeof(Smem),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
