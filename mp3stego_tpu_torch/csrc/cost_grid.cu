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
// Layout: a persistent grid of CTAs of 8 warps walks the lanes (granules),
// blockIdx.x, + gridDim.x, ... . A lane's |x| is staged once in shared
// memory; warp w costs steps w, w + 8, ..., w + 120. In a cell thread t
// owns pairs t + 32 j (j < 9), samples 2 (t + 32 j) and 2 (t + 32 j) + 1,
// as in csrc/search.cu, and writes its ix into the warp's 576-entry row in
// shared memory, which the count1 quads (they straddle threads) read after
// a __syncwarp. ixmax, the run lengths, the region sums and maxima are
// integer warp reductions, so their order does not matter. Sums that stay
// below 2^16 share one reduction: rc13 | rc15 << 16 and rc16 | rc24 << 16
// a region (a pair costs at most 19 + 2 bits, 288 pairs at most 6,048),
// sum0 | sum1 << 16 (144 quads of at most 10 bits) and the three regions'
// escapes in 10-bit fields (at most 576). Lane 0 stores the cell's 7 (27
// with the hide channels) values into the CTA's (rows, 128) int16 buffer,
// which the CTA writes out as 16-byte rows of the (rows, N, 128) grid. The
// tables (int2idx as int16, the pair lengths as uint8, the small int32
// tables and the band row) are loaded into shared memory once a CTA.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;              // CTAs an SM must hold
constexpr int kSteps = 128;
constexpr int kSamples = 576;
constexpr int kPairs = 9;                  // pairs per thread (288 / 32)
constexpr int kBail = 165140;              // 8192^(4/3)
constexpr int kRowsClear = 7;
constexpr int kRowsHide = 27;
constexpr unsigned kFull = 0xffffffffu;

// the small tables (int32), in quant_batch._kernel_tables order
constexpr int kStepI = 0;
constexpr int kLinmax = 128;
constexpr int kLinbits = 162;
constexpr int kSubdv = 196;
constexpr int kQ0 = 242;
constexpr int kQ1 = 258;
constexpr int kBand = 274;
constexpr int kSmall = 297;

// the packed grid rows (quant_batch._BASE_KEYS, _HIDE_SCALAR, _HIDE_R3)
enum Row {
  kBailRow, kApprox, kIxmax, kBv, kA1, kA2, kBits,
  kSum0, kSum1, kChoice, kRc13 = kChoice + 3, kRc15 = kRc13 + 3,
  kRc16 = kRc15 + 3, kRc24 = kRc16 + 3, kRnesc = kRc24 + 3
};

struct Smem {
  alignas(16) int small[kSmall + 3];
  alignas(16) short int2idx[10000];
  alignas(16) unsigned char hlen[4 * 256];   // tables 13, 15, 16, 24 [x][y]
  alignas(16) unsigned absx[kSamples];       // the lane's true |x|
  alignas(16) int ix[kWarps][kSamples];      // each warp's quantized row
  alignas(16) short out[kRowsHide][kSteps];  // the lane's cells, by row
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

// One cell: the warp's lane at grid step s (0..127). All 32 threads of the
// warp take part; lane 0 stores the cell's values.
__device__ void cost_cell(const Args& a, Smem& sm, int s,
                          unsigned long long xrmax) {
  const int l = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int* ixs = sm.ix[w];
  int2* ix2 = reinterpret_cast<int2*>(ixs);
  const uint2* ax2 = reinterpret_cast<const uint2*>(sm.absx);
  const unsigned scalei = static_cast<unsigned>(sm.small[kStepI + s]);
  const bool bail = ((xrmax * scalei + 2147483648ULL) >> 32) > kBail;

  // ---- quantize, with the run lengths' per-thread terms
  __syncwarp();                            // the last cell's quads are read
  bool big = false;                        // some ln >= 10000
  int mx = 0;
  int last = 0;                            // 1 + the last nonzero, 0: none
  int lim = 0;                             // 1 + the last sample above 1
#pragma unroll 3
  for (int j = 0; j < kPairs; ++j) {
    const int p = l + 32 * j;
    const uint2 v = ax2[p];
    const int lx = static_cast<int>(
        (static_cast<unsigned long long>(v.x) * scalei + 2147483648ULL) >> 32);
    const int ly = static_cast<int>(
        (static_cast<unsigned long long>(v.y) * scalei + 2147483648ULL) >> 32);
    big = big || lx >= 10000 || ly >= 10000;
    int2 q;
    q.x = sm.int2idx[min(lx, 9999)];
    q.y = sm.int2idx[min(ly, 9999)];
    ix2[p] = q;
    mx = max(mx, max(q.x, q.y));
    if (q.x != 0) last = 2 * p + 1;
    if (q.y != 0) last = 2 * p + 2;
    if (q.x > 1) lim = 2 * p + 1;
    if (q.y > 1) lim = 2 * p + 2;
  }
  const bool approx = __any_sync(kFull, big) && !bail;
  const int ixmax = __reduce_max_sync(kFull, mx);
  last = __reduce_max_sync(kFull, last);
  lim = __reduce_max_sync(kFull, lim);

  // ---- run lengths; i0 >= lim >= 0, so >> 2 is the floor division
  const int i0 = ((last + 1) >> 1) << 1;
  const int c1 = min((i0 - lim) >> 2, i0 >> 2);
  const int bvr = i0 - 4 * c1;

  // ---- subdivide: the band counts by ballot, thread t < 23 holds band[t]
  const int* band = sm.small + kBand;
  const int bl = l < 23 ? band[l] : INT_MAX;
  const int anz = __popc(__ballot_sync(kFull, bl < bvr));
  const int kmax = __popc(__ballot_sync(kFull, bl <= bvr)) - 1;
  const int sa = min(anz, 22);
  const int tc0 = max(min(sm.small[kSubdv + 2 * sa], kmax - 1), 0);
  const int a1 = band[tc0 + 1];
  const int tc1 = max(min(sm.small[kSubdv + 2 * sa + 1], kmax - (tc0 + 1) - 1),
                      0);
  const int a2 = band[min(max(tc0 + tc1 + 2, 0), 22)];

  // ---- count1 quads from bvr, both tables (sum0 | sum1 << 16)
  __syncwarp();
  int qs = 0;
  for (int k = l; k < c1; k += 32) {
    const int* v = ixs + bvr + 4 * k;
    const int sb = (v[0] != 0) + (v[1] != 0) + (v[2] != 0) + (v[3] != 0);
    const int p = min(v[0] + (v[1] << 1) + (v[2] << 2) + (v[3] << 3), 15);
    qs += (sm.small[kQ0 + p] + sb) + ((sm.small[kQ1 + p] + sb) << 16);
  }
  qs = __reduce_add_sync(kFull, qs);
  const int sum0 = qs & 0xffff;
  const int sum1 = qs >> 16;

  // ---- per region: pair lengths under 13/15/16/24, escapes, max
  const int rs[3] = {0, a1, a2};
  const int re[3] = {a1, a2, bvr};
  int c1315[3] = {0, 0, 0};                // rc13 | rc15 << 16
  int c1624[3] = {0, 0, 0};                // rc16 | rc24 << 16
  int nesc3 = 0;                           // 10 bits a region
  int mreg[3] = {0, 0, 0};
#pragma unroll 3
  for (int j = 0; j < kPairs; ++j) {
    const int p0 = 2 * (l + 32 * j);
    const int2 v = ix2[l + 32 * j];
    const int pidx = min(v.x, 15) * 16 + min(v.y, 15);
    const int signs = (v.x != 0) + (v.y != 0);
    const int nesc = (v.x > 14) + (v.y > 14);
    const int h1315 = (sm.hlen[pidx] + signs)
        + ((sm.hlen[256 + pidx] + signs) << 16);
    const int h1624 = (sm.hlen[512 + pidx] + signs)
        + ((sm.hlen[768 + pidx] + signs) << 16);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const bool in0 = p0 >= rs[r] && p0 < re[r];
      const bool in1 = p0 + 1 >= rs[r] && p0 + 1 < re[r];
      if (in0) {
        c1315[r] += h1315;
        c1624[r] += h1624;
        nesc3 += nesc << (10 * r);
      }
      mreg[r] = max(mreg[r], max(in0 ? v.x : 0, in1 ? v.y : 0));
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    c1315[r] = __reduce_add_sync(kFull, c1315[r]);
    c1624[r] = __reduce_add_sync(kFull, c1624[r]);
    mreg[r] = __reduce_max_sync(kFull, mreg[r]);
  }
  nesc3 = __reduce_add_sync(kFull, nesc3);
  if (l != 0) return;

  // ---- table choice per region, and the cell's values
  const int* linmax = sm.small + kLinmax;
  const int* linbits = sm.small + kLinbits;
  const bool active[3] = {a1 > 0, a2 > a1, bvr > a2};
  int bits = min(sum0, sum1);
  short* o = &sm.out[0][s];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int rc13 = c1315[r] & 0xffff;
    const int rc15 = c1315[r] >> 16;
    const int rc16 = c1624[r] & 0xffff;
    const int rc24 = c1624[r] >> 16;
    const int rn = (nesc3 >> (10 * r)) & 1023;
    const int m = mreg[r];
    const int ixm = m - 15;
    int t16 = 15;
    int t24 = 24;
    for (int j = 15; j < 24; ++j) t16 += linmax[j] < ixm;
    for (int j = 24; j < 32; ++j) t24 += linmax[j] < ixm;
    const int cost16 = t16 == 15 ? rc15 : rc16 + linbits[min(t16, 31)] * rn;
    const int cost24 = rc24 + linbits[min(t24, 31)] * rn;
    const bool esc24 = cost24 < cost16;
    const bool nl15 = rc15 <= rc13;
    int choice = 0;
    int cost = 0;
    if (m != 0 && m < 15) {
      choice = nl15 ? 15 : 13;
      cost = nl15 ? rc15 : rc13;
    } else if (m != 0) {
      choice = esc24 ? t24 : t16;
      cost = esc24 ? cost24 : cost16;
    }
    if (!active[r]) choice = 0;
    bits += choice != 0 ? cost : 0;
    if (a.rows == kRowsHide) {
      o[(kChoice + r) * kSteps] = static_cast<short>(choice);
      o[(kRc13 + r) * kSteps] = static_cast<short>(rc13);
      o[(kRc15 + r) * kSteps] = static_cast<short>(rc15);
      o[(kRc16 + r) * kSteps] = static_cast<short>(rc16);
      o[(kRc24 + r) * kSteps] = static_cast<short>(rc24);
      o[(kRnesc + r) * kSteps] = static_cast<short>(rn);
    }
  }
  o[kBailRow * kSteps] = bail;
  o[kApprox * kSteps] = approx;
  o[kIxmax * kSteps] = static_cast<short>(ixmax);
  o[kBv * kSteps] = static_cast<short>(bvr >> 1);
  o[kA1 * kSteps] = static_cast<short>(a1);
  o[kA2 * kSteps] = static_cast<short>(a2);
  o[kBits * kSteps] = static_cast<short>(bits);
  if (a.rows == kRowsHide) {
    o[kSum0 * kSteps] = static_cast<short>(sum0);
    o[kSum1 * kSteps] = static_cast<short>(sum1);
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
  for (int i = threadIdx.x; i < 4 * 256; i += kThreads) sm.hlen[i] = a.hlen[i];

  const int l = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const uint2* ax2 = reinterpret_cast<const uint2*>(sm.absx);
  for (int lane = blockIdx.x; lane < a.n; lane += gridDim.x) {
    __syncthreads();                       // the last lane's buffers are free
    const int4* row = reinterpret_cast<const int4*>(
        a.xr + static_cast<long long>(lane) * kSamples);
    for (int i = threadIdx.x; i < kSamples / 4; i += kThreads) {
      const int4 v = row[i];
      const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sm.absx[4 * i + k] = e[k] < 0 ? 0u - static_cast<unsigned>(e[k])
                                      : static_cast<unsigned>(e[k]);
      }
    }
    __syncthreads();

    // xrmax from the int32-wrapped |x|: INT32_MIN (|x| = 2^31) gives 0
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const uint2 v = ax2[l + 32 * j];
      m = max(m, max(v.x == 0x80000000u ? 0u : v.x,
                     v.y == 0x80000000u ? 0u : v.y));
    }
    const unsigned long long xrmax = __reduce_max_sync(kFull, m);
    for (int s = w; s < kSteps; s += kWarps) cost_cell(a, sm, s, xrmax);
    __syncthreads();

    for (int i = threadIdx.x; i < a.rows * (kSteps / 8); i += kThreads) {
      const int r = i / (kSteps / 8);
      const int c = i % (kSteps / 8);
      reinterpret_cast<int4*>(
          a.out + (static_cast<long long>(r) * a.n + lane) * kSteps)[c] =
          reinterpret_cast<const int4*>(sm.out[r])[c];
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
  *warps = kWarps;
  *smem = static_cast<int>(sizeof(Smem));
  return static_cast<int>(err);
}

// Launch on `stream` and return cudaGetLastError() (0 = launched). Device
// pointers: xr (n, 576) int32 and out (rows, n, 128) int16, both C-
// contiguous and 16-byte aligned; the tables as quant_batch._kernel_tables
// packs them. `blocks` CTAs of 8 warps walk the n lanes.
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
  cost_grid_kernel<<<blocks, kThreads, sizeof(Smem),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
