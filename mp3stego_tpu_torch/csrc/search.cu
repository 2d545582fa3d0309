// Rate-control search of the MP3 encode path (kernel K4), written by hand
// for Hopper (sm_90a).
//
// Replaces the JAX package's mp3stego_tpu/ops/search_plane.py::_search_body
// (:385), an XLA program (a fori_loop bisection and a masked while_loop inner
// loop over every granule in lockstep; not a pallas_call). Its plain PyTorch
// versions are mp3stego_tpu_torch/ops/search_plane.py::search_torch,
// search_windows_torch and cost_step_torch; the kernel equals them bit for
// bit on every output row, the ix plane and the evaluation counts.
//
// One warp runs one lane (a granule, or a (window, granule) pair) through
// the reference's sequential trajectory, as the host C++ twin does
// (native/src/rate_search.cpp rate_bin_search / rate_inner_loop): a
// bisection of up to 8 rounds from nxt = -120, count = 120 (a round fits
// when bits < max_bits), then the inner loop, step + 1 until the ixmax gate
// passes and bits <= max_bits, at most 160 rounds (FLAG_ITER past that).
// Each evaluation:
//
//   quantize  ln = (|x| * steptabi + 2^31) >> 32 with |x| the true int64
//             magnitude; int2idx[ln] where ln < 10000, else the float64
//             fallback trunc(sqrt(sqrt(d) * d)), d = (xrabs * steptab) *
//             4.656612875e-10 with xrabs the int32-WRAPPED |x| (INT32_MIN
//             stays negative and gives INT32_MIN); every product and root
//             rounded on its own (__dmul_rn, __dsqrt_rn, --fmad=false). The
//             quick reject (xrmax * steptabi + 2^31) >> 32 > 165140 and an
//             ixmax above 8192 fail the gate and cost 100000.
//   cost      last nonzero and lim -> count1, big_values; the count1 quads
//             in both tables (cts = sum0 >= sum1); subdivide through
//             SUBDV_TABLE and the band row (addresses stay stale when
//             big_values == 0); per region the pair lengths under tables
//             13/15/16/24, the escapes and the region max -> table select
//             with linbits; in hide mode the stego pair transform at the
//             lane's cursor and the re-cost under the emitted tables.
//   state     the 3 addresses (updated when the gate passes), virgin
//             (FLAG_ADDR when a virgin lane with big_values == 0 and count1
//             > 0 passes the gate) and FLAG_OOB (a step clamped into the
//             128-entry steptab).
//
// Layout in a warp: thread t owns pairs t + 32 j (j < 9), i.e. samples
// 2 (t + 32 j) and 2 (t + 32 j) + 1, of the warp's two 576-entry rows in
// shared memory: the spectrum x, read once a lane, and the quantized ix,
// written by each evaluation. The quads, which straddle threads, read ix
// after a __syncwarp. Run lengths, ixmax, the quad sums and the 3 x (4
// tables + escapes + max) region sums are warp reductions
// (__reduce_max_sync / __reduce_add_sync); integer sums do not depend on
// their order, so the kernel equals the plain version bit for bit.
//
// What bounds it on this card: operations. The function's work depends on
// the data, so each lane counts it (the rows after evals and inner): the
// evaluations past the quick reject (quantize: 7 integer operations a
// sample), of them those past the ixmax gate (run lengths: 4 a sample), and
// over those the count1 quads (19 each: signs, pattern, two table lengths)
// and the big-values pairs (27 each: the lengths under 13/15/16/24 with
// signs and escapes, the pair's region, its 5 sums and its max; 4 more in
// hide mode for the re-cost under the emitted table). An evaluation that
// returns at the quick reject costs nothing past it. A lane runs 1-168
// evaluations, each a chain of shared-memory gathers and warp reductions
// that one warp cannot hide, so the design keeps many lanes in flight:
//
//   * x and ix live in shared memory, not registers, and the pair loops
//     unroll by 3, so a thread needs at most 80 registers with no spills
//     (a full unroll spills at that cap) and __launch_bounds__ holds
//     kMinBlocks CTAs of 8 warps on an SM: 24 lanes in flight. The tables
//     (31 KB: int2idx as int16, the Huffman lengths as uint8) and the 8
//     warps' rows (36 KB) are dynamic shared memory; the grid is the SMs
//     times the CTAs an SM holds (rate_search_occupancy asks the runtime).
//   * the warps take lanes from a queue (one atomicAdd a lane), so the
//     warps that draw heavy lanes do not set the end of the launch.
//
// What is left over the function's count is the predicated work (every
// pair is tested and summed against all 3 regions, the quads over all
// lanes of the warp), the warp's reductions and the rare float64
// fallback. One packed 32-bit gather a pair summed into its one region
// (16 reductions an evaluation instead of 29) was measured slower at 24
// warps an SM (PERF.md, section 6).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // lanes in flight per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;              // CTAs an SM must hold
constexpr int kSamples = 576;
constexpr int kPairs = 9;                  // pairs per thread (288 / 32)
constexpr int kBail = 165140;              // 8192^(4/3)
constexpr int kMaxStep = 8192;
constexpr int kIterCap = 160;
constexpr int kBailBits = 100000;
constexpr int kFlagAddr = 1;
constexpr int kFlagOob = 4;
constexpr int kFlagIter = 8;
constexpr int kRows = 21;                  // ROWS + the 6 counts
constexpr unsigned kFull = 0xffffffffu;

// the small tables (int32), in search_plane._kernel_tables order
constexpr int kLinmax = 0;
constexpr int kLinbits = 34;
constexpr int kSubdv = 68;
constexpr int kTransform = 114;
constexpr int kBand = 178;
constexpr int kSmall = 201;

struct Tables {
  double steptab[128];
  int steptabi[128];
  int small[kSmall];
  short int2idx[10000];
  unsigned char hlen[34 * 256];            // [table][x][y]
};

// dynamic shared memory: the tables, then each warp's x and ix rows
constexpr int kTablesBytes = (sizeof(Tables) + 15) / 16 * 16;
constexpr int kSmemBytes = kTablesBytes + kWarps * 2 * kSamples * 4;

struct Args {
  const int* xr;                           // (n, 576)
  const int* max_bits;                     // (n,), null in cost mode
  int n;                                   // spectra
  int m;                                   // lane searches: n, or 8 n
  int windows;                             // 1: lane w n + i is window w
  const unsigned char* hbits;              // hide bits, null in clear mode
  long long hbuf;                          // their buffer length (>= 1)
  long long n_bits;                        // the message's length
  const long long* hcur;                   // (n,) cursors, null for windows
  int mode;                                // 0 search, 1 cost one step
  int step;                                // mode 1: the step
  long long big;                           // mode 1: cost of a failed gate
  const double* steptab;
  const int* steptabi;
  const int* small;
  const short* int2idx;
  const unsigned char* hlen;
  int* rows;                               // (21, m)
  int* ix;                                 // (m, 576)
  long long* cost;                         // (n,) in mode 1
  int* queue;                              // the next lane to take, from 0
};

// The function's work over a lane's evaluations (the bound's counts).
struct Work {
  int quantized;                           // past the quick reject
  int costed;                              // past the ixmax gate
  int quads;                               // count1 quads costed
  int pairs;                               // big-values pairs costed
};

struct Eval {
  bool gate;
  int bits;
  int bv, c1, a1, a2, a3, r0c, r1c, cts;
  int ch[3];
};

__device__ __forceinline__ int floordiv4(int a) {
  return a >= 0 ? a / 4 : -((-a + 3) / 4);
}

__device__ __forceinline__ int wrap_abs(int v) {
  return static_cast<int>(v < 0 ? 0u - static_cast<unsigned>(v)
                                : static_cast<unsigned>(v));
}

// One sample's quantized value at the step's scales.
__device__ __forceinline__ int quantize1(const Tables& t, int v,
                                         long long scalei, double st) {
  const long long labs = v < 0 ? -static_cast<long long>(v)
                               : static_cast<long long>(v);
  const int ln = static_cast<int>((labs * scalei + 2147483648LL) >> 32);
  if (ln < 10000) return t.int2idx[max(ln, 0)];
  double d = __dmul_rn(static_cast<double>(wrap_abs(v)), st);
  d = __dmul_rn(d, 4.656612875e-10);
  return d < 0.0 ? INT_MIN
                 : __double2int_rz(__dsqrt_rn(__dmul_rn(__dsqrt_rn(d), d)));
}

// One evaluation at step s: quantize the warp's x row into its ix row,
// then cost. `addr`, `virgin` and `flags` carry the lane's state across
// evaluations, `work` the function's work; `cur` is the lane's hide cursor.
__device__ Eval evaluate(const Args& a, const Tables& t, const int* xs,
                         int* ixs, long long xrmax, int s, long long cur,
                         int (&addr)[3], bool& virgin, int& flags,
                         Work& work) {
  const int l = threadIdx.x & 31;
  const int2* x2 = reinterpret_cast<const int2*>(xs);
  int2* ix2 = reinterpret_cast<int2*>(ixs);
  Eval e;
  e.gate = false;
  e.bits = kBailBits;

  // ---- quantize, with the run lengths' per-thread terms
  const int sp = s + 127;
  const int sidx = min(max(sp, 0), 127);
  if (sp != sidx) {
    flags |= kFlagOob;
  }
  const long long scalei = t.steptabi[sidx];
  if (((xrmax * scalei + 2147483648LL) >> 32) > kBail) {
    return e;
  }
  ++work.quantized;
  const double st = t.steptab[sidx];
  int mx = INT_MIN;
  int last = -1;
  int lim = 0;
#pragma unroll 3
  for (int j = 0; j < kPairs; ++j) {
    const int p = 2 * (l + 32 * j);
    const int2 v = x2[l + 32 * j];
    int2 q;
    q.x = quantize1(t, v.x, scalei, st);
    q.y = quantize1(t, v.y, scalei, st);
    ix2[l + 32 * j] = q;
    mx = max(mx, max(q.x, q.y));
    if (q.x != 0) last = p;
    if (q.y != 0) last = p + 1;
    if (q.x > 1) lim = p + 1;
    if (q.y > 1) lim = p + 2;
  }
  if (__reduce_max_sync(kFull, mx) > kMaxStep) {
    return e;
  }
  e.gate = true;
  ++work.costed;

  // ---- run lengths
  last = __reduce_max_sync(kFull, last);
  lim = __reduce_max_sync(kFull, lim);
  const int i0 = last >= 0 ? ((last + 2) >> 1) << 1 : 0;
  const int c1 = max(min(floordiv4(i0 - lim), floordiv4(i0)), 0);
  const int bvr = i0 - 4 * c1;
  const int bv = bvr >> 1;
  const bool has_bv = bv > 0;
  work.quads += c1;
  work.pairs += bv;

  // ---- count1 quads from bvr, both tables
  __syncwarp();
  int q0 = 0;
  int q1 = 0;
  for (int k = l; k < c1; k += 32) {
    const int* v = ixs + bvr + 4 * k;
    const int sb = (v[0] != 0) + (v[1] != 0) + (v[2] != 0) + (v[3] != 0);
    const unsigned pu = static_cast<unsigned>(v[0])
        + (static_cast<unsigned>(v[1]) << 1)
        + (static_cast<unsigned>(v[2]) << 2)
        + (static_cast<unsigned>(v[3]) << 3);
    const int p = min(max(static_cast<int>(pu), 0), 15);
    q0 += t.hlen[32 * 256 + p] + sb;
    q1 += t.hlen[33 * 256 + p] + sb;
  }
  __syncwarp();
  const int sum0 = __reduce_add_sync(kFull, q0);
  const int sum1 = __reduce_add_sync(kFull, q1);

  // ---- subdivide
  const int* band = t.small + kBand;
  int anz = 0;
  int kcount = 0;
  for (int j = 0; j < 23; ++j) {
    anz += band[j] < bvr;
    kcount += band[j] <= bvr;
  }
  const int kmax = kcount - 1;
  const int sa = min(max(anz, 0), 22);
  const int tc0 = max(min(t.small[kSubdv + 2 * sa], kmax - 1), 0);
  const int tc1 = max(min(t.small[kSubdv + 2 * sa + 1], kmax - (tc0 + 1) - 1),
                      0);
  const int a1 = has_bv ? band[tc0 + 1] : addr[0];
  const int a2 = has_bv ? band[min(max(tc0 + tc1 + 2, 0), 22)] : addr[1];
  const int a3 = has_bv ? bvr : addr[2];

  // ---- per region: pair lengths under 13/15/16/24, escapes, max
  const int rs[3] = {0, a1, a2};
  const int re[3] = {a1, a2, bvr};
  int acc[3][5];
  int mreg[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 5; ++c) acc[r][c] = 0;
    mreg[r] = INT_MIN;
  }
#pragma unroll 3
  for (int j = 0; j < kPairs; ++j) {
    const int p0 = 2 * (l + 32 * j);
    const int2 v = ix2[l + 32 * j];
    const int xv = v.x;
    const int yv = v.y;
    const int pidx = min(max(xv, 0), 15) * 16 + min(max(yv, 0), 15);
    const int signs = (xv != 0) + (yv != 0);
    const int nesc = (xv > 14) + (yv > 14);
    const int h13 = t.hlen[13 * 256 + pidx] + signs;
    const int h15 = t.hlen[15 * 256 + pidx] + signs;
    const int h16 = t.hlen[16 * 256 + pidx] + signs;
    const int h24 = t.hlen[24 * 256 + pidx] + signs;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (p0 >= rs[r] && p0 < re[r]) {
        acc[r][0] += h13;
        acc[r][1] += h15;
        acc[r][2] += h16;
        acc[r][3] += h24;
        acc[r][4] += nesc;
      }
      const bool in1 = p0 + 1 >= rs[r] && p0 + 1 < re[r];
      mreg[r] = max(mreg[r], max(p0 >= rs[r] && p0 < re[r] ? xv : 0,
                                 in1 ? yv : 0));
    }
  }
  int rcost[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 5; ++c) acc[r][c] = __reduce_add_sync(kFull, acc[r][c]);
    mreg[r] = __reduce_max_sync(kFull, mreg[r]);
  }
  const int* linmax = t.small + kLinmax;
  const int* linbits = t.small + kLinbits;
  const bool active[3] = {a1 > 0, a2 > a1, bvr > a2};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int rc13 = acc[r][0], rc15 = acc[r][1], rc16 = acc[r][2];
    const int rc24 = acc[r][3], rnesc = acc[r][4];
    const int ixm = mreg[r] - 15;
    int t16 = 15;
    int t24 = 24;
    for (int j = 15; j < 24; ++j) t16 += linmax[j] < ixm;
    for (int j = 24; j < 32; ++j) t24 += linmax[j] < ixm;
    const int cost16 = t16 == 15 ? rc15 : rc16 + linbits[t16] * rnesc;
    const int cost24 = rc24 + linbits[min(max(t24, 24), 31)] * rnesc;
    const bool esc24 = cost24 < cost16;
    const bool nl15 = rc15 <= rc13;
    int choice;
    if (mreg[r] < 15) {
      choice = nl15 ? 15 : 13;
      rcost[r] = nl15 ? rc15 : rc13;
    } else {
      choice = esc24 ? t24 : t16;
      rcost[r] = esc24 ? cost24 : cost16;
    }
    e.ch[r] = active[r] && mreg[r] != 0 ? choice : 0;
  }

  // ---- hide: the pair transform at the cursor, re-cost under the emitted
  // tables
  if (a.hbits != nullptr) {
    const int inc0 = e.ch[0] > 0;
    const int inc1 = e.ch[1] > 0;
    const long long idx[3] = {cur, cur + inc0, cur + inc0 + inc1};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (e.ch[r] > 0 && idx[r] < a.n_bits) {
        const long long bi = min(max(idx[r], 0LL), a.hbuf - 1);
        e.ch[r] = t.small[kTransform + min(max(e.ch[r], 0), 31) * 2
                          + a.hbits[bi]];
      }
    }
    int rr[3] = {0, 0, 0};
#pragma unroll 3
    for (int j = 0; j < kPairs; ++j) {
      const int p0 = 2 * (l + 32 * j);
      const int2 v = ix2[l + 32 * j];
      const int pidx = min(max(v.x, 0), 15) * 16 + min(max(v.y, 0), 15);
      const int signs = (v.x != 0) + (v.y != 0);
      bool in[3];
      int tpp = 0;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        in[r] = p0 >= rs[r] && p0 < re[r];
        tpp += in[r] ? e.ch[r] : 0;
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (in[r]) rr[r] += t.hlen[tpp * 256 + pidx] + signs;
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      rcost[r] = __reduce_add_sync(kFull, rr[r])
          + linbits[e.ch[r]] * acc[r][4];
    }
  }

  int bits = sum0 < sum1 ? sum0 : sum1;
#pragma unroll
  for (int r = 0; r < 3; ++r) bits += e.ch[r] != 0 ? rcost[r] : 0;
  e.bits = bits;
  e.bv = bv;
  e.c1 = c1;
  e.a1 = a1;
  e.a2 = a2;
  e.a3 = a3;
  e.r0c = has_bv ? tc0 : 0;
  e.r1c = has_bv ? tc1 : 0;
  e.cts = sum0 >= sum1;

  // ---- the lane's state
  if (!has_bv && c1 > 0 && virgin) {
    flags |= kFlagAddr;
  }
  addr[0] = a1;
  addr[1] = a2;
  addr[2] = a3;
  virgin = virgin && !has_bv;
  return e;
}

__device__ __forceinline__ void write_rows(const Args& a, int lane,
                                           const int (&v)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    a.rows[static_cast<long long>(r) * a.m + lane] = v[r];
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
rate_search_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tables& t = *reinterpret_cast<Tables*>(smem);
  for (int i = threadIdx.x; i < 128; i += kThreads) {
    t.steptab[i] = a.steptab[i];
    t.steptabi[i] = a.steptabi[i];
  }
  for (int i = threadIdx.x; i < kSmall; i += kThreads) t.small[i] = a.small[i];
  for (int i = threadIdx.x; i < 10000; i += kThreads) {
    t.int2idx[i] = a.int2idx[i];
  }
  for (int i = threadIdx.x; i < 34 * 256; i += kThreads) t.hlen[i] = a.hlen[i];
  __syncthreads();

  const int l = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int* xs = reinterpret_cast<int*>(smem + kTablesBytes) + w * 2 * kSamples;
  int* ixs = xs + kSamples;
  for (;;) {
    int lane = 0;                          // the warp's next lane
    if (l == 0) lane = atomicAdd(a.queue, 1);
    lane = __shfl_sync(kFull, lane, 0);
    if (lane >= a.m) break;
    const int win = a.windows ? lane / a.n : 0;
    const int i = lane - win * a.n;
    const int* row = a.xr + static_cast<long long>(i) * kSamples;
    int m = 0;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int2 v = make_int2(row[2 * (l + 32 * j)],
                               row[2 * (l + 32 * j) + 1]);
      reinterpret_cast<int2*>(xs)[l + 32 * j] = v;
      m = max(m, max(max(wrap_abs(v.x), 0), wrap_abs(v.y)));
    }
    const long long xrmax = __reduce_max_sync(kFull, m);
    const bool need = xrmax > 0;
    const long long cur = a.hbits == nullptr ? 0
        : (a.windows ? 3LL * win : a.hcur[i]);
    int addr[3] = {0, 0, 0};
    bool virgin = true;
    int flags = 0;
    Work work = {};

    if (a.mode == 1) {                     // cost one step
      const Eval e = evaluate(a, t, xs, ixs, xrmax, a.step, cur, addr,
                              virgin, flags, work);
      if (l == 0) a.cost[lane] = e.gate ? e.bits : a.big;
      continue;
    }

    // the bisection, then the inner loop, through one evaluation site
    const int mb = a.max_bits[i];
    int evals = 0;
    int inner = 0;
    int nxt = -120;
    int count = 120;
    int round = 0;
    int half = count / 2;
    int step = nxt + half;
    bool bisect = true;
    bool done = !need;
    while (need) {
      const Eval e = evaluate(a, t, xs, ixs, xrmax, step, cur, addr, virgin,
                              flags, work);
      ++evals;
      if (bisect) {
        if (e.bits < mb) {
          count = half;
        } else {
          nxt += half;
          count -= half;
        }
        if (++round < 8 && count > 1) {
          half = count / 2;
          step = nxt + half;
          continue;
        }
        bisect = false;
        step = nxt;
      } else if (e.gate && e.bits <= mb) {
        done = true;
        if (l == 0) {
          const int v[kRows] = {
              step, e.bits, e.bv, e.c1, e.a1, e.a2, e.a3, e.r0c, e.r1c,
              e.ch[0], e.ch[1], e.ch[2], e.cts, flags, 0, evals, inner,
              work.quantized, work.costed, work.quads, work.pairs};
          write_rows(a, lane, v);
        }
        break;
      }
      if (inner == kIterCap) break;
      ++inner;
      ++step;
    }
    if (!done && l == 0) {                 // the inner loop's cap
      const int v[kRows] = {
          0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, flags | kFlagIter, 0,
          evals, inner, work.quantized, work.costed, work.quads,
          work.pairs};
      write_rows(a, lane, v);
    } else if (!need && l == 0) {          // a silent lane
      const int v[kRows] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
                            0, 0, 0, 0, 0, 0};
      write_rows(a, lane, v);
    }
    int* out = a.ix + static_cast<long long>(lane) * kSamples;
    const int2* x2 = reinterpret_cast<const int2*>(xs);
    const int2* ix2 = reinterpret_cast<const int2*>(ixs);
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int2 x = x2[l + 32 * j];
      const int2 q = ix2[l + 32 * j];
      const bool keep = need && done;
      out[2 * (l + 32 * j)] = !keep ? 0 : x.x < 0
          ? static_cast<int>(0u - static_cast<unsigned>(q.x)) : q.x;
      out[2 * (l + 32 * j) + 1] = !keep ? 0 : x.y < 0
          ? static_cast<int>(0u - static_cast<unsigned>(q.y)) : q.y;
    }
  }
}

// Above 48 KB a launch may use dynamic shared memory only up to the
// kernel's raised limit.
cudaError_t raise_smem_limit() {
  return cudaFuncSetAttribute(rate_search_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

}  // namespace

// The CTAs of rate_search_kernel an SM holds at its dynamic shared memory
// (the runtime's occupancy query), its warps a CTA and its bytes of shared
// memory a CTA; returns the CUDA error (0 = success).
extern "C" int rate_search_occupancy(int* ctas, int* warps, int* smem) {
  cudaError_t err = raise_smem_limit();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, rate_search_kernel, kThreads, kSmemBytes);
  }
  *warps = kWarps;
  *smem = kSmemBytes;
  return static_cast<int>(err);
}

// Launch on `stream` and return cudaGetLastError() (0 = launched). Device
// pointers; xr (n, 576) int32 and max_bits (n,) int32 C-contiguous; in hide
// mode hbits (hbuf,) uint8 with n_bits message bits and, unless `windows`,
// hcur (n,) int64. Mode 0 writes rows (21, m) int32 (ROWS, then the counts
// evals, inner, quantized, costed, quads, pairs) and ix (m, 576) int32;
// mode 1 writes cost (n,) int64. `blocks` CTAs of 8 warps take the m
// lanes one at a time from `queue`, one int32 that must be 0 at launch.
extern "C" int rate_search(const void* xr, const void* max_bits, int n, int m,
                           int windows, const void* hbits, long long hbuf,
                           long long n_bits, const void* hcur, int mode,
                           int step, long long big, const void* steptab,
                           const void* steptabi, const void* small,
                           const void* int2idx, const void* hlen, void* rows,
                           void* ix, void* cost, void* queue, int blocks,
                           void* stream) {
  if (n <= 0 || m <= 0 || blocks <= 0 || (windows && m != 8 * n)
      || (!windows && m != n) || (mode == 0 && (!max_bits || !rows || !ix))
      || (mode == 1 && (!cost || hbits)) || (hbits && hbuf <= 0)
      || (hbits && !windows && !hcur) || !queue) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = raise_smem_limit();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.xr = static_cast<const int*>(xr);
  a.max_bits = static_cast<const int*>(max_bits);
  a.n = n;
  a.m = m;
  a.windows = windows;
  a.hbits = static_cast<const unsigned char*>(hbits);
  a.hbuf = hbuf;
  a.n_bits = n_bits;
  a.hcur = static_cast<const long long*>(hcur);
  a.mode = mode;
  a.step = step;
  a.big = big;
  a.steptab = static_cast<const double*>(steptab);
  a.steptabi = static_cast<const int*>(steptabi);
  a.small = static_cast<const int*>(small);
  a.int2idx = static_cast<const short*>(int2idx);
  a.hlen = static_cast<const unsigned char*>(hlen);
  a.rows = static_cast<int*>(rows);
  a.ix = static_cast<int*>(ix);
  a.cost = static_cast<long long*>(cost);
  a.queue = static_cast<int*>(queue);
  rate_search_kernel<<<blocks, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
