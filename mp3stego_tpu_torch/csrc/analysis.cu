// Q31 encode analysis of the MP3 encode path (kernel K3), written by hand for
// Hopper (sm_90a): polyphase window, 32-band filter with the analysis
// inversion, the 36 -> 18 MDCT per band and the alias butterflies.
//
// Replaces the JAX package's mp3stego_tpu/ops/encode_plane.py::analysis_mdct
// (:35), an XLA program (dense gathers, products and reductions over the
// whole stream; not a pallas_call). Its plain PyTorch version is
// mp3stego_tpu_torch/ops/encode_plane.py::analysis_stream_torch; the kernel
// equals it bit for bit, and the host C++ twin native/src/encode_plane.cpp
// (encode_analysis), whose arithmetic it copies. Per channel stream s of
// int16 samples (480 of history in front), window step t and granule g:
//
//   tmp[t][i] = sum_k mulhi(s[32 t + 511 - 64 k - i] << 16, en[64 k + i])
//   sb[t][b]  = sum_j mulhi(fl[b][j], tmp[t][j]), negated (0u - v) where
//               t % 18 and b are both odd
//   freq[g][b][l] = sum_m mulhi(in[b][m], cos[l][m]),
//               in[b] = [sb(g - 1) ; sb(g)] over 36 steps, sb(-1) = 0
//   alias:   for b >= 1, i < 8, from the unmodified MDCT outputs
//            bu = freq[b][i], bd = freq[b - 1][17 - i]:
//            freq[b][i]        = (bu cs[i] - bd ca[i]) >> 31
//            freq[b - 1][17 - i] = (bu ca[i] + bd cs[i]) >> 31   (int64)
//
// Exactness. mulhi is __mulhi, the high word of the 64-bit product, which is
// fx.mul's int32((int64 a * int64 b) >> 32) for int32 operands (the window
// table fits int32; the wrapper checks). Sums are uint32 and wrap mod 2^32,
// so no summation order can change a bit. The butterflies take their int64
// differences in unsigned arithmetic (a sum may reach 2^63) and shift the
// int64 result right by 31 arithmetically, keeping the low 32 bits.
//
// What bounds it on this card: operations. Per (channel, granule) the
// function takes 66,816 Q31 products (window 18 x 512, filter 18 x 32 x 64,
// MDCT 32 x 18 x 36), each a multiply-high and an add, and 248 butterflies
// of 8 operations: 135,616 integer operations. The 240.7 s song (2 x 18,432
// granules) needs 5.0 G of them, 0.30 ms at 16.75 T int32 ops/s; its bytes
// (42.5 MB of int16 read, 84.9 MB of int32 written) take 0.04 ms.
//
// Design. One CTA of 8 warps takes one channel's block of kG = 8 output
// granules and recomputes the window and filter of the granule before them
// (the MDCT's context; 1/8 more of that work), so CTAs share nothing. The
// CTA stages its (kG + 1) * 576 + 480 int16 samples in shared memory, then
// (1) the window: thread i of 64 keeps its 8 taps en[64 k + i] in
// registers, 64 outputs a step are 64 threads; (2) the filter: lane b keeps
// the band's 64 filter taps in registers and reads each tmp row as 16
// broadcast int4 loads, two steps at a time; (3) the MDCT: warp w takes
// granule w, lane b its band, with the 18 x 36 cosines compile-time operands
// from the launch's parameter space (constant memory); (4) the butterflies
// pair lane b with lanes b - 1 and b + 1 by shuffles, from the MDCT outputs
// in registers; (5) each warp writes its granule through shared memory as
// 18 coalesced 128-byte rows in the plane's layout out[ch][g][18 b + l]. The
// upshift by 16 is done in registers, so the stream crosses as int16 and
// is never widened in device memory. Tensor cores, TMA and warp
// specialisation are left for later.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kG = 8;                          // output granules per CTA
constexpr int kWarps = 8;                      // one granule per warp (MDCT)
constexpr int kThreads = 32 * kWarps;
constexpr int kPast = 480;                     // window history per stream
constexpr int kSteps = (kG + 1) * 18;          // window steps, context first
constexpr int kSamples = (kG + 1) * 576 + kPast;
constexpr size_t kSmem = sizeof(int) * kSteps * 64      // tmp
                         + sizeof(int) * kSteps * 32    // sb
                         + sizeof(short) * kSamples;    // samples

static_assert(kWarps == kG, "the MDCT takes one granule per warp");
static_assert(kG * 576 <= kSteps * 64, "a granule per warp fits in tmp");

struct Params {
  const short* pcm;        // (channels, stride) int16
  const int* window;       // (512,) the analysis window, int32
  const int* filter;       // (32, 64) the subband filter
  int* out;                // (channels, n_out, 576)
  long long stride;        // 480 + tg * 576
  long long tg;            // granules in the stream
  long long n_out;         // tg - skip
  int skip;                // granules of context in front of the first output
  int cos_l[18 * 36];      // MDCT cosines [l][m]
  int cs[8];               // alias butterfly coefficients
  int ca[8];
};

__device__ __forceinline__ unsigned mulhi(int a, int b) {
  return static_cast<unsigned>(__mulhi(a, b));
}

// int32 of (v >> 31) for the int64 bit pattern v
__device__ __forceinline__ int shr31(unsigned long long v) {
  return static_cast<int>(static_cast<unsigned>(
      static_cast<unsigned long long>(static_cast<long long>(v) >> 31)));
}

__device__ __forceinline__ unsigned long long wide(int a, int b) {
  return static_cast<unsigned long long>(static_cast<long long>(a) * b);
}

// the analysis inversion: odd step within the granule, odd band
__device__ __forceinline__ int invert(unsigned v, int step, int band) {
  return static_cast<int>((step % 18 & 1) && (band & 1) ? 0u - v : v);
}

__global__ void __launch_bounds__(kThreads, 2)
analysis_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tmp = reinterpret_cast<int*>(smem);                  // [kSteps][64]
  int* sb = tmp + kSteps * 64;                              // [kSteps][32]
  short* pcm = reinterpret_cast<short*>(sb + kSteps * 32);  // [kSamples]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long g0 = p.skip + static_cast<long long>(blockIdx.x) * kG;
  const int ng = static_cast<int>(min(static_cast<long long>(kG), p.tg - g0));
  const int steps = (ng + 1) * 18;             // local steps, context first
  // granule 0 of the stream reads a zero previous granule
  const int first = g0 == 0 ? 18 : 0;
  const long long base = (g0 - 1) * 576;       // stream index of sample 0
  const short* src = p.pcm + blockIdx.y * p.stride;

  // ---- the CTA's samples; none before the stream
  for (int x = tid; x < steps * 32 + kPast; x += kThreads) {
    const long long at = base + x;
    pcm[x] = at >= 0 ? src[at] : short(0);
  }
  __syncthreads();

  // ---- (1) window: tmp[t][i], 8 taps a thread in registers
  {
    const int i = tid & 63;
    int en[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) en[k] = p.window[64 * k + i];
    for (int t = first + (tid >> 6); t < steps; t += kThreads / 64) {
      const short* s = pcm + 32 * t + 511 - i;
      unsigned acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += mulhi(int(s[-64 * k]) * 65536, en[k]);
      tmp[t * 64 + i] = static_cast<int>(acc);
    }
  }
  __syncthreads();

  // ---- (2) the 32-band filter and the inversion: sb[t][b], lane b
  {
    int f[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) f[j] = p.filter[lane * 64 + j];
    // first and steps are multiples of 18, so t + 1 < steps
    for (int t = first + 2 * warp; t < steps; t += 2 * kWarps) {
      const int4* r0 = reinterpret_cast<const int4*>(tmp + t * 64);
      const int4* r1 = r0 + 16;
      unsigned a0 = 0, a1 = 0;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int4 u = r0[q];
        const int4 v = r1[q];
        a0 += mulhi(f[4 * q], u.x) + mulhi(f[4 * q + 1], u.y)
              + mulhi(f[4 * q + 2], u.z) + mulhi(f[4 * q + 3], u.w);
        a1 += mulhi(f[4 * q], v.x) + mulhi(f[4 * q + 1], v.y)
              + mulhi(f[4 * q + 2], v.z) + mulhi(f[4 * q + 3], v.w);
      }
      sb[t * 32 + lane] = invert(a0, t, lane);
      sb[(t + 1) * 32 + lane] = invert(a1, t + 1, lane);
    }
    for (int x = tid; x < first * 32; x += kThreads) sb[x] = 0;
  }
  __syncthreads();

  // ---- (3)-(5) warp w: output granule g0 + w, lane b: band b
  if (warp >= ng) return;
  const int b = lane;
  unsigned acc[18];
#pragma unroll
  for (int l = 0; l < 18; ++l) acc[l] = 0;
  const int* in = sb + warp * 18 * 32 + b;     // [sb(g - 1) ; sb(g)]
#pragma unroll
  for (int m = 0; m < 36; ++m) {
    const int x = in[m * 32];
#pragma unroll
    for (int l = 0; l < 18; ++l) acc[l] += mulhi(x, p.cos_l[l * 36 + m]);
  }
  int y[18], z[18];
#pragma unroll
  for (int l = 0; l < 18; ++l) z[l] = y[l] = static_cast<int>(acc[l]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int bd_prev = __shfl_up_sync(0xffffffffu, y[17 - i], 1);
    const int bu_next = __shfl_down_sync(0xffffffffu, y[i], 1);
    if (b > 0) z[i] = shr31(wide(y[i], p.cs[i]) - wide(bd_prev, p.ca[i]));
    if (b < 31) {
      z[17 - i] = shr31(wide(bu_next, p.ca[i]) + wide(y[17 - i], p.cs[i]));
    }
  }
  int* fw = tmp + warp * 576;                  // tmp is free after (2)
#pragma unroll
  for (int l = 0; l < 18; ++l) fw[b * 18 + l] = z[l];
  __syncwarp();
  int* dst = p.out + (blockIdx.y * p.n_out + (g0 + warp - p.skip)) * 576;
#pragma unroll
  for (int r = 0; r < 18; ++r) dst[r * 32 + lane] = fw[r * 32 + lane];
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 = launched). Device
// pointers: pcm (channels, 480 + tg * 576) int16 C-contiguous, window (512,)
// and filter (32, 64) int32, out (channels, tg - skip, 576) int32, which the
// caller allocates. Host pointers: cos_l (18, 36), cs8 and ca8 (8,) int32,
// copied into the launch's parameters. Granules skip .. tg - 1 are written;
// granule 0 reads a zero previous granule, every other one the granule
// before it.
extern "C" int analysis_mdct(const void* pcm, int channels, long long tg,
                             int skip, const void* window, const void* filter,
                             const int* cos_l, const int* cs8, const int* ca8,
                             void* out, void* stream) {
  if (!pcm || !window || !filter || !cos_l || !cs8 || !ca8 || !out
      || channels <= 0 || channels > 65535 || skip < 0 || tg <= skip) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (tg - skip + kG - 1) / kG;
  if (tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.pcm = static_cast<const short*>(pcm);
  p.window = static_cast<const int*>(window);
  p.filter = static_cast<const int*>(filter);
  p.out = static_cast<int*>(out);
  p.stride = kPast + tg * 576;
  p.tg = tg;
  p.n_out = tg - skip;
  p.skip = skip;
  for (int x = 0; x < 18 * 36; ++x) p.cos_l[x] = cos_l[x];
  for (int i = 0; i < 8; ++i) {
    p.cs[i] = cs8[i];
    p.ca[i] = ca8[i];
  }
  const cudaError_t err = cudaFuncSetAttribute(
      analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(channels));
  analysis_kernel<<<grid, kThreads, kSmem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tile of a launch, for the record: output granules and dynamic shared
// memory bytes per CTA.
extern "C" int analysis_tile(int* granules, int* smem) {
  *granules = kG;
  *smem = static_cast<int>(kSmem);
  return 0;
}
