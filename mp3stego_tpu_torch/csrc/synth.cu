// Fused polyphase synthesis of the MP3 decode plane (kernel K1), written by
// hand for Hopper (sm_90a), in float and in double.
//
// Replaces the TPU kernel mp3stego_tpu/ops/pallas_kernels.py::_fir_kernel
// (launched by _synth_fir_128, driven by synth_fir_host), and with it the
// overlap-add, frequency inversion and synthesis-V matmul that surround it in
// the JAX plane (mp3stego_tpu/ops/decode_plane.py::synth_from_blocks). Its
// plain PyTorch version is mp3stego_tpu_torch/ops/synth.py::synth_fused_torch.
//
// Per row (one (file, channel) pair), from the IMDCT blocks blk (rows, T, 32,
// 36), C-contiguous, and an optional halo (rows, 2, 32, 36): the blocks of
// granules -2 and -1 of each row, where a row continues a stream that began
// before it (a time range of a frame-sharded decode); without one, granules
// before 0 are zeros (the stream's start):
//   1. y[g][i][s] = blk[g][i][s] + blk[g-1][i][18+s]
//   2. y *= -1 where band i and sub-step s are both odd (frequency inversion)
//   3. st[18g+s][i] = y[g][i][s]                        (step major)
//   4. V[r][k] = sum_{i=0..31} st[r][i] * N[k][i]         (N: 64x32)
//   5. pcm[r][k] = sum_{j=0..15} D[j][k] * V[r-j][32*(j%2)+k], V[<0] = 0
// Both sums run in ascending order from +0 with every product and every sum
// rounded on its own (__fmul_rn/__fadd_rn, __dmul_rn/__dadd_rn; the file is
// built with --fmad=false), which is the order of the plain version and of the
// float64 NumPy plane (decode_granules_np), so the kernel equals them bit for
// bit. No tensor cores: TF32 and DMMA would round differently.
//
// Epilogue, one of two: float PCM (rows, T, 576), or int16 interleaved per
// file (files, T*576, channels) with row = file*channels + channel, through
// v*32767 saturated to [-32768, 32767] (or left to wrap, the reference's
// conversion) and truncated toward zero, as the plain to_i16 does.
//
// What bounds it: operations. Per sub-step it does 64x32 + 32x16 = 2,560
// multiply-adds, each two instructions with FMA off: 92,160 per granule,
// against 1,152 values of blk read and 576 int16 written per granule, i.e.
// 16 operations per byte in float and 8.9 in double, above the card's ~10
// (float) and ~5 (double) lane operations per byte of HBM. So V and the FIR
// history never leave shared memory: nothing but blk and the output touches
// HBM.
//
// Design: one CTA per (row, tile of G granules), 256 threads. The grid runs
// a file's channels of one tile side by side (x = tile * channels +
// channel, y = file), so the two halves of each interleaved int16 sector are
// written close in time and meet in L2.
//   A. cp.async copies granules g0-2 .. g0+G-1 of the row (contiguous in
//      memory) into a shared slab; the FIR's 15 history steps live in g0-1,
//      whose y needs g0-2's tail. Granules -2 and -1 come from the halo when
//      there is one; other granules outside [0, T) are zeros. So the output
//      of a row with a halo is bit for bit that of the row [halo | blk]
//      from its start, less its first two granules.
//   B. the overlap-add and sign build st (18(G+1) rows x 32) in shared memory.
//   C. V for the tile's 18G steps and the 15 history steps, into shared
//      memory over the dead slab; each thread keeps one column of N in
//      registers and reads st rows as broadcast 16-byte loads.
//   D. the FIR; each thread keeps one column of D in registers and sums Q
//      outputs of one parity, whose taps read the same V halves, from a
//      window of 2Q+14 V values in registers.
// The halo costs (18G+15)/(18G) of the V work: 10 % at G = 8 (float), 21 %
// at G = 4 (double, where shared memory holds fewer granules per CTA).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBands = 32;                 // subbands = output columns
constexpr int kSteps = 18;                 // sub-steps per granule
constexpr int kBlk = 36;                   // IMDCT block per band
constexpr int kGranule = kBands * kBlk;    // 1,152 values of blk a granule
constexpr int kVWidth = 64;
constexpr int kTaps = 16;
constexpr int kHalo = 15;

// G granules per CTA, Q outputs of one parity per thread in the FIR, and the
// CTAs an SM should hold (register cap)
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int G = 8, Q = 9, kMinBlocks = 3;
};
template <>
struct Cfg<double> {
  static constexpr int G = 4, Q = 3, kMinBlocks = 2;
};

template <typename T>
__host__ __device__ constexpr int slab_len() { return (Cfg<T>::G + 2) * kGranule; }
template <typename T>
__host__ __device__ constexpr int st_rows() { return kSteps * (Cfg<T>::G + 1); }
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  // the slab, then st with one zero pad row (read by the last V pair)
  return sizeof(T) * (slab_len<T>() + (st_rows<T>() + 1) * kBands);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ int16_t to_i16(float v, bool wrap) {
  float x = __fmul_rn(v, 32767.0f);
  if (!wrap) x = fminf(fmaxf(x, -32768.0f), 32767.0f);
  return static_cast<int16_t>(__float2int_rz(x));
}
__device__ __forceinline__ int16_t to_i16(double v, bool wrap) {
  double x = __dmul_rn(v, 32767.0);
  if (!wrap) x = x > 32767.0 ? 32767.0 : (x < -32768.0 ? -32768.0 : x);
  return static_cast<int16_t>(__double2int_rz(x));
}

// 16 bytes of shared memory as T values
template <typename T>
__device__ __forceinline__ void ld16(T (&dst)[16 / sizeof(T)], const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    dst[0] = q.x; dst[1] = q.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Cfg<T>::kMinBlocks)
synth_fused_kernel(const T* __restrict__ blk, const T* __restrict__ halo,
                   const T* __restrict__ n_t,
                   const T* __restrict__ window, void* __restrict__ out,
                   int64_t t_len, int out_i16, int channels, int wrap) {
  constexpr int G = Cfg<T>::G;
  constexpr int Q = Cfg<T>::Q;
  constexpr int kVec = 16 / sizeof(T);                // values per 16 bytes
  constexpr int kVRows = kSteps * G + kHalo + 1;      // V rows, even
  constexpr int kOut = kSteps * G;                    // output steps a tile
  static_assert(kVRows * kVWidth <= slab_len<T>(), "V must fit the slab");
  static_assert(kOut % (2 * Q) == 0, "FIR jobs must tile the outputs");
  static_assert(kGranule % kVec == 0, "a copy must not straddle granules");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);
  T* st = slab + slab_len<T>();
  T* v = slab;                       // overlays the slab once st is built

  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x / channels;
  const int64_t chan = blockIdx.x - tile * channels;
  const int64_t f = blockIdx.y;
  const int64_t row = f * channels + chan;
  const int64_t g0 = tile * G;
  const T* src = blk + row * t_len * kGranule;

  // A. granules g0-2 .. g0+G-1 of this row; -2 and -1 from the halo if
  // there is one, zeros elsewhere outside [0, T)
  for (int c = tid; c < slab_len<T>() / kVec; c += kThreads) {
    const int sg = c * kVec / kGranule;
    const int64_t g = g0 - 2 + sg;
    const int off = c * kVec - sg * kGranule;
    T* dst = slab + c * kVec;
    if (g >= 0 && g < t_len) {
      cp_async16(dst, src + g * kGranule + off);
    } else if (g < 0 && halo != nullptr) {
      cp_async16(dst, halo + (row * 2 + (g + 2)) * kGranule + off);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = T(0);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // B. st row r = 18 gl + s is sub-step s of granule g0 - 1 + gl, whose blk
  // is slab granule gl + 1 and whose predecessor's is slab granule gl
  for (int e = tid; e < st_rows<T>() * kBands; e += kThreads) {
    const int i = e & (kBands - 1);
    const int r = e / kBands;
    const int gl = r / kSteps;
    const int s = r - gl * kSteps;
    const T head = slab[(gl + 1) * kGranule + i * kBlk + s];
    const T prev = slab[gl * kGranule + i * kBlk + kSteps + s];
    const T sign = ((i & s) & 1) ? T(-1) : T(1);
    st[e] = mul_rn(add_rn(head, prev), sign);
  }
  if (tid < kBands) st[st_rows<T>() * kBands + tid] = T(0);
  __syncthreads();

  // C. V row vr is step 18 g0 - 15 + vr, i.e. st row vr + 3; two rows a
  // pass for two independent sums
  {
    const int k = tid & (kVWidth - 1);
    T n[kBands];
#pragma unroll
    for (int i = 0; i < kBands; ++i) n[i] = n_t[i * kVWidth + k];
    for (int vr = 2 * (tid / kVWidth); vr < kVRows;
         vr += 2 * (kThreads / kVWidth)) {
      const T* s0 = st + (vr + 3) * kBands;
      T a0 = T(0), a1 = T(0);
#pragma unroll
      for (int i = 0; i < kBands; i += kVec) {
        T x0[kVec], x1[kVec];
        ld16<T>(x0, s0 + i);
        ld16<T>(x1, s0 + kBands + i);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          a0 = add_rn(a0, mul_rn(x0[e], n[i + e]));
          a1 = add_rn(a1, mul_rn(x1[e], n[i + e]));
        }
      }
      v[vr * kVWidth + k] = a0;
      v[(vr + 1) * kVWidth + k] = a1;
    }
  }
  __syncthreads();

  // D. output o (step 18 g0 + o) reads tap j from V row o + 15 - j. A job is
  // Q outputs o0 + 2q of one parity: they read V rows o0 .. o0 + 2Q + 13,
  // row o0 + t always in half (t + 1) % 2
  const int k = tid & (kBands - 1);
  T d[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) d[j] = window[j * kBands + k];
  const int64_t left = (t_len - g0) * kSteps;
  const int valid = left < kOut ? static_cast<int>(left) : kOut;
  for (int job = tid / 32; job < kOut / Q; job += kThreads / 32) {
    const int o0 = (job >> 1) * 2 * Q + (job & 1);
    T w[2 * Q + 14];
#pragma unroll
    for (int t = 0; t < 2 * Q + 14; ++t) {
      w[t] = v[(o0 + t) * kVWidth + ((t + 1) & 1) * kBands + k];
    }
    T acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = T(0);
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        acc[q] = add_rn(acc[q], mul_rn(d[j], w[2 * q + 15 - j]));
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int o = o0 + 2 * q;
      if (o >= valid) continue;
      const int64_t step = g0 * kSteps + o;
      if (out_i16) {
        int16_t* o16 = static_cast<int16_t*>(out);
        o16[((f * t_len * kSteps + step) * kBands + k) * channels + chan] =
            to_i16(acc[q], wrap != 0);
      } else {
        static_cast<T*>(out)[(row * t_len * kSteps + step) * kBands + k] = acc[q];
      }
    }
  }
}

template <typename T>
int launch(const void* blk, const void* halo, const void* n_t,
           const void* window, void* out,
           int rows, long long t_len, int out_i16, int channels, int wrap,
           void* stream) {
  if (rows <= 0 || rows > 65535 || t_len <= 0 || channels <= 0
      || rows % channels != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      synth_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  constexpr int G = Cfg<T>::G;
  const long long tiles = (t_len + G - 1) / G;
  if (tiles * channels > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(tiles * channels),
                  static_cast<unsigned>(rows / channels));
  synth_fused_kernel<T><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blk), static_cast<const T*>(halo),
      static_cast<const T*>(n_t),
      static_cast<const T*>(window), out, static_cast<int64_t>(t_len),
      out_i16, channels, wrap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 = launched). Device
// pointers: blk (rows, t_len, 32, 36), halo (rows, 2, 32, 36) or null (zeros
// before granule 0), n_t = N transposed (32, 64), window (16, 32), all of
// the entry's type and C-contiguous, blk and halo 16-byte aligned; out is
// (rows, t_len, 576) of that type when out_i16 == 0, else int16 (rows /
// channels, t_len * 576, channels). The caller allocates out.
extern "C" int synth_fused_f32(const void* blk, const void* halo,
                               const void* n_t, const void* window, void* out,
                               int rows, long long t_len, int out_i16,
                               int channels, int wrap, void* stream) {
  return launch<float>(blk, halo, n_t, window, out, rows, t_len, out_i16,
                       channels, wrap, stream);
}

extern "C" int synth_fused_f64(const void* blk, const void* halo,
                               const void* n_t, const void* window, void* out,
                               int rows, long long t_len, int out_i16,
                               int channels, int wrap, void* stream) {
  return launch<double>(blk, halo, n_t, window, out, rows, t_len, out_i16,
                        channels, wrap, stream);
}

// The tile of a launch, for the record: granules per CTA and dynamic shared
// memory bytes per CTA of the float (f64 = 0) or double (f64 = 1) kernel.
extern "C" int synth_fused_tile(int f64, int* granules, int* smem) {
  *granules = f64 ? Cfg<double>::G : Cfg<float>::G;
  *smem = static_cast<int>(f64 ? smem_bytes<double>() : smem_bytes<float>());
  return 0;
}
