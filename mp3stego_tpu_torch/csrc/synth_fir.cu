// Synthesis FIR of the MP3 decode plane, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel mp3stego_tpu/ops/pallas_kernels.py::_fir_kernel
// (launched by _synth_fir_128, driven by synth_fir_host). Its plain PyTorch
// version is mp3stego_tpu_torch/ops/synth_fir.py::synth_fir_torch.
//
//   pcm[c, t, k] = sum_{j=0..15} D[j, k] * v_ext[c, t + 15 - j, 32 * (j % 2) + k]
//
// v_ext is (ch, 15 + S, 64) float32, C-contiguous: 15 rows of V history in
// front of the S synthesis sub-steps. D is the (16, 32) ISO synthesis window.
// pcm is (ch, S, 32) float32.
//
// What bounds it: memory traffic. Per sub-step it reads one 64-float V row
// and writes 32 floats, with 16 multiply-adds per output (about 1 FLOP per
// byte moved, far below the card's compute roof). Each V value is read by the
// 8 output rows of its tap parity; those re-reads hit L1/L2, so device memory
// sees each V row about once.
//
// Design, simple first: one warp per output row, lane k computes column k, so
// every tap load and the store are one coalesced 128-byte access. D sits in
// shared memory. No halo exchange: a block reads rows t..t+15 of v_ext
// directly, and v_ext already carries the 15 history rows (the TPU kernel's
// padded 16th halo row and its 128-lane repack are not needed here).
//
// Summation order: acc starts at +0.0f and adds the taps in ascending j, each
// product and each sum rounded on its own (__fmul_rn / __fadd_rn, and the
// file is built with --fmad=false). That is the order of the plain version
// (pcm = pcm + d[j] * src, two eager ops per tap), so the kernel equals it
// bit for bit, the sign of zero included.
//
// Next step (not done here): fuse the synthesis V matmul and the int16
// epilogue so that V never reaches device memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 16;
constexpr int kLanes = 32;           // output columns = one warp
constexpr int kVWidth = 64;          // V row: 32 even-tap + 32 odd-tap lanes
constexpr int kHalo = 15;
constexpr int kRowsPerBlock = 8;     // one warp per output row

__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
synth_fir_kernel(const float* __restrict__ v_ext,
                 const float* __restrict__ window,
                 float* __restrict__ pcm, int64_t s_total) {
  __shared__ float d[kTaps * kLanes];
  const int k = threadIdx.x;
  for (int i = threadIdx.y * kLanes + k; i < kTaps * kLanes;
       i += kLanes * kRowsPerBlock) {
    d[i] = window[i];
  }
  __syncthreads();

  const int64_t t = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (t >= s_total) {
    return;
  }
  const int64_t c = blockIdx.y;
  // row t + 15 of this channel's v_ext is sub-step t's own V row
  const float* v = v_ext + (c * (s_total + kHalo) + t + kHalo) * kVWidth + k;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    const float x = __ldg(v - static_cast<int64_t>(j) * kVWidth + (j & 1) * kLanes);
    acc = __fadd_rn(acc, __fmul_rn(d[j * kLanes + k], x));
  }
  pcm[(c * s_total + t) * kLanes + k] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// All pointers are device pointers; the caller allocates pcm.
extern "C" int synth_fir_f32(const void* v_ext, const void* window, void* pcm,
                             int channels, long long s_total, void* stream) {
  if (channels <= 0 || channels > 65535 || s_total <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kLanes, kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>((s_total + kRowsPerBlock - 1) / kRowsPerBlock),
                  static_cast<unsigned>(channels));
  synth_fir_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v_ext), static_cast<const float*>(window),
      static_cast<float*>(pcm), static_cast<int64_t>(s_total));
  return static_cast<int>(cudaGetLastError());
}
