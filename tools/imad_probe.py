#!/usr/bin/env python3
"""The card's rate of the integer multiply-adds K3 is made of.

    python3 tools/imad_probe.py [--out chiprun_out/imad_probe.json]

Run from the root of a checkout, on one CUDA card. It builds a small probe
with the flags of ``mp3stego_tpu_torch/ops/_cuda.py`` and times two loops
on every SM at full occupancy: ``acc += __mulhi(a, b)`` (what each Q31
product of ``csrc/analysis.cu`` is; sm_90a issues it as one ``IMAD.HI``
whose addend is a register pair) and ``acc += a * b`` (one ``IMAD``), each
thread with 8 independent accumulators. Each block reads its SM's cycle
counter at its start and end, so the record gives the lanes a cycle an SM
(64 would be the INT32 pipe's full rate), beside the operations a second by
CUDA events and the SASS count of each loop (``cuobjdump``). It prints the
card's ``nvidia-smi`` name and power limit and the record as JSON.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

import encode_vs_parent as evp
import vs_parent

sys.path.insert(0, vs_parent.REPO)
from mp3stego_tpu_torch.ops import _cuda  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
constexpr int kUnroll = 16;

template <bool kHigh>
__global__ void __launch_bounds__(256) probe(const int* in, int* out,
                                             long long* cycles, int iters) {
  const long long t0 = clock64();
  int a[8];
  unsigned acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = in[(threadIdx.x + 37 * i) & 1023];
    acc[i] = 0;
  }
  int b = in[blockIdx.x & 1023];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i] += kHigh ? static_cast<unsigned>(__mulhi(a[i], b))
                        : static_cast<unsigned>(a[i] * b);
      }
      b ^= r + 1;
    }
  }
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<int>(s);
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
}

extern "C" int run_probe(int high, const void* in, void* out, void* cycles,
                         int blocks, int iters) {
  if (high) {
    probe<true><<<blocks, 256>>>(static_cast<const int*>(in),
                                 static_cast<int*>(out),
                                 static_cast<long long*>(cycles), iters);
  } else {
    probe<false><<<blocks, 256>>>(static_cast<const int*>(in),
                                  static_cast<int*>(out),
                                  static_cast<long long*>(cycles), iters);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        vs_parent.REPO, "chiprun_out", "imad_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible to torch")
    card = vs_parent.card_line()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "probe.cu")
        so = os.path.join(d, "libprobe.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so, src],
                       check=True, capture_output=True, text=True,
                       timeout=600)
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([tool, "-sass", so], capture_output=True,
                              text=True, timeout=300).stdout
        lib = ctypes.CDLL(so)
        lib.run_probe.restype = ctypes.c_int
        lib.run_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 2
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = sms * 8                         # 2,048 threads an SM
        iters = 4096
        inp = torch.randint(-2 ** 31, 2 ** 31 - 1, (1024,), dtype=torch.int32,
                            device=dev)
        out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
        cycles = torch.empty(blocks, dtype=torch.int64, device=dev)
        record = dict(card=card, torch=torch.__version__, sms=sms,
                      blocks=blocks, threads=256, iters=iters)
        for name, high in (("IMAD.HI (acc += __mulhi(a, b))", 1),
                           ("IMAD (acc += a * b)", 0)):
            for _ in range(2):                   # warm-up, then timed
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                rc = lib.run_probe(high, inp.data_ptr(), out.data_ptr(),
                                   cycles.data_ptr(), blocks, iters)
                end.record()
                end.synchronize()
                if rc:
                    raise RuntimeError(f"probe launch failed: {rc}")
            ms = start.elapsed_time(end)
            ops = blocks * 256 * iters * 16 * 8
            cyc = cycles.double()
            record[name] = dict(
                ms=ms, ops_per_s=ops / ms * 1e3,
                lanes_per_cycle_per_sm=ops / sms / float(cyc.max()),
                block_cycles_mean=float(cyc.mean()),
                block_cycles_max=float(cyc.max()))
        for kernel, key in (("probeILb1", "sass IMAD.HI loop"),
                            ("probeILb0", "sass IMAD loop")):
            loops = evp.sass_loops(sass, kernel)["loops"]
            record[key] = max(loops, key=lambda x: x["instructions"]) \
                if loops else None
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
