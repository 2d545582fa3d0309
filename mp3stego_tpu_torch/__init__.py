"""mp3stego_tpu_torch — the PyTorch + CUDA port of mp3stego_tpu.

A second package beside the JAX one, which stays the reference: each slice
of the port is held against ``mp3stego_tpu`` on the same inputs. This
package imports ``torch`` and never ``jax``, and needs nothing of
``mp3stego_tpu``: it keeps its own copies of the constant pack
(``tables/iso_tables.npz``) and the C++ host sources (``native/src/*.cpp``).

Every entry point of the JAX package is ported: the decode path (MP3 ->
WAV, and reveal) in float64 and float32, and the encode path (WAV -> MP3,
CBR and VBR, hide, clear, capacity), the batched decode and encode over
many files (``parallel``), the streaming decode and encode
(``models.streaming``) and the CLI (``python -m mp3stego_tpu_torch``). On
the card their numeric planes are hand-written CUDA kernels for Hopper
(``csrc/``): the decode granule plane (``granule.cu``), the synthesis
(``synth.cu``: overlap-add, V matmul, 16-tap FIR, int16), the Huffman
bit-scan (``huffman.cu``), the Q31 encode analysis (``analysis.cu``) and the
exact float64 rate search (``search.cu``).

    from mp3stego_tpu_torch import Steganography, Decoder, Encoder
"""

def _tune_host_allocator():
    """Keep glibc from munmapping large buffers on free.

    By default glibc serves >128 KB allocations with mmap and returns them to
    the kernel on free, so every large NumPy temp / device-fetch destination
    re-faults its pages. On virtualized hosts with slow page faults that can
    dominate the whole pipeline. Raising M_MMAP_THRESHOLD / M_TRIM_THRESHOLD
    keeps the heap warm — repeated large allocations run at memory speed.
    Trade-off: peak RSS stays allocated; disable with MP3STEGO_TPU_MALLOC_TUNE=0.
    """
    import ctypes
    import os
    if os.environ.get("MP3STEGO_TPU_MALLOC_TUNE", "1") != "1":
        return
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
    except Exception:  # noqa: BLE001 - non-glibc platforms: default malloc
        pass


_tune_host_allocator()

from mp3stego_tpu_torch.models.decoder import Decoder              # noqa: E402
from mp3stego_tpu_torch.models.encoder import Encoder              # noqa: E402
from mp3stego_tpu_torch.steganography import (Steganography,        # noqa: E402
                                              str_to_binary_str)

__version__ = "0.1.0"

__all__ = ["Steganography", "Decoder", "Encoder", "str_to_binary_str"]
