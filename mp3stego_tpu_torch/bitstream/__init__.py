"""Host bitstream plane: irregular, variable-length, sequential parsing/serialization.

Everything dense and numeric lives in ``mp3stego_tpu_torch.ops`` (the torch plane);
this package owns byte/bit-level work: ID3, frame headers, side info, the bit
reservoir, Huffman symbol decode/encode and bitstream assembly. A native C++
fast path (``mp3stego_tpu_torch.native``) accelerates the hot loops; pure-NumPy
fallbacks keep every entry point functional without the native library.
"""

from mp3stego_tpu_torch.bitstream.bits import BitReader, BitWriter  # noqa: F401
