"""The least time the card could take for K2's and K1's float32 work on a
long-block file (``song320``), from the file's shapes alone: the H100
SXM's published 3.35 TB/s of HBM and 67 TFLOP/s float32 outside the
tensor cores (NVIDIA's data sheet, at its 700 W limit), which counts a
fused multiply-add as two, so 33.5 T separately rounded operations a
second.

K2 (``csrc/granule.cu``, float): the requantize's 2 products a sample (the
sign a select, the power of two built from exponent bits), 248 alias
butterflies of 6 a granule, and per long band 18 IMDCT sums of 18
products and sums (the float32 cosines' symmetry gives the other 18) and
36 window products; the samples as the card's Huffman scan hands them
(int32), 16 bytes of side information a (channel, granule), and the
float32 blocks written once. K1 (``csrc/synth.cu``, float): ``bounds.k1_s``'s
operations, its blocks and tables in 4 bytes.
"""

import bounds

F32_OPS_S = 67e12 / 2
K2_OPS_GRANULE = 576 * 2 + 248 * bounds.K2_OPS_BUTTERFLY \
    + 32 * (18 * 18 * 2 + 36)


def k2_s(granules: int, channels: int = 2) -> float:
    lanes = channels * granules
    nbytes = lanes * (576 * 4 + bounds.K2_SIDE_BYTES + 4 * 32 * 36)
    return bounds._bound(nbytes, lanes * K2_OPS_GRANULE, F32_OPS_S)


def k1_s(granules: int, channels: int = 2, launches: int = 1) -> float:
    steps = channels * granules * 18
    nbytes = 4 * (channels * granules * 32 * 36
                  + launches * (64 * 32 + 16 * 32)) + steps * 32 * 2
    ops = steps * (2 * 32 + 2 * 64 * 32 + 2 * 32 * 16 + 32)
    return bounds._bound(nbytes, ops, F32_OPS_S)
