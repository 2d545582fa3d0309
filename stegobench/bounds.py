"""The least time the card could take for a kernel's work, from the work's
shapes alone (never from a count the program writes), against the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
limit): 3.35 TB/s of HBM, and 34 TFLOP/s float64 outside the tensor cores,
which counts a fused multiply-add as two operations. K1 and K2 round every
product and sum on their own (the upstream decoder's arithmetic), so each
of those is one instruction at the fused rate: 17 T operations/s.

Frozen copies of ``chip_smoke.py``'s ``granule_bound`` (K2) and
``fused_bound`` (K1) at commit e1ac834, restated from the input's granules,
channels and escapes instead of the program's prepared inputs.
"""

HBM_BYTES_S = 3.35e12
F64_OPS_S = 34e12 / 2

# K2's separately rounded operations (the note in csrc/granule.cu): per
# sample the requantize (the sign, two products); per alias butterfly 4
# products and 2 sums (31 x 8 a long granule); per long band 36 x 18
# products and sums and 36 window products
K2_OPS_SAMPLE = 3
K2_OPS_BUTTERFLY = 6
K2_OPS_LONG_BAND = 36 * 18 * 2 + 36
# bytes K2 must move besides its samples (one byte each) and its blocks: an
# escape (a value above 127) as a 2-byte value and a 2-byte position, and a
# (channel, granule)'s side information (gain, block type, scalefactor
# fields) at 16 bytes
K2_ESCAPE_BYTES = 4
K2_SIDE_BYTES = 16


def _bound(nbytes: float, ops: float, ops_s: float) -> float:
    return max(nbytes / HBM_BYTES_S, ops / ops_s)


def k2_s(granules: int, escapes: int, channels: int = 2) -> float:
    """K2 on ``granules`` granules a channel, all long blocks, in float64:
    the samples and side information read once, the (channels, granules,
    32, 36) float64 blocks written once, against its operations."""
    lanes = channels * granules
    nbytes = lanes * 576 + escapes * K2_ESCAPE_BYTES \
        + lanes * K2_SIDE_BYTES + 8 * lanes * 32 * 36
    ops = lanes * 576 * K2_OPS_SAMPLE \
        + lanes * 248 * K2_OPS_BUTTERFLY + lanes * 32 * K2_OPS_LONG_BAND
    return _bound(nbytes, ops, F64_OPS_S)


def k1_s(granules: int, channels: int = 2, launches: int = 1) -> float:
    """K1 on ``granules`` granules a channel in float64 with int16 output:
    the blocks read once, its cosine and window tables once a launch, the
    int16 PCM written once, against its operations: per sub-step the
    overlap-add and inversion 2 x 32, V 2 x 64 x 32, the window 2 x 32 x 16
    and the int16 scale 32."""
    steps = channels * granules * 18
    nbytes = 8 * (channels * granules * 32 * 36
                  + launches * (64 * 32 + 16 * 32)) + steps * 32 * 2
    ops = steps * (2 * 32 + 2 * 64 * 32 + 2 * 32 * 16 + 32)
    return _bound(nbytes, ops, F64_OPS_S)


# K3's instructions per (channel, granule) (the note in csrc/analysis.cu):
# 66,816 Q31 products (window 18 x 512, filter 18 x 32 x 64, MDCT
# 32 x 18 x 36), each a multiply-high with its add, which is one IMAD.HI,
# and 31 x 8 alias butterflies of 8 (4 products, 2 sums, 2 shifts); against
# the published INT32 rate, 64 lanes an SM a clock (NVIDIA's Hopper
# architecture paper), on 132 SMs at the H100 SXM's 1,980 MHz boost clock.
# (chip_smoke.py's K3 bound counts a product at two pipe cycles, the rate of
# IMAD.HI that tools/imad_probe.py measured, not a published one; this
# bound is about half of that one.)
K3_PRODUCTS = 18 * 512 + 18 * 32 * 64 + 32 * 18 * 36
K3_OPS_GRANULE = K3_PRODUCTS + 8 * 31 * 8
INT32_OPS_S = 132 * 64 * 1.98e9


def k3_s(granules: int, channels: int = 2) -> float:
    """K3 on ``granules`` granules a channel: the int16 PCM (with its 480
    samples of history) and the tables read once, the int32 spectra written
    once, against its instructions."""
    lanes = channels * granules
    nbytes = 2 * channels * (480 + granules * 576) + 4 * lanes * 576 \
        + 4 * (512 + 32 * 64 + 18 * 36 + 16)
    return _bound(nbytes, lanes * K3_OPS_GRANULE, INT32_OPS_S)
