"""The least time the card could take for K2's work on a joint-stereo file
with short blocks and scalefactors (``lame128``), from the shapes of the
file (``mp3gen_lame.LameTruth``: its granules, its short granules and its
mid/side granules), never from a count the program writes. The peaks are
``bounds.py``'s: 3.35 TB/s of HBM and 17 T separately rounded float64
operations a second.

Operations, each product, sum and division rounded on its own: the
requantize's 3 a sample (the sign and two products; a scalefactor or a
subblock gain only picks the exponent); mid/side's 4 a sample pair (a sum,
a difference, two divisions, each division counted as one operation); a
long, start or stop granule's 248 alias butterflies of 6 and 32 long
IMDCTs of 36 x 18 products and sums and 36 window products; a short
granule's 32 x 3 short IMDCTs of 12 x 6 products and sums and 12 window
products, and the 2 x 6 sums that overlap its windows, with no
butterflies.

Bytes, each read or written once: the samples as the card's Huffman scan
hands them to K2 (int32, 4 bytes each), a (channel, granule)'s side
information (``bounds.K2_SIDE_BYTES``) and its 22 long and 39 short
scalefactors (a byte each), and the float64 blocks written once.
"""

import bounds

K2_OPS_SAMPLE = 3
K2_OPS_MS_PAIR = 4
K2_OPS_LONG = 248 * bounds.K2_OPS_BUTTERFLY + 32 * bounds.K2_OPS_LONG_BAND
K2_OPS_SHORT = 32 * (3 * (12 * 6 * 2 + 12) + 2 * 6)
SAMPLE_BYTES = 4
SIDE_BYTES = bounds.K2_SIDE_BYTES + 22 + 39


def k2_s(granules: int, short_granules: int, ms_granules: int,
         channels: int = 2) -> float:
    """K2 in float64 on ``granules`` granules a channel, of which
    ``short_granules`` (channel, granule)s are short and ``ms_granules``
    granules are mid/side."""
    lanes = channels * granules
    nbytes = lanes * (576 * SAMPLE_BYTES + SIDE_BYTES + 8 * 32 * 36)
    ops = lanes * 576 * K2_OPS_SAMPLE + ms_granules * 576 * K2_OPS_MS_PAIR \
        + (lanes - short_granules) * K2_OPS_LONG \
        + short_granules * K2_OPS_SHORT
    return bounds._bound(nbytes, ops, bounds.F64_OPS_S)
