"""Exact host twin of the search plane: the full-granule oracle search, in
NumPy with the reference's float64 fallback.

``models/encoder.py`` redoes the lanes the torch search flags (``FLAG_ADDR``,
``FLAG_OOB``, ``FLAG_ITER``, see ops/search_plane.py) with
:func:`oracle_search`, carrying the true cross-granule address state. Both
reuse the ops/quant.py primitives (MP3_Encoder.py:373-415, 958-996,
1064-1095).
"""

import numpy as np

from mp3stego_tpu_torch import tables as T
from mp3stego_tpu_torch.ops import quant as Q


def _cost_exact(ix: np.ndarray, addr_in, sr_idx: int, hide=None):
    """calc_run_len -> count1 -> subdivide -> table select -> big-values bits,
    carrying ``addr_in`` as the stale-address state. Returns (bits, GrInfo).
    ``hide`` = (bits_u8, cursor) applies the stego pair transform at the
    granule's pinned embedded-bit cursor (MP3_Encoder.py:1147-1263)."""
    gi = Q.GrInfo()
    gi.address1, gi.address2, gi.address3 = (int(a) for a in addr_in)
    Q.calc_run_len(ix, gi)
    bits = Q.count1_bit_count(ix, gi)
    Q.subdivide(gi, sr_idx)
    _tab_select(ix, gi, hide)
    bits += Q.big_v_bit_count(ix, gi)
    return bits, gi


def _tab_select(ix, gi, hide=None):
    """_big_v_tab_select (MP3_Encoder.py:1147-68); with ``hide`` the chosen
    tables are mapped through IDX_TO_TRANSFORM_HUF by the message bits at the
    pinned cursor (the cursor index advances over nonzero choices within the
    granule, exactly like the reference's idx)."""

    def pick(begin, end, idx):
        c = Q.choose_table(ix, begin, end)
        if hide is not None and c > 0:
            bits_u8, cur = hide
            j = cur + idx
            if j < len(bits_u8):
                c = int(T.TRANSFORM_HUF[c, int(bits_u8[j])])
        return c

    idx = 0
    gi.table_select[0] = 0 if gi.address1 <= 0 else \
        pick(0, gi.address1, idx)
    idx += int(gi.table_select[0] > 0)
    gi.table_select[1] = 0 if gi.address2 <= gi.address1 else \
        pick(gi.address1, gi.address2, idx)
    idx += int(gi.table_select[1] > 0)
    gi.table_select[2] = 0 if (gi.big_values << 1) <= gi.address2 else \
        pick(gi.address2, gi.big_values << 1, idx)


def oracle_search(xr_row: np.ndarray, max_bits: int, addr_in, sr_idx: int,
                  hide=None):
    """The reference's full outer loop for one granule, exact on host
    (_bin_search_step_size + _inner_loop, MP3_Encoder.py:933-996,1064-1095).

    :param addr_in: (address1, address2, address3) carried in from the
        previous granule of the same (gr, ch) slot.
    :param hide: optional (bits_u8, cursor) stego transform state with the
        granule's pinned embedded-bit cursor.
    :return: dict with step, bits, big_values, count1, addresses, region
        counts, table_select, count1table_select and the signed ix row.
    """
    xrabs = np.abs(xr_row)
    xrmax = int(max(0, xrabs.max()))
    state = dict(addr=tuple(int(a) for a in addr_in), gi=None, ix=None)

    def evaluate(step):
        ix, ix_max = Q.quantize(xr_row, xrabs, xrmax, step)
        if ix_max > Q.MAX_QUANTIZE_STEP:
            return 100000
        bits, gi = _cost_exact(ix, state["addr"], sr_idx, hide)
        state["addr"] = (gi.address1, gi.address2, gi.address3)
        state["gi"] = gi
        state["ix"] = ix
        return bits

    # bisection (MP3_Encoder.py:958-996)
    nxt, count = -120, 120
    while True:
        half = count // 2
        bits = evaluate(nxt + half)
        if bits < max_bits:
            count = half
        else:
            nxt += half
            count -= half
        if count <= 1:
            break
    step = nxt

    huff_bits = max_bits  # part2_length == 0 (slen tables start at 0)
    if huff_bits < 0:
        step -= 1
    while True:
        while True:
            _, ix_max = Q.quantize(xr_row, xrabs, xrmax, step + 1)
            if ix_max <= Q.MAX_QUANTIZE_STEP:
                break
            step += 1
        step += 1
        bits = evaluate(step)
        if bits <= huff_bits:
            break

    gi = state["gi"]
    ix = state["ix"]
    ix_signed = np.where((xr_row < 0) & (ix > 0), -ix, ix)
    return dict(step=step, bits=bits, bv=gi.big_values, c1=gi.count1,
                a1=gi.address1, a2=gi.address2, a3=gi.address3,
                r0c=gi.region0_count, r1c=gi.region1_count,
                ch=tuple(int(t) for t in gi.table_select),
                cts=gi.count1table_select,
                ix=ix_signed.astype(np.int16))
