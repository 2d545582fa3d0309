"""Rate-control search on the device (kernel K4): the encoder's bisection and
inner loop for every granule at once, exact. Its CUDA wrapper and its plain
version.

The reference searches each granule on its own (about 8 evaluations of
quantize -> run lengths -> table select -> bit count, MP3_Encoder.py:958-996,
1064-1095). Every granule ("lane") runs that trajectory: a bisection of up
to 8 rounds over the quantizer step, then the inner loop, which steps the
lane by one until it fits (at most ``ITER_CAP`` rounds).

Exactness. The quantizer is the reference's exactly (``ops/quant.py``
quantize, MP3_Encoder.py:403-409): an ``int2idx`` gather where
``ln < 10000``, and the float64 fallback elsewhere, as
``trunc(sqrt(sqrt(d) * d))`` with ``d = xrabs * steptab * 4.656612875e-10``
multiplied in that order. Each product and root rounds once (nothing is
fused into an FMA) and float64 ``sqrt`` is correctly rounded, so every
evaluation equals the host oracle's. ``xrabs`` is the int32-wrapped ``|xr|``
(INT32_MIN stays negative; its NaN converts to INT32_MIN as on x86).

Three cases still go to the host oracle (``ops/quant_np.oracle_search``,
run by ``models/encoder``), flagged per lane:

* ``FLAG_ADDR``: subdivide leaves address1..3 stale when big_values == 0
  (MP3_Encoder.py:1010-1012). Each lane starts from zero addresses; a lane
  that consumes them while still "virgin" (big_values == 0 and count1 > 0
  before any evaluation set them) needs the previous granule of its
  (gr, ch) slot, so the host redoes it with the address chain carried.
* ``FLAG_OOB``: a step outside the 128-entry steptab (the reference's
  IndexError).
* ``FLAG_ITER``: the inner loop hit ``ITER_CAP``.

Hide mode (``hide=``) runs the stego pair transform inside the search at a
given per-lane cursor (``_cost``); ``search_windows`` searches each lane
under all eight 3-bit message windows, which the encoder's hide resolves
against the true cursors (``models/encoder.MP3Encoder._encode_hide``).

* ``search``, ``search_windows``, ``cost_step`` — the wrappers. A CPU tensor
  takes the plain version; a CUDA tensor launches ``csrc/search.cu`` (one
  warp runs one lane's whole trajectory; it replaces the JAX package's XLA
  search program, ``mp3stego_tpu/ops/search_plane.py::_search_body``) or
  raises. There is no fallback from the card to the plain version.
* ``search_torch``, ``search_windows_torch``, ``cost_step_torch`` — the
  plain PyTorch versions: every lane in lockstep, each round evaluating
  the lanes still searching, one host sync a round. The kernel equals them
  bit for bit on every row, ``ix`` and count.
* ``launches`` — how many times the kernel was launched in this process.
* ``occupancy`` — the kernel's CTAs an SM (the runtime's occupancy query),
  warps a CTA and shared memory a CTA; the launch grid is the SMs times
  its CTAs, and the warps take lanes from a queue.

Results are resident: the ``ROWS`` (N,) int32, ``COUNTS`` (N,) int32 and
``ix`` (N, 576) int32. The counts are the evaluations each lane ran and, of
them, its inner-loop rounds, then the function's work over them (the
kernel's bound): the evaluations past quantize's quick reject, those past
the ixmax gate, and over these the count1 quads and big-values pairs
costed. ``rows_to_host`` and ``to_host`` fetch them and add
``rounds``, the most inner-loop rounds any lane ran.
"""

import ctypes
import functools

import numpy as np
import torch

from mp3stego_tpu_torch import tables as T
from mp3stego_tpu_torch.ops import fixedpoint as fx
from mp3stego_tpu_torch.utils.transfer import fetch_pieces

_BAIL = 165140         # 8192**(4/3): quantize's quick-reject threshold
MAX_STEP = 8192        # MAX_QUANTIZE_STEP
ITER_CAP = 160         # inner-loop rounds before a lane is flagged
NO_CURSOR = 1 << 30    # a cursor past any message: transform off

FLAG_ADDR = 1          # consumed virgin (cross-granule) stale addresses
FLAG_OOB = 4           # step outside the 128-entry steptab
FLAG_ITER = 8          # inner-loop iteration cap hit

ROWS = ("step", "bits", "bv", "c1", "a1", "a2", "a3", "r0c", "r1c",
        "ch0", "ch1", "ch2", "cts", "flags", "xrmax0")
COUNTS = ("evals", "inner", "quantized", "costed", "quads", "pairs")
_KEYS = ROWS + COUNTS             # the kernel's output rows, in this order

launches = 0

_P = ctypes.c_void_p
_SIGNATURES = {
    "rate_search": (ctypes.c_int, (
        _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,       # xr .. windows
        _P, ctypes.c_longlong, ctypes.c_longlong, _P,          # hide
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong,         # mode, step, big
        _P, _P, _P, _P, _P,                                    # tables
        _P, _P, _P, _P, ctypes.c_int, _P)),                    # outputs,
                                                               # queue, grid
    "rate_search_occupancy": (ctypes.c_int, (_P, _P, _P)),
}


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The search's tables as tensors on ``device``."""
    steptab, steptabi, int2idx = T.loop_tables()
    hlen = T.HUFF_LEN.astype(np.int32)
    t = lambda a, d=torch.int32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), device=device).to(d)
    return dict(
        steptab=t(steptab, torch.float64),
        steptabi=t(steptabi, torch.int64),
        int2idx=t(int2idx),
        hlen=t(hlen.reshape(-1)),                     # (34*256,) [t, x, y]
        qlen0=t(hlen[32, 0, :16]), qlen1=t(hlen[33, 0, :16]),
        linmax=t(T.HUFF_LINMAX), linbits=t(T.HUFF_LINBITS),
        subdv=t(T.SUBDV_TABLE), transform=t(T.TRANSFORM_HUF.reshape(-1)),
        band=t(T.BAND_ALL),
        pos=torch.arange(576, dtype=torch.int32, device=device),
    )


def quantize(labs64, xrabs_f64, xrmax64, s, c):
    """Quantize lanes (M, 576) at per-lane steps ``s`` (M,), exactly.

    Returns (ix (M, 576) int32, ixmax (M,) with 16384 where quantize bails,
    oob (M,) bool: the step lies outside steptab and was clamped, bail (M,)
    bool: the quick reject)."""
    sidx = (s + 127).clamp(0, 127)
    oob = (s + 127) != sidx
    scalei = c["steptabi"][sidx]                                   # (M,) i64
    bail = ((xrmax64 * scalei + 2147483648) >> 32) > _BAIL
    ln = ((labs64 * scalei[:, None] + 2147483648) >> 32).to(torch.int32)
    ix = c["int2idx"][ln.clamp(0, 9999)]
    # float64 fallback, in the reference's operation order
    d = xrabs_f64 * c["steptab"][sidx][:, None]
    d = d * 4.656612875e-10
    ixf = torch.sqrt(torch.sqrt(d) * d)
    ixf = torch.where(d < 0, -2147483648.0, ixf).to(torch.int32)
    ix = torch.where(ln < 10000, ix, ixf)
    ixmax = torch.where(bail, 16384, ix.max(dim=1).values)
    return ix, ixmax, oob, bail


def _floordiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _cost(ix, addr_in, band, c, hide=None):
    """One search evaluation's body: run lengths -> count1 -> subdivide
    (addresses stay stale when big_values == 0) -> table select -> bits.
    Mirrors ops/quant.py (MP3_Encoder.py:266-291, 171-211, 998-1036,
    1147-1264) over M lanes; the Huffman lengths are read by gather.

    ``hide`` = (bits (L,) int64, cursor (M,), L) applies the stego pair
    transform (MP3_Encoder.py:1257-1263): each nonzero region's table maps
    through IDX_TO_TRANSFORM_HUF by the message bit at its cursor position,
    and the region is costed under the EMITTED table, which is what the
    reference's part2_3_length counts."""
    m = ix.shape[0]
    pos = c["pos"]
    nz = ix != 0
    last = torch.where(nz, pos, -1).max(dim=1).values
    i0 = torch.where(nz.any(dim=1), ((last + 2) >> 1) << 1, 0)
    lim = torch.where(ix > 1, pos + 1, 0).max(dim=1).values
    c1 = torch.minimum(_floordiv(i0 - lim, 4), _floordiv(i0, 4)).clamp(min=0)
    bvr = i0 - 4 * c1
    bv = bvr >> 1
    has_bv = bv > 0

    # count1 quads in both alignments (the region starts at bvr mod 4)
    def quad_costs(vals):
        sb = (vals != 0).sum(dim=-1, dtype=torch.int32)
        p = (vals[..., 0] + (vals[..., 1] << 1) + (vals[..., 2] << 2)
             + (vals[..., 3] << 3)).clamp(0, 15)
        return c["qlen0"][p] + sb, c["qlen1"][p] + sb

    qe0, qe1 = quad_costs(ix.reshape(m, 144, 4))
    qo0, qo1 = quad_costs(ix[:, 2:574].reshape(m, 143, 4))
    first_e = (bvr >> 2)[:, None]
    first_o = ((bvr - 2) >> 2)[:, None]
    qi = pos[:144][None, :]
    me = (qi >= first_e) & (qi < first_e + c1[:, None])
    mo = (qi[:, :143] >= first_o) & (qi[:, :143] < first_o + c1[:, None])
    even = (bvr & 3) == 0
    sum0 = torch.where(even, torch.where(me, qe0, 0).sum(dim=1),
                       torch.where(mo, qo0, 0).sum(dim=1))
    sum1 = torch.where(even, torch.where(me, qe1, 0).sum(dim=1),
                       torch.where(mo, qo1, 0).sum(dim=1))
    cts = (sum0 >= sum1).to(torch.int32)

    # subdivide
    scfb_anz = (band[None, :] < bvr[:, None]).sum(dim=1)
    kmax = (band[None, :] <= bvr[:, None]).sum(dim=1) - 1
    sd = c["subdv"][scfb_anz.clamp(0, 22)]
    tc0 = torch.minimum(sd[:, 0], kmax - 1).clamp(min=0)
    tc1 = torch.minimum(sd[:, 1], kmax - (tc0 + 1) - 1).clamp(min=0)
    a1 = torch.where(has_bv, band[tc0 + 1], addr_in[:, 0])
    a2 = torch.where(has_bv, band[(tc0 + tc1 + 2).clamp(0, 22)],
                     addr_in[:, 1])
    a3 = torch.where(has_bv, bvr, addr_in[:, 2])
    r0c = torch.where(has_bv, tc0, 0)
    r1c = torch.where(has_bv, tc1, 0)

    # per-pair Huffman lengths under the four representative tables
    x, y = ix[:, 0::2], ix[:, 1::2]
    pidx = x.clamp(0, 15) * 16 + y.clamp(0, 15)
    signs = (x != 0).to(torch.int32) + (y != 0).to(torch.int32)
    nesc = (x > 14).to(torch.int32) + (y > 14).to(torch.int32)
    hlen = c["hlen"]
    starts = torch.stack([torch.zeros_like(a1), a1, a2], dim=-1)   # (M,3)
    ends = torch.stack([a1, a2, bvr], dim=-1)
    pm = ((pos[0::2] >= starts[..., None])
          & (pos[0::2] < ends[..., None]))                         # (M,3,288)

    def rsum(chan):
        return torch.where(pm, chan[:, None, :], 0).sum(dim=-1)

    rc13, rc15, rc16, rc24 = (rsum(hlen[t * 256 + pidx] + signs)
                              for t in (13, 15, 16, 24))
    rnesc = rsum(nesc)
    sm = (pos >= starts[..., None]) & (pos < ends[..., None])      # (M,3,576)
    mreg = torch.where(sm, ix[:, None, :], 0).max(dim=-1).values   # (M,3)

    linmax, linbits = c["linmax"], c["linbits"]
    ixm = (mreg - 15)[..., None]
    t16 = 15 + (linmax[15:24] < ixm).sum(dim=-1)
    t24 = 24 + (linmax[24:32] < ixm).sum(dim=-1)
    cost16 = torch.where(t16 == 15, rc15, rc16 + linbits[t16] * rnesc)
    cost24 = rc24 + linbits[t24.clamp(24, 31)] * rnesc
    esc24 = cost24 < cost16
    nl15 = rc15 <= rc13
    choice = torch.where(mreg < 15, torch.where(nl15, 15, 13),
                         torch.where(esc24, t24, t16))
    rcost = torch.where(mreg < 15, torch.where(nl15, rc15, rc13),
                        torch.where(esc24, cost24, cost16))
    active = torch.stack([a1 > 0, a2 > a1, bvr > a2], dim=-1)
    choice = torch.where(active & (mreg != 0), choice, 0)

    if hide is not None:
        bits, cur, n_bits = hide
        nzc = choice > 0
        inc0 = nzc[:, 0].to(torch.int64)
        idx = torch.stack([cur, cur + inc0, cur + inc0 + nzc[:, 1]], dim=-1)
        bit = bits[idx.clamp(0, bits.shape[0] - 1)]
        t_new = c["transform"][choice.clamp(0, 31) * 2 + bit]
        choice = torch.where(nzc & (idx < n_bits), t_new, choice)
        # re-cost each region under its emitted table
        t_pp = torch.where(pm, choice[..., None], 0).sum(dim=1)   # (M,288)
        rcost = (rsum(hlen[t_pp * 256 + pidx] + signs)
                 + linbits[choice] * rnesc)

    rcost = torch.where(choice != 0, rcost, 0)
    return dict(bits=rcost.sum(dim=-1) + torch.minimum(sum0, sum1),
                bv=bv, c1=c1, a1=a1, a2=a2, a3=a3, r0c=r0c, r1c=r1c,
                choice=choice, cts=cts, has_bv=has_bv)


def _hide_tensors(hide, n: int, dev):
    """(bits, cursors) -> (bits (max(L, 1),) uint8, cursors (N,) int64, L)
    on ``dev``; an empty message keeps one zero bit so that the bit read
    stays in range."""
    hbits = torch.as_tensor(np.asarray(hide[0], np.uint8), device=dev)
    n_bits = hbits.shape[0]
    if n_bits == 0:
        hbits = torch.zeros(1, dtype=torch.uint8, device=dev)
    hcur = torch.as_tensor(hide[1], device=dev).to(torch.int64)
    if hcur.shape != (n,):
        raise ValueError(f"hide cursors must be ({n},), got "
                         f"{tuple(hcur.shape)}")
    return hbits, hcur.contiguous(), n_bits


def search_torch(xr: torch.Tensor, max_bits: torch.Tensor, sr_idx: int,
                 hide=None) -> dict:
    """Plain PyTorch version of :func:`search` on ``xr``'s device: every
    lane in lockstep, 8 bisection rounds then the inner loop, each round
    evaluating the lanes still searching."""
    _check(xr, max_bits)
    dev = xr.device
    c = _consts(dev)
    band = c["band"][sr_idx]
    n = xr.shape[0]
    labs64 = xr.to(torch.int64).abs()
    xrabs32 = xr.abs()                               # int32: wraps INT32_MIN
    xrabs_f64 = xrabs32.to(torch.float64)
    xrmax64 = xrabs32.clamp(min=0).max(dim=1).values.to(torch.int64)
    need = xrmax64 > 0
    if hide is not None:
        hbits, hcur, n_bits = _hide_tensors(hide, n, dev)
        hbits = hbits.to(torch.int64)

    flags = torch.zeros(n, dtype=torch.int32, device=dev)
    addr = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    virgin = torch.ones(n, dtype=torch.bool, device=dev)
    counts = {k: torch.zeros(n, dtype=torch.int32, device=dev)
              for k in COUNTS}

    def evaluate(lanes, s):
        """Evaluate ``lanes`` at steps ``s``; update their address, virgin
        and flag state like the reference's _eval. Returns (bits with
        100000 where ixmax > 8192, the gate ixmax <= 8192, cost dict, ix)."""
        ix, ixmax, oob, bail = quantize(labs64[lanes], xrabs_f64[lanes],
                                        xrmax64[lanes], s, c)
        sub = None if hide is None else (hbits, hcur[lanes], n_bits)
        co = _cost(ix, addr[lanes], band, c, sub)
        gate = ixmax <= MAX_STEP
        for k, v in (("evals", 1), ("quantized", ~bail), ("costed", gate),
                     ("quads", torch.where(gate, co["c1"], 0)),
                     ("pairs", torch.where(gate, co["bv"], 0))):
            counts[k][lanes] += v
        consumed = gate & ~co["has_bv"] & (co["c1"] > 0) & virgin[lanes]
        flags[lanes] |= (torch.where(oob, FLAG_OOB, 0)
                         | torch.where(consumed, FLAG_ADDR, 0))
        new_addr = torch.stack([co["a1"], co["a2"], co["a3"]], dim=-1)
        addr[lanes] = torch.where(gate[:, None], new_addr, addr[lanes])
        virgin[lanes] &= ~(gate & co["has_bv"])
        bits = torch.where(gate, co["bits"].to(torch.int32), 100000)
        return bits, gate, co, ix

    # bisection: count 120 -> 60 -> 30 -> 15 -> 8|7 -> ... -> 1 (8 rounds)
    nxt = torch.full((n,), -120, dtype=torch.int32, device=dev)
    count = torch.full((n,), 120, dtype=torch.int32, device=dev)
    running = need.clone()
    for _ in range(8):
        lanes = torch.nonzero(running).squeeze(1)
        if lanes.numel() == 0:
            break
        half = count[lanes] // 2
        bits, _, _, _ = evaluate(lanes, nxt[lanes] + half)
        fits = bits < max_bits[lanes]
        count[lanes] = torch.where(fits, half, count[lanes] - half)
        nxt[lanes] = torch.where(fits, nxt[lanes], nxt[lanes] + half)
        running[lanes] = count[lanes] > 1

    # inner loop (part2_length is 0: the slen tables start at 0)
    step = nxt
    done = ~need
    out = {k: torch.zeros(n, dtype=torch.int32, device=dev) for k in ROWS}
    ix_out = torch.zeros((n, 576), dtype=torch.int32, device=dev)
    for _ in range(ITER_CAP):
        lanes = torch.nonzero(~done).squeeze(1)
        if lanes.numel() == 0:
            break
        counts["inner"][lanes] += 1
        s1 = step[lanes] + 1
        step[lanes] = s1
        bits, gate, co, ix = evaluate(lanes, s1)
        fin = gate & (bits <= max_bits[lanes])
        done[lanes] = fin
        f = lanes[fin]
        for k, v in (("step", s1), ("bits", bits), ("bv", co["bv"]),
                     ("c1", co["c1"]), ("a1", co["a1"]), ("a2", co["a2"]),
                     ("a3", co["a3"]), ("r0c", co["r0c"]),
                     ("r1c", co["r1c"]), ("cts", co["cts"])):
            out[k][f] = v[fin].to(torch.int32)
        for r in range(3):
            out[f"ch{r}"][f] = co["choice"][fin, r].to(torch.int32)
        ixf = ix[fin]
        ix_out[f] = torch.where(xr[f] < 0, -ixf, ixf)
    out["flags"] = flags | torch.where(done, 0, FLAG_ITER)
    out["xrmax0"] = (~need).to(torch.int32)
    out.update(counts)
    out["ix"] = ix_out
    return out


def _check(xr: torch.Tensor, max_bits: torch.Tensor = None):
    """What the wrappers take: spectra (N, 576) int32 and budgets (N,)
    int32 on one device; on the card, both C-contiguous."""
    if xr.dim() != 2 or xr.shape[1] != 576 or xr.dtype != torch.int32:
        raise ValueError(f"the search wants spectra (N, 576) int32, got "
                         f"{tuple(xr.shape)} {xr.dtype}")
    if max_bits is not None:
        if max_bits.shape != (xr.shape[0],) or max_bits.dtype != torch.int32:
            raise ValueError(f"the search wants budgets ({xr.shape[0]},) "
                             f"int32, got {tuple(max_bits.shape)} "
                             f"{max_bits.dtype}")
        if max_bits.device != xr.device:
            raise ValueError(f"spectra on {xr.device}, budgets on "
                             f"{max_bits.device}")
    if xr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the search runs on CPU or CUDA tensors, got "
                         f"{xr.device}")
    if xr.device.type == "cuda" and not (
            xr.is_contiguous()
            and (max_bits is None or max_bits.is_contiguous())):
        raise ValueError("the CUDA search takes C-contiguous spectra and "
                         "budgets")


@functools.lru_cache(maxsize=None)
def _kernel_tables(device: torch.device, sr_idx: int) -> tuple:
    """:func:`_consts` packed for the kernel: steptab (128,) float64,
    steptabi (128,) int32, the small tables (201,) int32 (linmax 34, linbits
    34, SUBDV_TABLE 46, TRANSFORM_HUF 64, the band row 23), int2idx (10000,)
    int16 and the Huffman lengths (34 * 256,) uint8 [t, x, y]."""
    c = _consts(device)
    small = torch.cat([c["linmax"], c["linbits"], c["subdv"].reshape(-1),
                       c["transform"], c["band"][sr_idx]])
    return (c["steptab"], c["steptabi"].to(torch.int32), small,
            c["int2idx"].to(torch.int16), c["hlen"].to(torch.uint8))


@functools.lru_cache(maxsize=None)
def _window_bits(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(WINDOW_BITS).to(device)


@functools.lru_cache(maxsize=None)
def occupancy(device: torch.device) -> dict:
    """What the runtime gives the kernel on ``device``: the CTAs an SM
    holds (``ctas``, at the kernel's registers and dynamic shared memory),
    its warps a CTA (``warps``, one lane each) and its bytes of shared
    memory a CTA (``smem``). Builds the kernel; raises on a CUDA error."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("search", _SIGNATURES)
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        rc = lib.rate_search_occupancy(*(ctypes.addressof(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"rate_search occupancy query failed: CUDA error "
                           f"{rc}")
    ctas, warps, smem = (v.value for v in out)
    if ctas < 1:
        raise RuntimeError("rate_search_kernel fits no CTA on an SM")
    return dict(ctas=ctas, warps=warps, smem=smem)


@functools.lru_cache(maxsize=None)
def _grid_cap(device: torch.device) -> int:
    """The persistent grid: every SM full of CTAs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * occupancy(device)["ctas"]


def _launch(xr, max_bits, sr_idx: int, m: int, windows: bool = False,
            hide=None, mode: int = 0, step: int = 0, big: int = 0):
    """One launch of ``csrc/search.cu`` over ``m`` lane searches of the
    spectra ``xr`` (N, 576) on the card: mode 0 searches (rows (21, m),
    ix (m, 576)), mode 1 costs one step (bits (N,) int64). ``hide`` =
    (bits (L,) uint8, L, cursors (N,) int64 or None in window mode)."""
    global launches
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("search", _SIGNATURES)
    dev = xr.device
    tabs = _kernel_tables(dev, sr_idx)
    if mode == 0:
        rows = torch.empty((len(_KEYS), m), dtype=torch.int32, device=dev)
        ix = torch.empty((m, 576), dtype=torch.int32, device=dev)
        res = dict(zip(_KEYS, rows.unbind(0)), ix=ix)
        outs = (rows.data_ptr(), ix.data_ptr(), None)
    else:
        cost = torch.empty(m, dtype=torch.int64, device=dev)
        outs = (None, None, cost.data_ptr())
    if m == 0:
        return res if mode == 0 else cost
    hb, n_bits, hcur = hide if hide is not None else (None, 0, None)
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    blocks = min(-(-m // occupancy(dev)["warps"]), _grid_cap(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.rate_search(
            xr.data_ptr(), None if max_bits is None else max_bits.data_ptr(),
            xr.shape[0], m, int(windows),
            None if hb is None else hb.data_ptr(),
            0 if hb is None else hb.shape[0], n_bits,
            None if hcur is None else hcur.data_ptr(),
            mode, step, big, *(t.data_ptr() for t in tabs), *outs,
            queue.data_ptr(), blocks, stream)
    if rc != 0:
        raise RuntimeError(f"rate_search kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return res if mode == 0 else cost


def search(xr: torch.Tensor, max_bits: torch.Tensor, sr_idx: int,
           hide=None) -> dict:
    """Search every lane of resident spectra ``xr`` (N, 576) int32 under
    per-lane budgets ``max_bits`` (N,) int32, on their device.

    :param sr_idx: row of ``tables.BAND_ALL`` (the encoder's band row).
    :param hide: optional (bits (L,) uint8 0/1 message, cursors (N,) int
        pinned per lane): runs the stego pair transform in every evaluation.
    :return: dict of resident tensors: the ``ROWS`` and ``COUNTS`` (N,)
        int32 and ``ix`` (N, 576) int32, the signed quantized samples of
        each lane's final evaluation.

    On CUDA tensors this launches the hand-written kernel (one launch) on
    the current stream; a build or launch fault raises. CPU tensors take
    :func:`search_torch`."""
    _check(xr, max_bits)
    if xr.device.type == "cpu":
        return search_torch(xr, max_bits, sr_idx, hide)
    n = xr.shape[0]
    if hide is not None:
        hbits, hcur, n_bits = _hide_tensors(hide, n, xr.device)
        hide = (hbits, n_bits, hcur)
    return _launch(xr, max_bits, sr_idx, n, hide=hide)


def cost_step_torch(xr: torch.Tensor, step: int, sr_idx: int,
                    big: int = 1 << 20) -> torch.Tensor:
    """Plain PyTorch version of :func:`cost_step`."""
    _check(xr)
    dev = xr.device
    c = _consts(dev)
    n = xr.shape[0]
    xrabs32 = xr.abs()                               # int32: wraps INT32_MIN
    xrmax64 = xrabs32.clamp(min=0).max(dim=1).values.to(torch.int64)
    s = torch.full((n,), step, dtype=torch.int32, device=dev)
    ix, ixmax, _, _ = quantize(xr.to(torch.int64).abs(),
                               xrabs32.to(torch.float64), xrmax64, s, c)
    co = _cost(ix, torch.zeros((n, 3), dtype=torch.int32, device=dev),
               c["band"][sr_idx], c)
    return torch.where(ixmax > MAX_STEP, big, co["bits"].to(torch.int64))


def cost_step(xr: torch.Tensor, step: int, sr_idx: int,
              big: int = 1 << 20) -> torch.Tensor:
    """Every lane's bits at ONE quantizer step ``step`` (-127..0): the cost
    the VBR rate choice bisects over (``models/encoder._vbr_framing``).
    Hide-free, each lane from fresh zero addresses; a lane whose quantize
    bails or whose ixmax exceeds 8192 costs ``big``. The same evaluation as
    :func:`search`'s, so it equals the native ``rate_cost_step``
    (rate_search.cpp) on every lane. Returns (N,) int64 on ``xr``'s
    device: one kernel launch on CUDA tensors, :func:`cost_step_torch` on
    CPU tensors."""
    _check(xr)
    if xr.device.type == "cpu":
        return cost_step_torch(xr, step, sr_idx, big)
    return _launch(xr, None, sr_idx, xr.shape[0], mode=1, step=step, big=big)


def _host_rows(rows: np.ndarray) -> dict:
    out = {k: rows[r] for r, k in enumerate(_KEYS)}
    out["rounds"] = int(out["inner"].max(initial=0))
    return out


def rows_to_host(res: dict) -> dict:
    """The resident ``ROWS`` and ``COUNTS`` of search results -> NumPy, in
    one copy, plus ``rounds``: the most inner-loop rounds any lane ran."""
    return _host_rows(fetch_pieces([torch.stack([res[k] for k in _KEYS])])[0])


def to_host(res: dict) -> dict:
    """Resident search results -> NumPy: the rows and counts in one copy,
    ``ix`` in another, both in one fetch (``utils.transfer.fetch_pieces``:
    pinned buffers, one wait)."""
    rows, ix = fetch_pieces([torch.stack([res[k] for k in _KEYS]),
                             res["ix"]])
    out = _host_rows(rows)
    out["ix"] = ix
    return out


def search_all(xr: torch.Tensor, max_bits: np.ndarray, sr_idx: int,
               hide_bits: np.ndarray = None,
               hide_cur: np.ndarray = None) -> dict:
    """:func:`search` from host budgets (and, in hide mode, host message
    bits and pinned cursors) to host results."""
    mb = torch.as_tensor(np.asarray(max_bits, np.int32), device=xr.device)
    hide = None if hide_bits is None else (hide_bits, hide_cur)
    return to_host(search(xr, mb, sr_idx, hide))


def region_counts(rows: dict) -> np.ndarray:
    """Nonzero table selections per lane of host rows: the embedded bits
    each granule carries (the pair transform never zeroes or un-zeroes a
    table)."""
    return ((rows["ch0"] > 0).astype(np.int64) + (rows["ch1"] > 0)
            + (rows["ch2"] > 0))


# the eight 3-bit message windows back to back: window w is bits
# (w >> 2 & 1, w >> 1 & 1, w & 1) at cursor 3 * w
WINDOW_BITS = np.array([(w >> b) & 1 for w in range(8) for b in (2, 1, 0)],
                       np.uint8)


def window_of(bits: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """The window index of message ``bits`` at cursors ``cur`` (each at
    least 3 bits before the message's end)."""
    b = bits.astype(np.int64)
    return 4 * b[cur] + 2 * b[cur + 1] + b[cur + 2]


def search_windows_torch(xr: torch.Tensor, max_bits: torch.Tensor,
                         sr_idx: int) -> dict:
    """Plain PyTorch version of :func:`search_windows`: the 8 windows'
    lanes as one search of 8 copies of the spectra."""
    n = xr.shape[0]
    cur = torch.arange(8, device=xr.device).repeat_interleave(n) * 3
    return search_torch(xr.repeat(8, 1), max_bits.repeat(8), sr_idx,
                        hide=(WINDOW_BITS, cur))


def search_windows(xr: torch.Tensor, max_bits: torch.Tensor,
                   sr_idx: int) -> dict:
    """:func:`search` of every lane under each of the eight 3-bit message
    windows.

    A lane's search reads at most three message bits: at its cursor, and
    one more after each nonzero region before the last (``_cost``). So
    under any cursor ``c`` with ``c + 3 <= len(bits)`` its result is its
    result under the window ``window_of(bits, c)``. Returns the resident
    results of 8 * N lanes, window-major: row ``w * N + i`` is lane ``i``
    under window ``w``. On CUDA tensors, one kernel launch that reads each
    lane's spectrum in place for all 8 windows; CPU tensors take
    :func:`search_windows_torch`."""
    _check(xr, max_bits)
    if xr.device.type == "cpu":
        return search_windows_torch(xr, max_bits, sr_idx)
    wb = _window_bits(xr.device)
    return _launch(xr, max_bits, sr_idx, 8 * xr.shape[0], windows=True,
                   hide=(wb, wb.shape[0], None))


def scfsi_sums(xr: torch.Tensor, sr_idx: int):
    """Per-granule scfsi energy sums (MP3_Encoder.py:817-850): int32-wrapping
    sums of mulsr(xr, xr) >> 10 over each long scalefactor band, and the
    total. Summed exactly in int64 and narrowed: a wrapped in-order sum is
    the exact sum mod 2^32. Returns resident ((N,) total, (N, 21) bands)."""
    band = _consts(xr.device)["band"][sr_idx].to(torch.int64)
    terms = (fx.mulsr(xr, xr) >> 10).to(torch.int64)
    csz = torch.nn.functional.pad(torch.cumsum(terms, dim=1), (1, 0))
    total = csz[:, -1].to(torch.int32)
    en = (csz[:, band[1:22]] - csz[:, band[:21]]).to(torch.int32)
    return total, en
