"""The rate-control cost grid (kernel K5): every granule at all 128
quantizer steps in one launch, for the cost-grid encode engine. Its CUDA
wrapper and its plain version.

The reference's bisection and inner loop (MP3_Encoder.py:958-996,
1064-1095) evaluate quantize -> run lengths -> count1 -> subdivide -> table
select -> bit count one visited step at a time. Here every (granule, step)
cell is costed at once, integer-exact, and the host *replays* the
reference's search trajectory as lookups in the grid
(``models/encoder.MP3Encoder._outer_loop_cached``). Two cases go to an
exact host evaluation instead:

* ``approx``: a sample's ``ln`` reached the float64 fallback
  (ln >= 10000, MP3_Encoder.py:403-409); the grid quantizes it through
  ``int2idx[9999]`` and flags the cell;
* ``bv == 0``: the reference then reads stale region addresses from the
  previous evaluation (its subdivide leaves address1..3 untouched), which
  a stateless grid cannot know; the grid's ``a1``/``a2`` come from the
  cell's own subdivide.

Per cell the grid also holds the region cost channels that price a region
under any Huffman table (``table_cost``), so the hide's pair transform is
replayed on the host without re-scanning samples: c13/c15 for the tables
without linbits, c16/c24 plus linbits(t) * escapes for the ESC families
(16..23 share codebook 16; 24..31 share codebook 24).

* ``cost_all_steps`` -- the wrapper: a CUDA tensor launches
  ``csrc/cost_grid.cu`` (replaces the JAX package's XLA program
  ``mp3stego_tpu/ops/quant_batch.py::_cost_all_steps``) or raises; a CPU
  tensor takes the plain version; either way one fetch to NumPy.
* ``cost_all_steps_torch`` -- the plain PyTorch version, a transcription of
  the JAX program, chunked over lanes. The kernel equals it bit for bit.
* ``table_cost`` -- a region's bits under a table, from the grid.
* ``launches`` -- how many times the kernel was launched in this process.
* ``occupancy`` -- the kernel's CTAs an SM and shared memory a CTA.
"""

import ctypes
import functools

import numpy as np
import torch

from mp3stego_tpu_torch import tables as T
from mp3stego_tpu_torch.utils.transfer import fetch_pieces, resolve_device

S_STEPS = 128          # step_size + 127 in [0, 127]
_BAIL = 165140         # 8192**(4/3), quantize's quick-reject threshold
# lanes a chunk of the plain version: its (CHUNK, 128, 576) int64
# intermediates take ~150 MB each
CHUNK = 256

# packed row layout: scalar (N, S) keys are one row; (N, S, 3) keys are 3
_BASE_KEYS = ("bail", "approx", "ixmax", "bv", "a1", "a2", "bits_total")
_HIDE_SCALAR = ("sum0", "sum1")
_HIDE_R3 = ("choice", "rc13", "rc15", "rc16", "rc24", "rnesc")
ROWS_CLEAR = len(_BASE_KEYS)                                  # 7
ROWS_HIDE = ROWS_CLEAR + len(_HIDE_SCALAR) + 3 * len(_HIDE_R3)  # 27

launches = 0

_P = ctypes.c_void_p
_SIGNATURES = {
    "cost_grid": (ctypes.c_int, (
        _P, ctypes.c_int, ctypes.c_int,        # xr, n, rows
        _P, _P, _P,                            # small, int2idx, hlen
        _P, ctypes.c_int, _P)),                # out, blocks, stream
    "cost_grid_occupancy": (ctypes.c_int, (_P, _P, _P)),
}


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The grid's tables as tensors on ``device``."""
    steptab, steptabi, int2idx = T.loop_tables()
    hlen = T.HUFF_LEN.astype(np.int32)
    t = lambda a, d=torch.int32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), device=device).to(d)
    return dict(
        steptabi=t(steptabi, torch.int64),
        int2idx=t(int2idx),
        h13=t(hlen[13]), h15=t(hlen[15]), h16=t(hlen[16]), h24=t(hlen[24]),
        q0=t(hlen[32, 0, :16]), q1=t(hlen[33, 0, :16]),
        linmax=t(T.HUFF_LINMAX), linbits=t(T.HUFF_LINBITS),
        subdv=t(T.SUBDV_TABLE), band=t(T.BAND_ALL),
        pos=torch.arange(576, dtype=torch.int32, device=device),
    )


def _floordiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _cost_all_steps(xr, band, c):
    """xr (n, 576) int32 -> per-(n, S) costing tensors. Integer-exact.
    Returns (out, out_hide, c1): the base and hide channels, and the
    count1 quads (n, S) of each cell (the bound's work)."""
    n = xr.shape[0]
    steptabi = c["steptabi"]                       # (128,) int64
    int2idx = c["int2idx"]

    xrabs32 = xr.abs()                             # int32 wrap like reference
    labs64 = xr.to(torch.int64).abs()
    xrmax = xrabs32.clamp(min=0).amax(dim=1)       # (n,) int32

    # quick bail per (n, S): mulr(xrmax, scalei) > 165140
    mr = (xrmax.to(torch.int64)[:, None] * steptabi[None, :]
          + 2147483648) >> 32
    bail = mr > _BAIL                                       # (n, S)

    # quantize: ln = mulr(|xr|, scalei); ix = int2idx[ln] (flag ln >= 10000)
    ln = ((labs64[:, None, :] * steptabi[None, :, None] + 2147483648)
          >> 32).to(torch.int32)                            # (n, S, 576)
    approx = (ln >= 10000).any(dim=2) & ~bail               # (n, S)
    ix = int2idx[ln.clamp(0, 9999)]                         # (n, S, 576)
    del ln
    ixmax = ix.amax(dim=2)

    # ---- run lengths (calc_run_len, MP3_Encoder.py:266-291)
    pos = c["pos"]
    nz = ix != 0
    any_nz = nz.any(dim=2)
    last_nz = torch.where(nz, pos, -1).amax(dim=2)
    i0 = torch.where(any_nz, ((last_nz + 2) >> 1) << 1, 0)  # round up to even
    gt1 = ix > 1
    lim = torch.where(gt1, pos + 1, 0).amax(dim=2)          # 0 if none
    k = torch.minimum(_floordiv(i0 - lim, 4), _floordiv(i0, 4)).clamp(min=0)
    c1 = k
    i_final = i0 - 4 * k
    bv = i_final >> 1                                       # big_values

    # ---- subdivide (MP3_Encoder.py:998-1036), vectorized
    bvr = 2 * bv                                            # (n, S)
    # scfb_anz = first idx with band[idx] >= bvr
    scfb_anz = (band[None, None, :] < bvr[..., None]).sum(dim=-1)
    # largest j with band[j] <= bvr
    kmax = (band[None, None, :] <= bvr[..., None]).sum(dim=-1) - 1
    sd = c["subdv"][scfb_anz.clamp(0, 22)]                  # (n, S, 2)
    tc0 = torch.minimum(sd[..., 0], kmax - 1).clamp(min=0)
    a1 = band[tc0 + 1]
    # region 1 works on band[tc0+1:]: largest j2 with band[tc0+1+j2] <= bvr
    kmax2 = kmax - (tc0 + 1)
    tc1 = torch.minimum(sd[..., 1], kmax2 - 1).clamp(min=0)
    a2 = band[(tc0 + 1 + tc1 + 1).clamp(0, 22)]

    # ---- per-pair cost channels
    x = ix[..., 0::2]                                       # (n, S, 288)
    y = ix[..., 1::2]
    xc = x.clamp(max=15)
    yc = y.clamp(max=15)
    signs = (x != 0).to(torch.int32) + (y != 0).to(torch.int32)
    nesc = (x > 14).to(torch.int32) + (y > 14).to(torch.int32)
    ch13 = c["h13"][xc, yc] + signs
    ch15 = c["h15"][xc, yc] + signs
    ch16 = c["h16"][xc, yc] + signs
    ch24 = c["h24"][xc, yc] + signs
    del x, y, xc, yc, signs

    # region masks over pair start positions
    ppos = pos[0::2]                                        # (288,)
    starts = torch.stack([torch.zeros_like(a1), a1, a2], dim=-1)  # (n, S, 3)
    ends = torch.stack([a1, a2, bvr], dim=-1)
    pm = ((ppos >= starts[..., None])
          & (ppos < ends[..., None]))                       # (n, S, 3, 288)

    def rsum(chan):  # (n, S, 288) -> (n, S, 3)
        return torch.where(pm, chan[..., None, :], 0).sum(dim=-1)

    rc13 = rsum(ch13)
    rc15 = rsum(ch15)
    rc16 = rsum(ch16)
    rc24 = rsum(ch24)
    rnesc = rsum(nesc)
    del pm, ch13, ch15, ch16, ch24, nesc

    # region sample maxima (ix >= 0)
    sm = ((pos >= starts[..., None])
          & (pos < ends[..., None]))                        # (n, S, 3, 576)
    m = torch.where(sm, ix[..., None, :], 0).amax(dim=-1)   # (n, S, 3)
    del sm

    # ---- count1 quad costs, both alignments (region starts at 2bv mod 4)
    def quad_costs(vals):  # vals (n, S, Q, 4) -> (cost0, cost1)
        sb = (vals != 0).sum(dim=-1, dtype=torch.int32)
        p = (vals[..., 0] + (vals[..., 1] << 1) + (vals[..., 2] << 2)
             + (vals[..., 3] << 3)).clamp(0, 15)
        return c["q0"][p] + sb, c["q1"][p] + sb

    quads_e = ix.reshape(n, S_STEPS, 144, 4)
    qe0, qe1 = quad_costs(quads_e)
    quads_o = ix[..., 2:574].reshape(n, S_STEPS, 143, 4)
    qo0, qo1 = quad_costs(quads_o)

    qidx_e = pos[:144]
    qidx_o = pos[:143]
    # quad j of the count1 region sits at samples 2bv + 4j
    first_e = bvr >> 2                                      # bvr % 4 == 0
    first_o = (bvr - 2) >> 2                                # bvr % 4 == 2
    me = ((qidx_e >= first_e[..., None])
          & (qidx_e < first_e[..., None] + c1[..., None]))
    mo = ((qidx_o >= first_o[..., None])
          & (qidx_o < first_o[..., None] + c1[..., None]))
    sum0_e = torch.where(me, qe0, 0).sum(dim=-1)
    sum1_e = torch.where(me, qe1, 0).sum(dim=-1)
    sum0_o = torch.where(mo, qo0, 0).sum(dim=-1)
    sum1_o = torch.where(mo, qo1, 0).sum(dim=-1)
    even = (bvr & 3) == 0
    sum0 = torch.where(even, sum0_e, sum0_o)
    sum1 = torch.where(even, sum1_e, sum1_o)

    # ---- table choice per region (exact __new_choose_table replay)
    linmax = c["linmax"]
    linbits = c["linbits"]
    # no-linbits family: descending scan lands on 13, refined to 15 on <=
    nl_choice = torch.where(rc15 <= rc13, 15, 13)
    nl_cost = torch.where(rc15 <= rc13, rc15, rc13)
    # ESC families
    ixm = m - 15
    t16 = 15 + (linmax[15:24] < ixm[..., None]).sum(dim=-1)
    t24 = 24 + (linmax[24:32] < ixm[..., None]).sum(dim=-1)
    cost16 = torch.where(t16 == 15, rc15,
                         rc16 + linbits[t16.clamp(0, 31)] * rnesc)
    cost24 = rc24 + linbits[t24.clamp(24, 31)] * rnesc
    esc_choice = torch.where(cost24 < cost16, t24, t16)
    esc_cost = torch.where(cost24 < cost16, cost24, cost16)

    choice = torch.where(m == 0, 0,
                         torch.where(m < 15, nl_choice, esc_choice))
    rcost = torch.where(m == 0, 0, torch.where(m < 15, nl_cost, esc_cost))

    # region-active gating (big_v_tab_select, MP3_Encoder.py:1156-1168)
    active = torch.stack([a1 > 0, a2 > a1, bvr > a2], dim=-1)
    choice = torch.where(active, choice, 0)
    rcost = torch.where(active & (choice != 0), rcost, 0)

    bits_total = rcost.sum(dim=-1) + torch.minimum(sum0, sum1)

    out = dict(bail=bail, approx=approx, ixmax=ixmax, bv=bv, a1=a1, a2=a2,
               bits_total=bits_total)
    out_hide = dict(sum0=sum0, sum1=sum1, choice=choice, rc13=rc13,
                    rc15=rc15, rc16=rc16, rc24=rc24, rnesc=rnesc)
    return out, out_hide, c1


def _cost_pack(xr, band, with_hide: bool, c, work=None):
    """The chunk's cells packed into ONE int16 tensor (rows, n, S): the
    ``_BASE_KEYS`` rows, then with ``with_hide`` the ``_HIDE_SCALAR`` rows
    and 3 rows (one a region) of each ``_HIDE_R3`` key."""
    out, out_hide, c1 = _cost_all_steps(xr, band, c)
    if work is not None:
        work["cells"] = work.get("cells", 0) + c1.numel()
        work["pairs"] = work.get("pairs", 0) + int(out["bv"].sum())
        work["quads"] = work.get("quads", 0) + int(c1.sum())
        # what the cells read: the samples below max(i0, e) and the pairs
        # that start below e, e = max(bvr, a2) the end of the last region
        # and i0 = bvr + 4 c1 the end of the count1 quads
        bvr = 2 * out["bv"].to(torch.int64)
        a2 = out["a2"].to(torch.int64)
        work["samples"] = work.get("samples", 0) + int(
            torch.maximum(bvr + 4 * c1, a2).sum())
        work["region_pairs"] = work.get("region_pairs", 0) + int(
            ((torch.maximum(bvr, a2) + 1) >> 1).sum())
    if with_hide:
        out.update(out_hide)
    rows = [out[k].to(torch.int16) for k in _BASE_KEYS]
    if with_hide:
        rows += [out[k].to(torch.int16) for k in _HIDE_SCALAR]
        for k in _HIDE_R3:
            rows += [out[k][..., r].to(torch.int16) for r in range(3)]
    return torch.stack(rows)


def _check(xr: torch.Tensor):
    """What the wrapper takes: spectra (N, 576) int32 on the CPU or, C-
    contiguous, on a CUDA device."""
    if xr.dim() != 2 or xr.shape[1] != 576 or xr.dtype != torch.int32:
        raise ValueError(f"the cost grid wants spectra (N, 576) int32, got "
                         f"{tuple(xr.shape)} {xr.dtype}")
    if xr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the cost grid runs on CPU or CUDA tensors, got "
                         f"{xr.device}")
    if xr.device.type == "cuda" and not xr.is_contiguous():
        raise ValueError("the CUDA cost grid takes C-contiguous spectra")


def cost_all_steps_torch(xr: torch.Tensor, sr_idx: int,
                         with_hide: bool = False,
                         work: dict = None) -> torch.Tensor:
    """Plain PyTorch version of the grid on ``xr``'s device: the packed
    (rows, N, 128) int16 tensor the kernel writes (7 rows, 27 with
    ``with_hide``), ``CHUNK`` lanes at a time. ``work``, when given,
    gathers the function's work on this data: ``cells``, ``pairs`` (the
    cells' big-values pairs), ``quads`` (their count1 quads), ``samples``
    (the samples below the end of the quads or of the last region, the
    ones a cell reads) and ``region_pairs`` (the pairs below the end of
    the last region)."""
    _check(xr)
    c = _consts(xr.device)
    band = c["band"][sr_idx]
    rows = ROWS_HIDE if with_hide else ROWS_CLEAR
    if xr.shape[0] == 0:
        return torch.zeros((rows, 0, S_STEPS), dtype=torch.int16,
                           device=xr.device)
    return torch.cat([_cost_pack(xr[i:i + CHUNK], band, with_hide, c, work)
                      for i in range(0, xr.shape[0], CHUNK)], dim=1)


def _unpack(packed: np.ndarray, with_hide: bool) -> dict:
    out = {}
    i = 0
    for k in _BASE_KEYS:
        out[k] = packed[i]
        i += 1
    out["bail"] = out["bail"].astype(bool)
    out["approx"] = out["approx"].astype(bool)
    if with_hide:
        for k in _HIDE_SCALAR:
            out[k] = packed[i]
            i += 1
        for k in _HIDE_R3:
            out[k] = np.stack([packed[i + r] for r in range(3)], axis=-1)
            i += 3
    return out


def esc_table() -> np.ndarray:
    """The ESC families' choice as a function of a region's largest ix m
    (0 .. int2idx's largest, 1000), (1001,) int32: t16 | t24 << 8 |
    linbits(t16) << 16 | linbits(t24) << 24, with t16 = 15 +
    #(linmax[15..23] < m - 15) and t24 = 24 + #(linmax[24..31] < m - 15),
    their linbits indices clipped as ``_cost_all_steps`` clips them."""
    m = np.arange(int(T.loop_tables()[2].max()) + 1)[:, None] - 15
    t16 = 15 + (T.HUFF_LINMAX[15:24] < m).sum(axis=1)
    t24 = 24 + (T.HUFF_LINMAX[24:32] < m).sum(axis=1)
    lb = T.HUFF_LINBITS.astype(np.int64)
    return (t16 | t24 << 8 | lb[np.minimum(t16, 31)] << 16
            | lb[np.clip(t24, 24, 31)] << 24).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _kernel_tables(device: torch.device, sr_idx: int) -> tuple:
    """:func:`_consts` packed for the kernel: the small tables (1230,)
    int32 (steptabi 128, SUBDV_TABLE 46, the count1 lengths q0 16 and q1
    16, the band row 23, :func:`esc_table` 1001: the ESC rules as the
    kernel reads them),
    int2idx (10000,) int16 and the pair lengths of tables 13, 15, 16 and 24
    (4 * 256,) uint8 [t, x, y]."""
    c = _consts(device)
    small = torch.cat([c["steptabi"].to(torch.int32),
                       c["subdv"].reshape(-1), c["q0"], c["q1"],
                       c["band"][sr_idx],
                       torch.from_numpy(esc_table()).to(device)])
    hlen = torch.cat([c[k].reshape(-1) for k in ("h13", "h15", "h16",
                                                 "h24")])
    return small, c["int2idx"].to(torch.int16), hlen.to(torch.uint8)


@functools.lru_cache(maxsize=None)
def occupancy(device: torch.device) -> dict:
    """What the runtime gives the kernel on ``device``: the CTAs an SM
    holds (``ctas``), its warps a CTA (``warps``) and its bytes of dynamic
    shared memory a CTA (``smem``). Builds the kernel; raises on a CUDA
    error."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("cost_grid", _SIGNATURES)
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        rc = lib.cost_grid_occupancy(*(ctypes.addressof(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"cost_grid occupancy query failed: CUDA error "
                           f"{rc}")
    ctas, warps, smem = (v.value for v in out)
    if ctas < 1:
        raise RuntimeError("cost_grid_kernel fits no CTA on an SM")
    return dict(ctas=ctas, warps=warps, smem=smem)


@functools.lru_cache(maxsize=None)
def _grid_cap(device: torch.device) -> int:
    """The persistent grid: every SM full of CTAs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * occupancy(device)["ctas"]


def _launch(xr: torch.Tensor, sr_idx: int, rows: int) -> torch.Tensor:
    """One launch of ``csrc/cost_grid.cu`` over the spectra ``xr`` (N, 576)
    on the card: the packed (rows, N, 128) int16 grid."""
    global launches
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("cost_grid", _SIGNATURES)
    dev = xr.device
    n = xr.shape[0]
    out = torch.empty((rows, n, S_STEPS), dtype=torch.int16, device=dev)
    if n == 0:
        return out
    small, int2idx, hlen = _kernel_tables(dev, sr_idx)
    blocks = min(n, _grid_cap(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.cost_grid(xr.data_ptr(), n, rows, small.data_ptr(),
                           int2idx.data_ptr(), hlen.data_ptr(),
                           out.data_ptr(), blocks, stream)
    if rc != 0:
        raise RuntimeError(f"cost_grid kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def cost_all_steps(xr, sr_idx: int, with_hide: bool = False,
                   device=None) -> dict:
    """(N, 576) int32 spectra -> dict of (N, 128) numpy costing arrays:
    ``bail`` and ``approx`` bool, every other key int16. ``with_hide``
    adds the per-region cost channels (N, 128, 3) that replay the
    steganographic table transform (``choice``, ``rc13``, ``rc15``,
    ``rc16``, ``rc24``, ``rnesc``) and the count1 sums ``sum0``/``sum1``.

    :param xr: a torch tensor, which stays on its device, or a NumPy array,
        which moves to ``device`` (None means CUDA; a missing card raises).
    :param sr_idx: row of ``tables.BAND_ALL`` (the encoder's band row).

    On a CUDA tensor this is one launch of the hand-written kernel and one
    fetch (no launch for N = 0); a build or launch fault raises. CPU
    tensors take :func:`cost_all_steps_torch`."""
    if not isinstance(xr, torch.Tensor):
        xr = torch.from_numpy(np.ascontiguousarray(xr, np.int32)) \
            .to(resolve_device(device))
    _check(xr)
    if xr.device.type == "cpu":
        packed = cost_all_steps_torch(xr, sr_idx, with_hide)
    else:
        packed = _launch(xr, sr_idx, ROWS_HIDE if with_hide else ROWS_CLEAR)
    return _unpack(fetch_pieces([packed])[0], with_hide)


# ------------------------------------------------------------ host-side recost

def table_cost(cache: dict, g: int, s: int, region: int, table: int) -> int:
    """Bits to code ``region`` of granule g at step s under ``table``, from
    the grid's cost channels (the hide's replay prices transformed tables
    with it)."""
    if table == 0:
        return 0
    idx = (g, s, region)
    if table == 13:
        return int(cache["rc13"][idx])
    if table == 15:
        return int(cache["rc15"][idx])
    if 16 <= table <= 23:
        return int(cache["rc16"][idx]
                   + int(T.HUFF_LINBITS[table]) * cache["rnesc"][idx])
    if 24 <= table <= 31:
        return int(cache["rc24"][idx]
                   + int(T.HUFF_LINBITS[table]) * cache["rnesc"][idx])
    raise ValueError(f"unexpected table {table}")
