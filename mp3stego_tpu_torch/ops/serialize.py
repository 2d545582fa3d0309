"""The encoder's frame serializer on the card: a hand-written CUDA kernel
(``csrc/serialize.cu``) that packs every frame's header, side info and
Huffman main data from the quantized spectra where the rate search left
them, and its plain PyTorch version.

It writes the bytes of the host's serializer, ``mp3_format_frames``
(``native/src/mp3_serialize.cpp``, the C twin of the reference's
``__format_bitstream``), bit for bit: the same frames, the same count of
whole 32-bit words, and the same bits left in the 32-bit cache that a
windowed encode carries into its next call. The JAX package has no
counterpart: it serializes on the host with the same C source.

Inputs (the encoder builds them, ``MP3Encoder._serialize_fields``):

* ``ix`` (lanes, 576) int32, the signed quantized samples; lane ``g = ch *
  tg + f * gpf + gr`` (``tg = nf * gpf``), the search's order;
* ``side`` (14, lanes) int32, each lane's side fields in ``FIELDS`` order
  (``mp3_format_frames``' ``gi`` fields, then the three table selects);
* ``frames`` (nf, 10) int32: each frame's bitrate index, padding bit and
  scfsi (2 channels x 4 bands);
* ``cfg`` (36,) int32 (``config``): the header's constant fields, the
  channels, granules a frame and the band row of the sample rate;
* ``cache``, ``cache_bits``: the carried 32-bit cache as the C route keeps
  it (the pending bits left-aligned in ``cache``, ``32 - cache_bits`` of
  them); 0, 32 for a fresh stream.

Each call returns (the stream's whole words as bytes, an (N,) uint8 NumPy
array, N a multiple of 4; the new ``cache``; the new ``cache_bits``) and
raises the C route's ``RuntimeError`` where those bytes pass its buffer,
``nf * 2016 + 4096`` bytes. Scalefactors are written as zeros of their slen
widths, as the plane path has no others (``mp3_format_frames`` writes the
values of its ``sfl``, all zero there); a lane codes its own 576 samples
only (big_values at most 288, count1 quads inside the lane), which the
search's output always is.

* ``pack_frames`` — the wrapper. CUDA tensors launch ``csrc/serialize.cu``
  (lengths, scan, headers, pack; the design is in the source's head) on the
  current stream and fetch the finished words only; CPU tensors take the
  plain version. There is no fallback from the card to the host.
* ``pack_frames_torch`` — the plain version: every code's two puts and
  length at once, their bit positions by cumulative sums, the words by a
  scatter-add of each put's (non-overlapping) bits. It runs on its inputs'
  device and returns the same host triple.
* ``config`` — the ``cfg`` array from named fields.
* ``launches`` — how many serializations the kernel ran in this process.
"""

import contextlib
import ctypes
import functools

import numpy as np
import torch

from mp3stego_tpu_torch import tables as T
from mp3stego_tpu_torch.utils.transfer import fetch_pieces

launches = 0
FIELDS = ("part2_3_length", "big_values", "global_gain",
          "scalefac_compress", "region0_count", "region1_count", "preflag",
          "scalefac_scale", "count1table_select", "count1", "part2_length",
          "table_select0", "table_select1", "table_select2")
FRAME_INTS = 10                    # bitrate index, padding, scfsi (2, 4)
CONFIG = ("version", "layer", "crc", "sr_mod3", "ext", "mode", "mode_ext",
          "copyright", "original", "emphasis", "private_bits", "nch", "gpf")
FRAME_CAP = 2016                   # the C route's bytes a frame, + CAP_PAD
CAP_PAD = 4096
_CODES = 34 * 256                  # table entries: code | length << 24
_LINBITS = _CODES
_SLEN1 = _LINBITS + 32
_SLEN2 = _SLEN1 + 16
TABLE_INTS = _SLEN2 + 16

_SIGNATURES = {
    "serialize_frames": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int,
        ctypes.c_void_p)),
    "serialize_table_ints": (ctypes.c_int, ()),
}


def config(band, **fields) -> np.ndarray:
    """The (36,) int32 ``cfg``: each of ``CONFIG`` by name, then ``band``,
    the sample rate's row of ``tables.BAND_ALL`` (23 entries)."""
    band = np.asarray(band, np.int32).reshape(-1)
    if band.size != 23 or set(fields) != set(CONFIG):
        raise ValueError(f"config wants the fields {CONFIG} and a 23-entry "
                         f"band row")
    return np.concatenate([np.array([fields[k] for k in CONFIG], np.int32),
                           band])


def capacity(nf: int) -> int:
    """The bytes the C route's buffer holds for ``nf`` frames; a stream
    past it raises."""
    return nf * FRAME_CAP + CAP_PAD


@functools.lru_cache(maxsize=None)
def _host_tables() -> np.ndarray:
    """What the kernel reads, as int32: every Huffman table entry ``code |
    length << 24`` (34 x 16 x 16), linbits (32), slen1 and slen2 (16
    each)."""
    code = T.HUFF_CODE.reshape(-1).astype(np.int64)
    length = T.HUFF_LEN.reshape(-1).astype(np.int64)
    entries = (code | length << 24).astype(np.uint32).view(np.int32)
    return np.concatenate([entries, T.HUFF_LINBITS[:32].astype(np.int32),
                           T.SLEN1_TAB.astype(np.int32),
                           T.SLEN2_TAB.astype(np.int32)])


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    """``_host_tables`` on ``device``: 35 KB."""
    return torch.from_numpy(_host_tables()).to(device)


def _check(ix, side, frames, cfg):
    nf = frames.shape[0] if frames.dim() == 2 else 0
    cfg = np.asarray(cfg)
    if cfg.shape != (len(CONFIG) + 23,):
        raise ValueError(f"cfg wants {len(CONFIG) + 23} ints, got "
                         f"{cfg.shape}")
    c = dict(zip(CONFIG, (int(v) for v in cfg)))
    lanes = c["nch"] * c["gpf"] * nf
    if c["nch"] not in (1, 2) or c["gpf"] not in (1, 2):
        raise ValueError(f"nch {c['nch']} and gpf {c['gpf']}: 1 or 2 each")
    if frames.shape != (nf, FRAME_INTS) or frames.dtype != torch.int32 \
            or nf == 0:
        raise ValueError(f"frames wants (nf >= 1, {FRAME_INTS}) int32, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if ix.shape != (lanes, 576) or ix.dtype != torch.int32:
        raise ValueError(f"ix wants ({lanes}, 576) int32, got "
                         f"{tuple(ix.shape)} {ix.dtype}")
    if side.shape != (len(FIELDS), lanes) or side.dtype != torch.int32:
        raise ValueError(f"side wants ({len(FIELDS)}, {lanes}) int32, got "
                         f"{tuple(side.shape)} {side.dtype}")
    if not ix.device == side.device == frames.device:
        raise ValueError(f"ix on {ix.device}, side on {side.device}, "
                         f"frames on {frames.device}")
    return c


def _header_puts(c: dict, fr: torch.Tensor, fld: dict) -> list:
    """A frame's header and side info as (value (nf,), width) puts in
    stream order, from the frames' ints ``fr`` and the lanes' fields
    ``fld`` (name -> (lanes,))."""
    v3 = c["version"] == 3
    nf = fr.shape[0]
    frame = torch.arange(nf, device=fr.device)

    def const(v):
        return torch.full((nf,), int(v), dtype=torch.int64, device=fr.device)

    puts = [(const(0x7FF), 11), (const(c["version"]), 2),
            (const(c["layer"]), 2), (const(0 if c["crc"] else 1), 1),
            (fr[:, 0], 4), (const(c["sr_mod3"]), 2), (fr[:, 1], 1),
            (const(c["ext"]), 1), (const(c["mode"]), 2),
            (const(c["mode_ext"]), 2), (const(c["copyright"]), 1),
            (const(c["original"]), 1), (const(c["emphasis"]), 2)]
    if v3:
        puts += [(const(0), 9),
                 (const(c["private_bits"]), 3 if c["nch"] == 2 else 5)]
        puts += [(fr[:, 2 + 4 * ch + b], 1)
                 for ch in range(c["nch"]) for b in range(4)]
    else:
        puts += [(const(0), 8),
                 (const(c["private_bits"]), 2 if c["nch"] == 2 else 1)]
    for gr in range(c["gpf"]):
        for ch in range(c["nch"]):
            lane = ch * nf * c["gpf"] + frame * c["gpf"] + gr

            def f(name):
                return fld[name][lane]
            puts += [(f("part2_3_length"), 12), (f("big_values"), 9),
                     (f("global_gain"), 8),
                     (f("scalefac_compress"), 4 if v3 else 9),
                     (const(0), 1), (f("table_select0"), 5),
                     (f("table_select1"), 5), (f("table_select2"), 5),
                     (f("region0_count"), 4), (f("region1_count"), 3)]
            if v3:
                puts += [(f("preflag"), 1), (f("scalefac_scale"), 1),
                         (f("count1table_select"), 1)]
    return puts


def _pair_puts(tab: dict, t, x, y):
    """``__huffman_code``'s two puts of big-values pairs under tables
    ``t``: (code, its bits, escape bits, their bits), int64 tensors."""
    sx, sy = (x <= 0).long(), (y <= 0).long()
    ax, ay = x.abs(), y.abs()
    esc = t > 15
    lb = tab["linbits"][t & 31]
    bx, by = esc & (ax > 14), esc & (ay > 14)
    cx, cy = torch.where(bx, 15, ax), torch.where(by, 15, ay)
    p = (t * 256 + cx * 16 + cy).clamp(0, _CODES - 1)
    code, clen = tab["code"][p], tab["len"][p]
    nx, ny = (cx != 0).long(), (cy != 0).long()
    # tables 16-31: the code, then linbits and sign of x, of y
    ext = torch.where(bx, ax - 15, 0)
    ext = torch.where(nx > 0, (ext << 1) | sx, ext)
    ext = torch.where(by, (ext << lb) | (ay - 15), ext)
    ext = torch.where(ny > 0, (ext << 1) | sy, ext)
    xb = torch.where(bx, lb, 0) + nx + torch.where(by, lb, 0) + ny
    # tables 1-15: the code with the signs after it
    small = torch.where(nx > 0, (code << 1) | sx, code)
    small = torch.where(ny > 0, (small << 1) | sy, small)
    live = t != 0
    zero = torch.zeros_like(code)
    return (torch.where(live, torch.where(esc, code, small), zero),
            torch.where(live, torch.where(esc, clen, clen + nx + ny), zero),
            torch.where(live & esc, ext, zero),
            torch.where(live & esc, xb, zero))


def _quad_puts(tab: dict, c1sel, q):
    """``__huffman_coder_count1``'s two puts of quads ``q`` (..., 4)."""
    s = (q <= 0).long()
    a = q.abs()
    p = a[..., 0] + (a[..., 1] << 1) + (a[..., 2] << 2) + (a[..., 3] << 3)
    e = ((32 + c1sel) * 256 + p).clamp(0, _CODES - 1)
    signs = torch.zeros_like(p)
    nb = torch.zeros_like(p)
    for k in range(4):
        on = a[..., k] != 0
        signs = torch.where(on, (signs << 1) | s[..., k], signs)
        nb = nb + on.long()
    return tab["code"][e], tab["len"][e], signs, nb


def pack_frames_torch(ix: torch.Tensor, side: torch.Tensor,
                      frames: torch.Tensor, cfg, cache: int = 0,
                      cache_bits: int = 32) -> tuple:
    """Plain PyTorch version of the kernel, on its inputs' device: every
    code's two puts at once (each lane's 288 pairs, then its 144 quads,
    those past its counts empty), the scalefactors' zeros and the stuffing's
    ones, positions by cumulative sums, the words by a scatter-add of each
    put's bits (they never overlap, so the sum is their OR). Returns (bytes
    (N,) uint8 NumPy, cache, cache_bits)."""
    c = _check(ix, side, frames, cfg)
    band = torch.as_tensor(np.asarray(cfg)[len(CONFIG):], dtype=torch.int64,
                           device=ix.device)
    dev = ix.device
    nch, gpf, nf = c["nch"], c["gpf"], frames.shape[0]
    tg, pieces = nf * gpf, 1 + gpf * nch
    lanes = nch * tg
    raw = _tables(dev).to(torch.int64) & 0xFFFFFFFF
    tab = dict(code=raw[:_CODES] & 0xFFFFFF, len=raw[:_CODES] >> 24,
               linbits=raw[_LINBITS:_LINBITS + 32],
               slen1=raw[_SLEN1:_SLEN1 + 16], slen2=raw[_SLEN2:_SLEN2 + 16])
    fld = dict(zip(FIELDS, side.to(torch.int64).unbind(0)))
    fr = frames.to(torch.int64)
    g = torch.arange(lanes, device=dev)
    ch, f, gr = g // tg, (g % tg) // gpf, g % gpf
    piece = f * pieces + 1 + gr * nch + ch

    # the codes: pairs, then quads
    x = ix.to(torch.int64)
    pairs = fld["big_values"].clamp(0, 288)
    quads = torch.minimum(fld["count1"].clamp(min=0), (576 - 2 * pairs) // 4)
    r1 = band[(fld["region0_count"] + 1).clamp(0, 22)]
    r2 = band[(fld["region0_count"] + fld["region1_count"] + 2).clamp(0, 22)]
    i = 2 * torch.arange(288, device=dev)
    region = (i >= r1[:, None]).long() + (i >= r2[:, None]).long()
    t = torch.stack([fld[f"table_select{r}"] for r in range(3)], 1) \
        .gather(1, region)
    t = torch.where(torch.arange(288, device=dev) < pairs[:, None], t, 0)
    pc, pl, pe, pel = _pair_puts(tab, t, x[:, 0::2], x[:, 1::2])
    qi = (2 * pairs[:, None] + 4 * torch.arange(144, device=dev))
    qs = x.gather(1, (qi[..., None] + torch.arange(4, device=dev))
                  .clamp(max=575).reshape(lanes, -1)).reshape(lanes, 144, 4)
    qc, ql, qe, qel = _quad_puts(tab, fld["count1table_select"][:, None], qs)
    qon = torch.arange(144, device=dev) < quads[:, None]
    ql, qel = torch.where(qon, ql, 0), torch.where(qon, qel, 0)
    code, clen = torch.cat([pc, qc], 1), torch.cat([pl, ql], 1)
    ext, elen = torch.cat([pe, qe], 1), torch.cat([pel, qel], 1)
    n = clen + elen
    hw = n.sum(1)

    # each lane's piece: scalefactors, codes, stuffing
    sfc = fld["scalefac_compress"] & 15
    s1, s2 = tab["slen1"][sfc], tab["slen2"][sfc]
    scfsi = fr[f, 2:2 + 8].reshape(lanes, 2, 4)[torch.arange(lanes), ch]
    widths = torch.stack([6 * s1, 5 * s1, 5 * s2, 5 * s2], 1)
    sf = torch.where((gr[:, None] == 0) | (scfsi == 0), widths, 0).sum(1)
    stuff = (fld["part2_3_length"] - fld["part2_length"] - hw).clamp(min=0)
    length = torch.zeros(nf * pieces, dtype=torch.int64, device=dev)
    length[torch.arange(nf, device=dev) * pieces] = _header_bits(c)
    length[piece] = sf + hw + stuff
    pending = 32 - int(cache_bits)
    off = torch.cumsum(length, 0) - length + pending
    total = pending + int(length.sum())

    # the puts: (position, value, width)
    pos, val, wid = [], [], []
    if pending:
        pos.append(torch.zeros(1, dtype=torch.int64, device=dev))
        val.append(torch.tensor([int(cache) >> int(cache_bits)],
                                dtype=torch.int64, device=dev))
        wid.append(torch.tensor([pending], dtype=torch.int64, device=dev))
    at = off[torch.arange(nf, device=dev) * pieces]
    for v, w in _header_puts(c, fr, fld):
        pos.append(at)
        val.append(v)
        wid.append(torch.full_like(at, w))
        at = at + w
    base = off[piece] + sf
    first = base[:, None] + torch.cumsum(n, 1) - n
    for p_, v_, w_ in ((first, code, clen), (first + clen, ext, elen)):
        pos.append(p_.reshape(-1))
        val.append(v_.reshape(-1))
        wid.append(w_.reshape(-1))
    chunks = int((stuff.max() + 31) // 32)
    k = 32 * torch.arange(chunks, device=dev)
    sw = (stuff[:, None] - k).clamp(0, 32)
    pos.append((base + hw)[:, None] + k)
    val.append((1 << sw) - 1)
    wid.append(sw)
    pos, val, wid = (torch.cat([a.reshape(-1) for a in parts])
                     for parts in (pos, val, wid))
    on = wid > 0
    pos, val, wid = pos[on], val[on], wid[on]
    val = val & ((1 << wid) - 1)
    b = pos & 31
    span = b + wid
    hi = torch.where(span <= 32, val << (32 - span).clamp(min=0),
                     val >> (span - 32).clamp(min=0))
    lo = torch.where(span > 32, (val << (64 - span).clamp(max=63))
                     & 0xFFFFFFFF, 0)
    nw = total // 32
    if nw * 4 > capacity(nf):
        raise RuntimeError("native serializer buffer overflow")
    words = torch.zeros(nw + 2, dtype=torch.int64, device=dev)
    w0 = pos >> 5
    keep = w0 <= nw
    words.scatter_add_(0, w0[keep], hi[keep])
    keep = w0 + 1 <= nw
    words.scatter_add_(0, (w0 + 1)[keep], lo[keep])
    host = words.cpu().numpy()
    data = host[:nw].astype(">u4").view(np.uint8)
    rem = total & 31
    return (np.ascontiguousarray(data), int(host[nw]) if rem else 0,
            32 - rem)


def _header_bits(c: dict) -> int:
    """A frame's header and side info in bits (``csrc/serialize.cu``
    ``header_bits``)."""
    v3 = c["version"] == 3
    info = 9 + (3 if c["nch"] == 2 else 5) + 4 * c["nch"] if v3 else \
        8 + (2 if c["nch"] == 2 else 1)
    return 32 + info + c["gpf"] * c["nch"] * (59 if v3 else 61)


def _no_stage(name: str):
    return contextlib.nullcontext()


def pack_frames(ix: torch.Tensor, side: torch.Tensor, frames: torch.Tensor,
                cfg, cache: int = 0, cache_bits: int = 32,
                stage=_no_stage) -> tuple:
    """Serialize ``frames.shape[0]`` frames: (bytes (N,) uint8 NumPy, cache,
    cache_bits), see the module's docstring.

    On CUDA tensors this launches the hand-written kernel on the current
    stream, waits for the stream's length, and fetches the finished words
    alone, both fetches inside ``stage("d2h")`` (a ``StageTimer.stage``);
    a launch fault raises. CPU tensors take ``pack_frames_torch``."""
    global launches
    _check(ix, side, frames, cfg)
    if ix.device.type == "cpu":
        return pack_frames_torch(ix, side, frames, cfg, cache, cache_bits)
    if ix.device.type != "cuda":
        raise ValueError(f"pack_frames runs on CPU or CUDA tensors, got "
                         f"{ix.device}")
    words, off = _launch(ix.contiguous(), side.contiguous(),
                         frames.contiguous(), cfg, cache, cache_bits)
    launches += 1
    with stage("d2h"):
        return _collect(words, off, frames.shape[0])


def _launch(ix, side, frames, cfg, cache: int, cache_bits: int) -> tuple:
    """One run of ``csrc/serialize.cu`` on the current stream: (the output
    words (cap / 4 + 1,) int32, the offsets (pieces + 1,) int64, the
    stream's bits last); raises if a launch fails."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("serialize", _SIGNATURES)
    if lib.serialize_table_ints() != TABLE_INTS:
        raise RuntimeError("csrc/serialize.cu reads another table layout")
    dev = ix.device
    nf = frames.shape[0]
    c = dict(zip(CONFIG, (int(v) for v in np.asarray(cfg)[:len(CONFIG)])))
    n = nf * (1 + c["gpf"] * c["nch"])
    cap_words = capacity(nf) // 4 + 1
    words = torch.zeros(cap_words, dtype=torch.int32, device=dev)
    length = torch.empty(n, dtype=torch.int32, device=dev)
    off = torch.empty(n + 1, dtype=torch.int64, device=dev)
    host_cfg = np.ascontiguousarray(cfg, np.int32)
    tables = _tables(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.serialize_frames(
            host_cfg.ctypes.data, nf, ix.data_ptr(), side.data_ptr(),
            frames.data_ptr(), tables.data_ptr(), length.data_ptr(),
            off.data_ptr(), words.data_ptr(), cap_words,
            int(cache) & 0xFFFFFFFF, 32 - int(cache_bits), stream)
    if rc != 0:
        raise RuntimeError(f"serialize_frames kernel launch failed: CUDA "
                           f"error {rc}")
    return words, off


def _collect(words: torch.Tensor, off: torch.Tensor, nf: int) -> tuple:
    """The stream's length, then its whole words and the word that holds
    its last bits, fetched: (bytes, cache, cache_bits)."""
    total = int(fetch_pieces([off[-1:]])[0][0])
    nw = total // 32
    if nw * 4 > capacity(nf):
        raise RuntimeError("native serializer buffer overflow")
    data = fetch_pieces([words[:nw + 1]])[0].view(np.uint8)
    rem = total & 31
    cache = int.from_bytes(data[4 * nw:4 * nw + 4].tobytes(), "big") \
        if rem else 0
    return data[:4 * nw], cache, 32 - rem
