"""The device Huffman decode: the per-granule bit-scan of the sample values,
as a hand-written CUDA kernel, and its plain PyTorch version.

The host keeps the sync walk, the side info, the bit-reservoir splice and
the scalefactors (the native light parse,
``bitstream.decoder_host.parse_mp3_light_native``, which ``parse_mp3``
runs by default; its Python twin ``parse_mp3_light`` with ``pack`` is the
oracle the tests hold it to); the device walks each granule's Huffman code
and writes the (2, T, 576) int32 sample plane that the decode plane reads
as ``raw_dense`` (``ops/decode_plane.granule_blocks``). A single-file
decode on the card takes this route (``decode_plane.scan_lanes``). It is
the port of the JAX package's ``ops/huffman_device.decode_samples_device``,
an XLA ``fori_loop`` that decodes 8 symbols of every granule per step in
lockstep.

Layout (``pack``, the counterpart of the JAX package's ``pack_descriptors``,
which pads every lane's words to one row of the longest frame's length
plus 4 words, so that XLA reads a rectangle; a thread reads its own lane's
words by index, so ``pack`` stores each frame's words once and no lane
carries padding). Lane ``g`` is one granule of one channel, in parse order
frame ▸ gr ▸ ch (G = 4 F lanes); its samples go to ``out[ch, 2 f + gr]``.
Each frame's spliced main data is stored once, as big-endian 32-bit words,
the frames back to back with ``PAD_WORDS`` zero words at the end. Each lane
has 8 int32 fields (``FIELDS``): its frame's first word and word count, the
first sample bit (after the scalefactors) and the end bit
(``part2_3_length``), the two region boundaries, 2 x big_values, and its
three table selections and count1 table packed as ``ts0 | ts1 << 5 | ts2 <<
10 | c1sel << 15``. A lane reads its frame's words only: bits past them
read as zeros, as in the JAX package's zero-padded rows.

Semantics (the JAX package's, each step of the reference's
decoder/Frame.py:443-559):

* big-values pairs ``2k < big2``: the region's table picks a codebook
  (tables 0, 4 and 14 decode as a skip); the next 19 bits index its LUT of
  packed ``x << 9 | y << 5 | length``; a length of 0 (no codeword: a corrupt
  stream) skips the pair and consumes nothing; each of x and y then reads
  ``linbits`` more bits where it is the escape ``maxval - 1``, and a sign
  bit where it is nonzero;
* count1 quads from ``big2`` while the cursor is below the end bit and the
  quad's first sample is below 572: table B is 4 inverted bits, table A the
  6-bit ``QUAD_LUT``; then a sign bit per nonzero value.

* ``decode_samples`` — the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches ``csrc/huffman.cu`` (one thread walks one lane with
  a bit cursor; the codebooks as ``codebook_table``'s two-level table,
  ~15 KB, the small tables and each warp's frames' words in shared memory;
  the design is in the source's head) or raises. There is no fallback from
  the card to the plain version, nor to the host parse.
* ``decode_samples_plain`` — the plain PyTorch version: every lane at once,
  one pair (then one quad) per step, reading the stream at each lane's cursor
  straight from the words and each codeword from its book's flat 2^19-entry
  LUT (``T.dec_lut``). It runs on the host whatever its inputs' device, so
  the flat LUTs (30 MiB) never go to the card. The kernel equals it bit for
  bit.
* ``scan_chain`` — the kernel's walk without the plane's stores (each lane's
  weighted sum of its samples), a measurement of the chain alone.
* ``occupancy`` — the runtime's CTAs an SM for the kernel.
* ``launches`` — how many times the kernel was launched in this process.
"""

import ctypes
import functools

import numpy as np
import torch

from mp3stego_tpu_torch import tables as T
from mp3stego_tpu_torch.utils.transfer import put_tree

launches = 0
LUT_BITS = T.LUT_BITS            # 19: the longest big-values codeword
PAD_WORDS = 4
FIELDS = ("wbase", "wlen", "start_bit", "max_bit", "region0", "region1",
          "big2", "tsc")
PAIRS, QUADS = 288, 144
FIRST_BITS = 8                   # the codebook table's first-level index
SUB = 0x8000                     # a first-level entry that names a sub-table

_SCAN_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p)
_SIGNATURES = {
    "huffman_scan": (ctypes.c_int, _SCAN_ARGS),
    "huffman_scan_chain": (ctypes.c_int, _SCAN_ARGS),
    "huffman_occupancy": (ctypes.c_int, (ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_void_p)),
}


def _codebooks() -> list:
    """The big-values codebooks a table id can pick, ascending."""
    return sorted({int(b) for b in T.DEC_CODEBOOK_OF if b != 0})


@functools.lru_cache(maxsize=None)
def codebook_table() -> tuple:
    """The 15 codebooks as one two-level table of 16-bit entries, the
    kernel's: (entries (N,) uint16, each book's first-level base (15,)
    int32, in ``_codebooks`` order).

    A book's first level has 2^FIRST_BITS entries, indexed by the next
    ``FIRST_BITS`` bits of the stream. Where every codeword under that
    prefix fits in it, the entry is the flat LUT's ``x << 9 | y << 5 |
    length`` (``T.dec_lut``, equal for all 2^(19 - FIRST_BITS) indices it
    covers); else it is ``SUB | ext << 11 | offset // 2``: a sub-table at
    ``base + offset`` of 2^ext entries, ``ext`` the longest such codeword's
    bits past the first level, indexed by those ``ext`` bits. Sub-tables
    follow their book's first level."""
    chunks, bases, at = [], [], 0
    for book in _codebooks():
        lut = T.dec_lut(book).astype(np.int64)
        rows = lut.reshape(1 << FIRST_BITS, -1)
        first = np.zeros(1 << FIRST_BITS, np.int64)
        subs, rel = [], 1 << FIRST_BITS
        for p, row in enumerate(rows):
            ext = max(int((row & 31).max()) - FIRST_BITS, 0)
            if ext == 0:
                assert (row == row[0]).all()
                first[p] = row[0]
                continue
            sub = row.reshape(1 << ext, -1)
            assert (sub == sub[:, :1]).all()
            assert rel % 2 == 0 and rel // 2 < 1 << 11 and ext < 16
            first[p] = SUB | ext << 11 | rel // 2
            subs.append(sub[:, 0])
            rel += 1 << ext
        bases.append(at)
        chunks += [first] + subs
        at += rel
    table = np.concatenate(chunks)
    assert table.max() < 1 << 16 and at < 1 << 14
    return table.astype(np.uint16), np.asarray(bases, np.int32)


@functools.lru_cache(maxsize=None)
def _host_tables() -> np.ndarray:
    """What ``csrc/huffman.cu`` loads into shared memory, as int32: per
    table id (32) -1 for a skip (tables 0, 4, 14) or its codebook's
    first-level base | linbits << 14 | (maxval - 1) << 18, then QUAD_LUT
    (64), then ``codebook_table``'s entries two an int (little-endian),
    zero-padded to a multiple of 4 ints."""
    entries, bases = codebook_table()
    base_of = dict(zip(_codebooks(), bases))
    meta = np.array([-1 if i in (0, 4, 14) else
                     int(base_of[int(b)]) | int(T.DEC_LINBITS[i]) << 14
                     | (int(T.DEC_MAXVAL[i]) - 1) << 18
                     for i, b in enumerate(T.DEC_CODEBOOK_OF)], np.int64)
    pad = (-entries.size) % 8
    packed = np.concatenate([entries, np.zeros(pad, np.uint16)]).view(
        "<u4").astype(np.int64)
    return np.concatenate([meta, T.QUAD_LUT, packed]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    """``_host_tables`` on ``device``: about 15 KB."""
    return torch.from_numpy(_host_tables()).to(device)


@functools.lru_cache(maxsize=None)
def _plain_tables():
    """The plain version's tables, on the host: (the flat LUTs (books *
    2^19,) int32, 2 MiB a codebook; book row per table id (-1 for a skip),
    linbits, maxval (32 each); QUAD_LUT (64))."""
    books = _codebooks()
    row_of = {b: i for i, b in enumerate(books)}
    luts = np.concatenate([T.dec_lut(b) for b in books]).astype(np.int32)
    book_row = np.array([row_of.get(int(b), -1) if i not in (0, 4, 14)
                         else -1 for i, b in enumerate(T.DEC_CODEBOOK_OF)],
                        dtype=np.int32)
    return tuple(torch.from_numpy(a) for a in (
        luts, book_row, T.DEC_LINBITS.astype(np.int32),
        T.DEC_MAXVAL.astype(np.int32), T.QUAD_LUT.astype(np.int32)))


def pack(descriptors: list) -> tuple:
    """``parse_mp3_light`` descriptors -> (words (W,) int32 holding the
    big-endian uint32 words of each frame's main data once, fields (G, 8)
    int32 in ``FIELDS`` order). Lanes of one frame share its ``md`` object;
    an empty ``md`` (a mono stream's second channel) gets no words. The
    native light parse writes the same arrays."""
    chunks, fields = [], np.zeros((len(descriptors), 8), np.int64)
    base, prev_md, wbase = 0, None, 0
    for i, d in enumerate(descriptors):
        md = d["md"]
        if md and md is not prev_md:
            wbase = base
            chunks.append(md + b"\0" * (-len(md) % 4))
            base += (len(md) + 3) // 4
            prev_md = md
        nwords = (len(md) + 3) // 4
        ts = d["ts"]
        fields[i] = (wbase if nwords else 0, nwords, d["start_bit"],
                     d["max_bit"], d["region0"], d["region1"], d["big2"],
                     int(ts[0]) | int(ts[1]) << 5 | int(ts[2]) << 10
                     | int(d["c1sel"]) << 15)
    data = b"".join(chunks) + b"\0" * (4 * PAD_WORDS)
    words = np.frombuffer(data, dtype=">u4").astype(np.uint32).view(np.int32)
    return words, fields.astype(np.int32)


def _check(words: torch.Tensor, fields: torch.Tensor):
    if words.dim() != 1 or words.dtype != torch.int32 \
            or words.shape[0] < PAD_WORDS:
        raise ValueError(f"decode_samples wants words (W >= {PAD_WORDS},) "
                         f"int32, got {tuple(words.shape)} {words.dtype}")
    if fields.dim() != 2 or fields.shape[1] != 8 \
            or fields.dtype != torch.int32 or fields.shape[0] % 4:
        raise ValueError(f"decode_samples wants fields (4 F, 8) int32, got "
                         f"{tuple(fields.shape)} {fields.dtype}")
    if words.device != fields.device:
        raise ValueError(f"words on {words.device}, fields on "
                         f"{fields.device}")


def decode_samples_plain(words: torch.Tensor,
                         fields: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: every lane in lockstep, 288 pair
    steps then 144 quad steps, each peek read from the words at the lane's
    bit cursor, each codeword from its codebook's flat 2^19-entry LUT.
    Runs on the host (the flat LUTs, 30 MiB, never go to the card) and
    returns (2, 2 F, 576) int32 on ``words``' device."""
    _check(words, fields)
    home = words.device
    words, fields = words.cpu(), fields.cpu()
    dev = words.device
    g = fields.shape[0]
    luts, book_row, linbits, maxval, quad_lut = _plain_tables()
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    f = fields.to(torch.int64).unbind(1)
    wbase, wlen, bit, max_bit, region0, region1, big2, tsc = f
    ts = [(tsc >> (5 * r)) & 31 for r in range(3)]
    c1sel = (tsc >> 15) & 1
    last = w64.shape[0] - 1
    lanes = torch.arange(g, device=dev)
    out = torch.zeros((g, 576), dtype=torch.int64, device=dev)

    def word(i):
        """Word ``i`` of each lane's frame; zero past its words."""
        return torch.where(i < wlen, w64[(wbase + i).clamp(0, last)], 0)

    def peek(n: int, at):
        """The ``n`` bits (n <= 32) of each lane's stream from bit ``at``."""
        i = at >> 5
        wide = (word(i) << 32) | word(i + 1)
        return (wide >> (64 - n - (at & 31))) & ((1 << n) - 1)

    for k in range(PAIRS):
        sample = 2 * k
        table = torch.where(sample < region0, ts[0],
                            torch.where(sample < region1, ts[1], ts[2]))
        book = book_row[table]
        decodable = (sample < big2) & (table != 0) & (book >= 0)
        packed = luts[book.clamp(min=0) * (1 << LUT_BITS) + peek(LUT_BITS, bit)]
        size = (packed & 31).to(torch.int64)
        hit = decodable & (size > 0)
        bit = bit + torch.where(hit, size, 0)
        lb = linbits[table].to(torch.int64)
        mv = maxval[table].to(torch.int64)
        vals = []
        for v in ((packed >> 9).to(torch.int64),
                  ((packed >> 5) & 15).to(torch.int64)):
            esc = hit & (lb != 0) & (v == mv - 1)
            ext = torch.where(esc, peek(16, bit) >> (16 - lb), 0)
            bit = bit + torch.where(esc, lb, 0)
            signed = hit & (v > 0)
            neg = signed & (peek(1, bit) > 0)
            bit = bit + signed.to(torch.int64)
            vals.append(torch.where(neg, -(v + ext), v + ext))
        for j, v in enumerate(vals):
            out[:, sample + j] = torch.where(hit, v, out[:, sample + j])

    for q in range(QUADS):
        sample = big2 + 4 * q
        active = (bit < max_bit) & (sample + 4 < 576)
        use_b = c1sel == 1
        b4 = peek(4, bit)
        qpacked = quad_lut[peek(6, bit)].to(torch.int64)
        p = qpacked >> 5
        size = torch.where(use_b, 4, qpacked & 31)
        bit = bit + torch.where(active, size, 0)
        for i in range(4):
            s = 3 - i
            v = torch.where(use_b, 1 - ((b4 >> s) & 1), (p >> s) & 1)
            signed = active & (v > 0)
            neg = signed & (peek(1, bit) > 0)
            bit = bit + signed.to(torch.int64)
            pos = (sample + i).clamp(max=575)
            cur = out[lanes, pos]
            out[lanes, pos] = torch.where(active, torch.where(neg, -v, v),
                                          cur)
    return out.to(torch.int32).reshape(-1, 2, 2, 576) \
        .permute(2, 0, 1, 3).reshape(2, -1, 576).contiguous().to(home)


def decode_samples(words: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
    """(words (W,), fields (4 F, 8)) int32 -> the sample plane (2, 2 F,
    576) int32, ``out[ch, 2 f + gr]``.

    On CUDA tensors this launches the hand-written kernel on the current
    stream; a launch fault raises. CPU tensors take
    ``decode_samples_plain``."""
    global launches
    _check(words, fields)
    if words.device.type == "cpu":
        return decode_samples_plain(words, fields)
    if words.device.type != "cuda":
        raise ValueError(f"decode_samples runs on CPU or CUDA tensors, got "
                         f"{words.device}")
    g = fields.shape[0]
    out = torch.empty((2, g // 2, 576), dtype=torch.int32, device=words.device)
    _launch("huffman_scan", words.contiguous(), fields.contiguous(), out)
    launches += 1
    return out


def scan_chain(words: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
    """The kernel's walk without the plane's stores, a measurement: CUDA
    ``(words, fields)`` -> (4 F,) int32, each lane's sum of (s + 1) x its
    sample s, wrapped to 32 bits. Not counted in ``launches``."""
    _check(words, fields)
    if words.device.type != "cuda":
        raise ValueError(f"scan_chain runs on CUDA tensors, got "
                         f"{words.device}")
    out = torch.empty(fields.shape[0], dtype=torch.int32, device=words.device)
    _launch("huffman_scan_chain", words.contiguous(), fields.contiguous(),
            out)
    return out


def _launch(entry: str, words: torch.Tensor, fields: torch.Tensor,
            out: torch.Tensor) -> None:
    """One launch of ``csrc/huffman.cu``'s ``entry`` on the current stream;
    raises if it fails."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("huffman", _SIGNATURES)
    if words.data_ptr() % 16:          # the kernel stages 16-byte chunks
        words = words.clone()
    tables = _tables(words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    with torch.cuda.device(words.device):
        rc = getattr(lib, entry)(words.data_ptr(), fields.data_ptr(),
                                 fields.shape[0], tables.data_ptr(),
                                 tables.numel(), out.data_ptr(),
                                 words.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def occupancy(device: torch.device) -> dict:
    """What the runtime gives the kernel on ``device``: CTAs an SM
    (``ctas``), warps a CTA (``warps``), bytes of dynamic shared memory a
    CTA (``smem``: the tables and each warp's staged words). Builds the
    kernel; raises on a CUDA error."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("huffman", _SIGNATURES)
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        rc = lib.huffman_occupancy(_host_tables().size,
                                   *(ctypes.addressof(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"huffman occupancy query failed: CUDA error "
                           f"{rc}")
    ctas, threads, smem = (v.value for v in out)
    return dict(ctas=ctas, warps=threads // 32, smem=smem)


def decode_raw_device(descriptors: list, device) -> torch.Tensor:
    """``parse_mp3_light`` descriptors -> the (2, T, 576) int32 sample plane,
    resident on ``device`` (the decode plane's ``raw_dense``)."""
    words, fields = pack(descriptors)
    up = put_tree({"words": words, "fields": fields}, device)
    return decode_samples(up["words"], up["fields"])
