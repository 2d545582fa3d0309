"""The Huffman bit-scan kernel (``csrc/huffman.cu``) rehearsed on the CPU,
and the codebook table it reads.

* ``huffman_device.codebook_table``, the two-level table of 16-bit entries
  that the kernel reads from shared memory, gives the flat ``T.dec_lut``
  entry for every book and every 19-bit index (exhaustive), and fits the
  entry format; ``_host_tables`` lays out what the kernel loads (per table
  id metadata, QUAD_LUT, the entries two an int) and stays near 15 KB.
* ``csrc/huffman.cu`` itself, built for the host with g++ against the
  emulation of ``tests/cuda_host_shim.py`` and run through the wrapper's
  launch code (``huffman_device._launch``): bit for bit
  ``decode_samples_plain`` on the fixture, the 5 multirate goldens, the 4
  crafted MPEG-1 streams, the linbits stream of ``huffman_golden.npz``, a
  seeded bit-flipped fixture, a mono stream and ``chip_smoke``'s seeded
  synthetic lane set (every table id in each region, big2 = 0 and 576,
  13-linbits escapes, count1 tables A and B, end bits inside a quad, a
  lane whose words run out, a lane with no words); the chain-only entry's
  per-lane sums equal the plain plane's; the occupancy entry.
* The plain version runs on the host and hands the plane back on its
  inputs' device.

Tolerance: exact. Small inputs (at most a few hundred lanes), so the file
runs in seconds.
"""

import contextlib
import ctypes
import os
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cuda_host_shim  # noqa: E402
from chip_smoke import synthetic_lanes  # noqa: E402
from mp3stego_tpu_torch import tables as T  # noqa: E402
from mp3stego_tpu_torch.bitstream import decoder_host as pdh  # noqa: E402
from mp3stego_tpu_torch.ops import _cuda  # noqa: E402
from mp3stego_tpu_torch.ops import huffman_device as hd  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MULTIRATE = ("32000_64", "32000_192", "44100_128", "48000_96", "48000_320")
CRAFTED = ("is_long", "is_ms_long", "is_ms_short", "mixed_44k")


def _lookup(entries: np.ndarray, base: int, idx: np.ndarray) -> np.ndarray:
    """The kernel's two-level read of 19-bit indices ``idx`` in the book at
    ``base``."""
    rest = hd.LUT_BITS - hd.FIRST_BITS
    e = entries[base + (idx >> rest)].astype(np.int64)
    ext = (e >> 11) & 15
    sub = base + ((e & 0x7FF) << 1) + ((idx >> (rest - ext))
                                       & ((1 << ext) - 1))
    return np.where(e & hd.SUB, entries[np.where(e & hd.SUB, sub, 0)], e)


@pytest.mark.parametrize("book", range(15))
def test_codebook_table_equals_the_flat_lut_everywhere(book):
    entries, bases = hd.codebook_table()
    number = hd._codebooks()[book]
    got = _lookup(entries, int(bases[book]), np.arange(1 << hd.LUT_BITS))
    np.testing.assert_array_equal(got, T.dec_lut(number))


def test_codebook_table_layout():
    """7,522 entries at an 8-bit first level; leaves below the sub flag;
    every sub-table inside its book's span and no two overlapping."""
    entries, bases = hd.codebook_table()
    assert hd.FIRST_BITS == 8 and entries.size == 7522
    assert entries.dtype == np.uint16
    ends = list(bases[1:]) + [entries.size]
    for base, end in zip(bases, ends):
        first = entries[base:base + 256].astype(np.int64)
        sub = first[first & hd.SUB != 0]
        starts = base + ((sub & 0x7FF) << 1)
        sizes = 1 << ((sub >> 11) & 15)
        assert (starts >= base + 256).all() and (starts + sizes <= end).all()
        cover = np.zeros(end - base, np.int64)
        for a, n in zip(starts - base, sizes):
            cover[a:a + n] += 1
        assert (cover[256:] == 1).all()
        assert not (entries[base + 256:end] & hd.SUB).any()
    leaves = entries[entries & hd.SUB == 0].astype(np.int64)
    assert (leaves & 31).min() > 0 and leaves.max() < 1 << 13


def test_host_tables_are_what_the_kernel_loads():
    tab = hd._host_tables()
    entries, bases = hd.codebook_table()
    assert tab.dtype == np.int32 and tab.size % 4 == 0
    assert tab.size * 4 < 16 * 1024
    meta, quad = tab[:32].astype(np.int64), tab[32:96]
    np.testing.assert_array_equal(quad, T.QUAD_LUT)
    back = tab[96:].view(np.uint16)
    np.testing.assert_array_equal(back[:entries.size], entries)
    assert not back[entries.size:].any()
    base_of = dict(zip(hd._codebooks(), bases))
    for i, book in enumerate(T.DEC_CODEBOOK_OF):
        if i in (0, 4, 14):
            assert meta[i] == -1
            continue
        assert meta[i] & 0x3FFF == base_of[int(book)]
        assert (meta[i] >> 14) & 15 == T.DEC_LINBITS[i]
        assert (meta[i] >> 18) & 15 == T.DEC_MAXVAL[i] - 1


def _linbits() -> bytes:
    return np.load(os.path.join(GOLD, "huffman_golden.npz"))[
        "linbits"].tobytes()


def _fixture() -> bytes:
    return np.load(os.path.join(GOLD, "encode_golden.npz"))[
        "mp3_bytes"].tobytes()


def _flipped() -> bytes:
    """The fixture with 40 seeded bit flips inside frames' main data."""
    data = _fixture()
    sizes = pdh.parse_mp3(data, 0).frame_sizes
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rng = np.random.default_rng(21)
    b = bytearray(data)
    for _ in range(40):
        f = int(rng.integers(0, len(sizes)))
        b[int(starts[f]) + int(rng.integers(36, int(sizes[f])))] ^= \
            1 << int(rng.integers(0, 8))
    return bytes(b)


def _mono() -> bytes:
    """A seeded 0.3 s mono stream the port encodes on the CPU."""
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.utils.wav import WavFile
    rng = np.random.default_rng(8)
    t = np.arange(13230)
    pcm = np.clip((0.4 * np.sin(2 * np.pi * 440 * t / 44100)
                   + 0.05 * rng.standard_normal(t.size)) * 30000,
                  -32768, 32767).astype(np.int16)
    enc = MP3Encoder(WavFile(file_path="m.wav", bitrate=128,
                             num_of_channels=1, samplerate=44100,
                             bits_per_sample=16, num_of_samples=pcm.size,
                             mpeg_mode=3, buffer=pcm), device="cpu")
    enc.encode()
    return bytes(enc.out_buffer)


def _stream_lanes(data: bytes) -> tuple:
    _, desc = pdh.parse_mp3_light(data, 0)
    return hd.pack(desc)


CASES = {"fixture": lambda: _stream_lanes(_fixture()),
         **{f"multirate {t}": (lambda t=t: _stream_lanes(np.load(
             os.path.join(GOLD, "multirate_golden.npz"))[f"mp3_{t}"]
             .tobytes())) for t in MULTIRATE},
         **{f"crafted {n}": (lambda n=n: _stream_lanes(np.load(
             os.path.join(GOLD, "crafted_golden.npz"))[n].tobytes()))
            for n in CRAFTED},
         "linbits": lambda: _stream_lanes(_linbits()),
         "fixture, bits flipped": lambda: _stream_lanes(_flipped()),
         "mono": lambda: _stream_lanes(_mono()),
         "synthetic lanes": synthetic_lanes}


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/huffman.cu built for the host with g++ against the emulation of
    ``tests/cuda_host_shim.py``. Returns the loaded library."""
    return cuda_host_shim.build("huffman", tmp_path_factory.mktemp(
        "huffman_host"), hd._SIGNATURES)


def _on_host(lib, monkeypatch):
    """Route ``hd._launch`` to the host build: CPU tensors, stream 0.
    Returns a launch that fails instead of hanging."""
    monkeypatch.setattr(_cuda, "load", lambda name, sig: lib)
    monkeypatch.setattr(hd, "_grid_cap", lambda dev: 3, raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())

    def launch(entry, words, fields, out):
        th = threading.Thread(target=lambda: hd._launch(
            entry, words, fields, out), daemon=True)
        th.start()
        th.join(300)
        assert not th.is_alive(), "the host build of the kernel hung"
        return out
    return launch


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_source_on_the_host_equals_plain(name, host_kernel,
                                                monkeypatch):
    launch = _on_host(host_kernel, monkeypatch)
    words, fields = (torch.from_numpy(a) for a in CASES[name]())
    g = fields.shape[0]
    want = hd.decode_samples_plain(words, fields)
    got = launch("huffman_scan", words, fields,
                 torch.full((2, g // 2, 576), -7, dtype=torch.int32))
    assert torch.equal(got, want)
    chain = launch("huffman_scan_chain", words, fields,
                   torch.zeros(g, dtype=torch.int32))
    lanes = want.permute(1, 0, 2).reshape(g, 576).to(torch.int64)
    sums = (lanes * torch.arange(1, 577)).sum(1)
    sums = ((sums + 2**31) % 2**32 - 2**31).to(torch.int32)
    assert torch.equal(chain, sums)
    if name == "synthetic lanes":
        assert want.abs().max() > 15 + (1 << 12)     # a 13-linbits escape
        assert (want[:, :48, 575] != 0).any()        # big2 = 576 lanes
        assert not want[1, 4].any()                  # lane 9: no words
    if name == "mono":
        assert not want[1].any()


def test_kernel_takes_words_off_a_16_byte_boundary(host_kernel,
                                                   monkeypatch):
    """Words that do not start on a 16-byte boundary (the kernel stages
    them in 16-byte chunks) are copied before the launch."""
    launch = _on_host(host_kernel, monkeypatch)
    words, fields = (torch.from_numpy(a) for a in CASES["fixture"]())
    buf = torch.zeros(words.numel() + 1, dtype=torch.int32)
    buf[1:] = words
    off = buf[1:]
    assert off.data_ptr() % 16
    got = launch("huffman_scan", off, fields,
                 torch.empty((2, fields.shape[0] // 2, 576),
                             dtype=torch.int32))
    assert torch.equal(got, hd.decode_samples_plain(words, fields))


def test_occupancy_entry_on_the_host(host_kernel):
    out = [ctypes.c_int(0) for _ in range(3)]
    n = hd._host_tables().size
    assert host_kernel.huffman_occupancy(
        n, *(ctypes.addressof(v) for v in out)) == 0
    ctas, threads, smem = (v.value for v in out)
    assert ctas >= 1 and threads % 32 == 0 and smem > 4 * n


def test_plain_version_runs_on_the_host():
    """On CPU tensors the wrapper takes the plain version, which builds its
    flat LUTs in host memory and nowhere else."""
    words, fields = (torch.from_numpy(a) for a in synthetic_lanes(4, 2))
    before = hd.launches
    got = hd.decode_samples(words, fields)
    assert hd.launches == before
    assert got.device.type == "cpu" and got.shape == (2, 8, 576)
    luts = hd._plain_tables()[0]
    assert luts.device.type == "cpu" and luts.numel() == 15 << hd.LUT_BITS
