"""Card tests of the torch port: the hand-written rate-search kernel K4
(bit for bit its plain version on every row, count and ix plane, in clear,
hide and window mode and for the one-step VBR cost, on the golden fixture's
spectra and seeded, forced-flag and INT32_MIN lanes; one launch a call; the
wrapper refuses what it cannot launch), the hand-written Huffman bit-scan kernel
(bit for bit its plain version on the goldens, crafted and corrupt streams,
and the device-Huffman decode's WAV bytes), the streaming encode on the
card, the hand-written fused synthesis kernel (on
a song's rows, odd tile counts and a batch's (file, channel) rows, in float32
and float64, float and int16 epilogues), the hand-written granule kernel
K2 (bit for bit its plain version in both dtypes on the synthetic batch,
crafted, LSF, mono and device-Huffman preps; a file's blocks alike alone
and in a concat batch; ``stages`` beside it; the wrapper's refusals), the
device decode plane in both
precisions (float64 with the host plane's bytes), the default façade decode,
the batched decode (one kernel launch per chunk), K1 after a halo, the
frame-sharded decode and the mesh batches on entries of cuda:0, and the
encode planes (Q31
analysis K3 at its launch shapes, on tile edges and from the WAV's
interleaved buffer, with no channel stream built on the host by a
whole-file encode; exact search, the VBR lane cost, golden hide bytes;
the frame serializer kernel on a seeded song's clear encode and hide, from
the resident ``ix``, with the C route's bytes),
each equal to the plain version, the CPU torch result or the native host twin;
and the pinned staging of ``utils/transfer`` (held results and views
through later fetches, uploads queued behind a long kernel, a producer on
a non-default stream) and the probe without the golden stream. Marked
``cuda``; without a card every test skips.

This file imports no JAX and uses no conftest fixture (tests/conftest.py
imports JAX, which the card's machine does not have). Run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

@pytest.fixture
def card():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _blk(rows, t, seed, dtype, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(0.3 * rng.standard_normal((rows, t, 32, 36))) \
        .to(device=device, dtype=dtype)


# (rows, granules): a 240.7 s song's two channels, one granule, odd counts
# around the kernel's tiles (8 granules in float32, 4 in float64), and the
# batched decode's largest chunk of 16 stereo 30 s files
SHAPES = [(2, 18432), (2, 1), (1, 7), (2, 9), (1, 5), (32, 2298)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("out", ["float", "int16"])
@pytest.mark.parametrize("rows,t", SHAPES)
def test_kernel_equals_plain_version_bitwise(card, dtype, out, rows, t):
    from mp3stego_tpu_torch.ops import synth as sf
    blk = _blk(rows, t, rows * 7 + t, dtype, card)
    ch = 2 if rows % 2 == 0 else 1
    before = sf.launches
    got = sf.synth_fused(blk, out, ch)
    want = sf.synth_fused_torch(blk, out, ch)
    torch.cuda.synchronize()
    assert sf.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_halo_continuity(card, dtype):
    """Rows are independent and tiles join without a seam: each row of a
    batch equals the same row alone, and both equal the plain version."""
    from mp3stego_tpu_torch.ops import synth as sf
    blk = _blk(3, 41, 1, dtype, card)
    whole = sf.synth_fused(blk)
    for r in range(3):
        assert torch.equal(whole[r:r + 1],
                           sf.synth_fused(blk[r:r + 1].contiguous()))
    assert torch.equal(whole, sf.synth_fused_torch(blk))


@pytest.mark.parametrize("wrap", [False, True])
def test_kernel_int16_epilogue_clips_like_the_plain_version(card, wrap,
                                                            monkeypatch):
    """Loud blocks (PCM well above full scale): saturation and wrap."""
    from mp3stego_tpu_torch.ops import synth as sf
    if wrap:
        monkeypatch.setenv("MP3STEGO_TPU_REF_PCM_WRAP", "1")
    for dtype in (torch.float32, torch.float64):
        blk = 40 * _blk(2, 13, 2, dtype, card)
        got = sf.synth_fused(blk, "int16", 2)
        want = sf.synth_fused_torch(blk, "int16", 2)
        assert (sf.synth_fused_torch(blk).abs() > 1).any()
        assert torch.equal(got, want)


def test_kernel_wrapper_refuses_what_it_cannot_launch(card):
    from mp3stego_tpu_torch.ops import synth as sf
    blk = _blk(2, 4, 3, torch.float32, card)
    with pytest.raises(ValueError, match="float32 or float64"):
        sf.synth_fused(blk.half())
    with pytest.raises(ValueError, match="contiguous"):
        sf.synth_fused(blk.transpose(2, 3).contiguous().transpose(2, 3))
    flat = torch.zeros(blk.numel() + 1, device=card)
    with pytest.raises(ValueError, match="aligned"):
        sf.synth_fused(flat[1:].view(blk.shape))


def test_card_plane_matches_host_float64(card):
    """Synthetic batch (short, start, mixed, MS, intensity, linbits): card
    float32 against the host float64 NumPy plane. The batch peaks far above
    full scale, so the float32 bound of tests/test_precision.py (1e-5 on
    unit-scale audio) scales with its peak."""
    from chip_smoke import synthetic_prep
    from mp3stego_tpu_torch.ops import decode_plane as dp
    from mp3stego_tpu_torch.ops import synth as sf
    prep = synthetic_prep(64)
    want = dp.decode_granules_np(prep)
    before = sf.launches
    got = dp.decode_granules(dp.prep_to_torch(prep, card), torch.float32)
    assert sf.launches == before + 1
    got = got.cpu().numpy()
    assert np.abs(got - want).max() < 1e-5 * max(1.0, np.abs(want).max())


def test_card_float64_plane_writes_host_bytes(card):
    """The float64 plane on the card: PCM bit for bit the NumPy plane's on
    the synthetic batch, and the fixture's int16 samples equal the host C++
    plane's."""
    import os
    from chip_smoke import synthetic_prep
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    prep = synthetic_prep(64)
    got = dp.decode_granules(dp.prep_to_torch(prep, card), torch.float64)
    assert np.array_equal(got.cpu().numpy(), dp.decode_granules_np(prep))
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    data = np.load(os.path.join(gold, "encode_golden.npz"))["mp3_bytes"]
    parsed = dh.parse_mp3(data.tobytes(), 0)
    assert np.array_equal(dp.decode_pcm_i16(parsed, card, "float64"),
                          dp.decode_pcm_i16_host(parsed))


def test_default_facade_decode_is_the_card_and_the_host_bytes(card,
                                                              tmp_path):
    """``Steganography()`` with no arguments decodes on the card (one
    kernel launch) and writes the host C++ plane's WAV bytes."""
    import os
    from mp3stego_tpu_torch import Steganography
    from mp3stego_tpu_torch.ops import synth as sf
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    mp3 = tmp_path / "f.mp3"
    mp3.write_bytes(np.load(os.path.join(gold, "encode_golden.npz"))[
        "mp3_bytes"].tobytes())
    before = sf.launches
    Steganography(quiet=True).decode_mp3_to_wav(str(mp3),
                                                str(tmp_path / "c.wav"))
    assert sf.launches == before + 1
    Steganography(quiet=True, device="cpu").decode_mp3_to_wav(
        str(mp3), str(tmp_path / "h.wav"))
    assert (tmp_path / "c.wav").read_bytes() == \
        (tmp_path / "h.wav").read_bytes()


def _huffman_streams():
    """name -> MP3 bytes: the fixture, the MPEG-1 multirate goldens, the
    MPEG-1 crafted streams, the linbits-escape stream and a seeded
    bit-flipped fixture."""
    import os
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    fixture = np.load(os.path.join(gold, "encode_golden.npz"))[
        "mp3_bytes"].tobytes()
    mr = np.load(os.path.join(gold, "multirate_golden.npz"))
    crafted = np.load(os.path.join(gold, "crafted_golden.npz"))
    out = {"fixture": fixture}
    out.update({t: mr[f"mp3_{t}"].tobytes() for t in (
        "32000_64", "32000_192", "44100_128", "48000_96", "48000_320")})
    out.update({n: crafted[n].tobytes() for n in (
        "is_long", "is_ms_long", "is_ms_short", "mixed_44k")})
    out["linbits"] = np.load(os.path.join(gold, "huffman_golden.npz"))[
        "linbits"].tobytes()
    b = bytearray(fixture)
    rng = np.random.default_rng(5)
    for i in rng.integers(400, len(b), 24):
        b[int(i)] ^= 1 << int(rng.integers(0, 8))
    out["flipped"] = bytes(b)
    return out


@pytest.mark.parametrize("name", list(_huffman_streams()))
def test_huffman_kernel_equals_plain_version(card, name):
    """The hand-written bit-scan kernel, bit for bit its plain version (one
    launch), and both the host parse's samples."""
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import huffman_device as hd
    data = _huffman_streams()[name]
    _, desc = dh.parse_mp3_light(data, 0)
    words, fields = (torch.from_numpy(a).to(card) for a in hd.pack(desc))
    before = hd.launches
    got = hd.decode_samples(words, fields)
    want = hd.decode_samples_plain(words, fields)
    torch.cuda.synchronize()
    assert hd.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)
    host = dh.parse_mp3(data, 0, backend="python").raw_samples
    assert np.array_equal(got.cpu().numpy(), np.moveaxis(host, 2, 0)
                          .reshape(2, -1, 576))


def test_huffman_kernel_on_synthetic_lanes_and_its_chain(card):
    """The bit-scan kernel bit for bit its plain version on the seeded
    synthetic lane set (every table id in each region, escapes, both count1
    tables, lanes that run out of words), its chain-only entry equal to the
    plain plane's lane sums, and its tables on the card a few KB, not the
    flat LUTs."""
    from chip_smoke import hold_scan, synthetic_lanes
    from mp3stego_tpu_torch.ops import huffman_device as hd
    words, fields = (torch.from_numpy(a).to(card) for a in synthetic_lanes())
    hold_scan("synthetic lanes", words, fields)
    assert hd._tables(card).numel() * 4 < 16 * 1024


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_device_huffman_decode_writes_host_bytes(card, precision, tmp_path):
    """The default ``Decoder`` on the card: one scan launch, and the WAV
    bytes and stego bits of the host fill's route
    (``parse_mp3(defer_samples=False)``, then ``decode_pcm_i16``)."""
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.models.decoder import Decoder
    from mp3stego_tpu_torch.ops import decode_plane as dp
    from mp3stego_tpu_torch.ops import huffman_device as hd
    from mp3stego_tpu_torch.utils.wav import write_wav
    data = _huffman_streams()["fixture"]
    mp3 = tmp_path / "f.mp3"
    mp3.write_bytes(data)
    host = _host_fill_parse(data)
    write_wav(str(tmp_path / "h.wav"), host.header.sampling_rate,
              dp.decode_pcm_i16(host, card, precision))
    before = hd.launches
    dev = Decoder(str(mp3), str(tmp_path / "d.wav"), precision=precision)
    dev.decode()
    assert hd.launches == before + 1
    assert (tmp_path / "d.wav").read_bytes() == \
        (tmp_path / "h.wav").read_bytes()
    assert dev.output_bits == dh.stego_bits(host)


@pytest.mark.parametrize("hide", [False, True])
def test_card_streaming_encode_equals_whole_file(card, hide, tmp_path):
    """The streaming encode's default planes on the card, at 7-frame
    windows, write the whole-file card encode's bytes."""
    import os
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.models.streaming import encode_file_streaming
    from mp3stego_tpu_torch.utils.wav import read_wav
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    wav = tmp_path / "g.wav"
    wav.write_bytes(np.load(os.path.join(gold, "stego_golden.npz"))[
        "wav_bytes"].tobytes())
    msg = "0110100111" * 30 if hide else ""
    enc = MP3Encoder(read_wav(str(wav), 320), hide_str=msg)
    enc.encode()
    info = encode_file_streaming(str(wav), str(tmp_path / "s.mp3"), 320, 7,
                                 hide_str=msg)
    assert (tmp_path / "s.mp3").read_bytes() == bytes(enc.out_buffer)
    assert info["too_long"] is (enc.hide_str_offset < len(msg) - 1)


def _square_noise_pcm(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    sq = np.where((t // 50) % 2 == 0, 32767, -32768)
    pcm = np.stack([sq, np.roll(sq, 17)]).astype(np.int16)
    pcm[:, ::3] = rng.integers(-32768, 32768, size=pcm[:, ::3].shape)
    return pcm


def test_card_analysis_equals_cpu(card):
    """Full-scale input (the Q31 sums wrap), chunked as on a song."""
    from mp3stego_tpu_torch.ops import encode_plane as EP
    pcm = _square_noise_pcm(300 * 576, 8)
    got = EP.run_analysis_device(pcm, 300, card, chunk_g=128)
    want = EP.run_analysis_device(pcm, 300, "cpu")
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def _analysis_pcm(kind, ch, n, seed):
    """(ch, n) int16: seeded noise, a full-scale square wave (the Q31 sums
    wrap) or a two-tone "music" signal with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    if kind == "noise":
        return rng.integers(-32768, 32768, size=(ch, n)).astype(np.int16)
    if kind == "square":
        sq = np.where((t // 50) % 2 == 0, 32767, -32768)
        return np.stack([np.roll(sq, 17 * c) for c in range(ch)]) \
            .astype(np.int16)
    sig = (0.6 * np.sin(2 * np.pi * 440 * t / 44100)
           + 0.3 * np.sin(2 * np.pi * 3111 * t / 44100)
           + 0.05 * rng.standard_normal(n))
    return np.clip(np.stack([sig, sig[::-1]][:ch]) * 30000, -32768,
                   32767).astype(np.int16)


@pytest.mark.parametrize("kind", ["noise", "square", "music"])
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("tg", [1, 2, 7, 9, 300, 18432])
def test_analysis_kernel_equals_plain_version(card, tg, ch, skip, kind):
    """K3 (``csrc/analysis.cu``) bit for bit its plain version on the card,
    one launch a call (none for an empty result); the stream carries 480
    samples of nonzero history in front."""
    from mp3stego_tpu_torch.ops import encode_plane as EP
    full = torch.from_numpy(_analysis_pcm(kind, ch, 480 + tg * 576,
                                          tg + ch)).to(card)
    before = EP.launches
    got = EP.analysis_stream(full, skip=skip)
    want = EP.analysis_stream_torch(full, skip=skip)
    torch.cuda.synchronize()
    assert EP.launches == before + (1 if tg > skip else 0)
    assert got.shape == want.shape == (ch, tg - skip, 576)
    assert got.dtype == torch.int32 and torch.equal(got, want)


# (channels, granules of the stream, skip, slice): the song, a 512-frame
# and a 7-frame streaming window as models/streaming slices them (one
# granule of MDCT context, skip=1), one granule, and streams whose runs end
# mid-tile
K3_SHAPES = [(2, 18432, 0, None), (2, 1040, 1, (9, 1033)),
             (2, 30, 1, (11, 25)), (1, 1, 0, None), (2, 1, 0, None),
             (2, 8 * 397 + 3, 0, None), (1, 8 * 131 + 5, 1, None),
             (2, 8 * 396 * 12 + 7, 0, None)]


@pytest.mark.parametrize("ch,tg,skip,cut", K3_SHAPES)
def test_analysis_kernel_at_its_launch_shapes(card, ch, tg, skip, cut):
    """K3 bit for bit its plain version at the shapes its launches take
    and on tile edges, whatever tiling the wrapper picks there."""
    from mp3stego_tpu_torch.ops import encode_plane as EP
    full = _analysis_pcm("music", ch, 480 + tg * 576, tg)
    full[:, :480] = 0
    if cut is not None:
        lo, hi = cut
        full = np.ascontiguousarray(full[:, (lo - 1) * 576:hi * 576 + 480])
    full = torch.from_numpy(full).to(card)
    n = (full.shape[1] - 480) // 576
    before = EP.launches
    got = EP.analysis_stream(full, skip=skip)
    want = EP.analysis_stream_torch(full, skip=skip)
    torch.cuda.synchronize()
    assert EP.launches == before + 1
    assert got.shape == want.shape == (ch, n - skip, 576)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ch,tg,n,skip", [
    (2, 18432, 2 * 18432 * 576 - 1001, 0), (2, 300, 2 * 300 * 576 + 7, 0),
    (1, 300, 300 * 576 - 333, 0), (2, 9, 2 * 4 * 576 + 3, 1),
    (1, 1, 100, 0)])
def test_analysis_kernel_reads_the_interleaved_buffer(card, ch, tg, n, skip):
    """K3's interleaved entry on the WAV's buffer (stereo and mono, ending
    anywhere): bit for bit its plain version on the CPU and the stream route
    on the card, one launch."""
    from mp3stego_tpu_torch.ops import encode_plane as EP
    buf = np.random.default_rng(n).integers(-32768, 32768, size=n) \
        .astype(np.int16)
    cpu = torch.from_numpy(buf)
    before = EP.launches
    got = EP.analysis_interleaved(cpu.to(card), ch, tg, skip)
    torch.cuda.synchronize()
    assert EP.launches == before + 1
    full = torch.zeros((ch, 480 + tg * 576), dtype=torch.int16)
    for c in range(ch):
        s = cpu[c::ch][:tg * 576]
        full[c, 480:480 + s.shape[0]] = s
    assert torch.equal(got, EP.analysis_stream(full.to(card), skip=skip))
    if tg <= 300:
        assert torch.equal(got.cpu(), EP.analysis_interleaved_torch(
            cpu, ch, tg, skip))


@pytest.mark.parametrize("path", ["clear", "hide", "vbr", "batched"])
def test_card_encodes_build_no_channel_streams(card, path, tmp_path,
                                               monkeypatch):
    """The whole-file encodes on the card read the WAV's interleaved buffer:
    neither ``MP3Encoder._channel_streams_i16`` nor
    ``encode_plane._padded_streams`` runs, and the bytes are the CPU
    encode's."""
    import os
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.ops import encode_plane as EP
    from mp3stego_tpu_torch.parallel import encode_files_batched
    from mp3stego_tpu_torch.utils.wav import read_wav
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    wav = tmp_path / "g.wav"
    wav.write_bytes(np.load(os.path.join(gold, "stego_golden.npz"))[
        "wav_bytes"].tobytes())
    kbps, msg = (128, "") if path == "vbr" else (320, "")
    if path == "hide":
        msg = "0110100111" * 30

    def encode(device):
        if path == "batched":
            out = tmp_path / f"{device}.mp3"
            encode_files_batched([(str(wav), str(out))], device=device)
            return out.read_bytes()
        enc = MP3Encoder(read_wav(str(wav), kbps), hide_str=msg,
                         vbr=path == "vbr", device=device)
        enc.encode()
        return bytes(enc.out_buffer)

    want = encode("cpu")
    calls = []
    for owner, name in ((MP3Encoder, "_channel_streams_i16"),
                        (EP, "_padded_streams")):
        fn = getattr(owner, name)
        monkeypatch.setattr(owner, name, lambda *a, fn=fn, name=name: (
            calls.append(name), fn(*a))[1])
    before = EP.launches
    got = encode(card)
    assert not calls
    assert EP.launches > before
    assert got == want


def test_analysis_kernel_refuses_what_it_cannot_launch(card):
    from mp3stego_tpu_torch.ops import encode_plane as EP
    full = torch.from_numpy(_analysis_pcm("noise", 2, 480 + 4 * 576, 1)) \
        .to(card)
    with pytest.raises(ValueError, match="int16"):
        EP.analysis_stream(full.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        EP.analysis_stream(full.T.contiguous().T)
    with pytest.raises(ValueError, match="480"):
        EP.analysis_stream(full[:, :-1].contiguous())
    with pytest.raises(ValueError, match="skip"):
        EP.analysis_stream(full, skip=-1)
    buf = full.reshape(-1)
    with pytest.raises(ValueError, match="1 or 2 channels"):
        EP.analysis_interleaved(buf, 3, 4)
    with pytest.raises(ValueError, match="int16"):
        EP.analysis_interleaved(buf.to(torch.int32), 2, 4)
    with pytest.raises(ValueError, match="contiguous"):
        EP.analysis_interleaved(buf[::2], 2, 4)


@pytest.mark.parametrize("mode", ["clear", "hide"])
def test_card_search_rows_equal_cpu(card, mode):
    """The golden fixture's spectra plus loud seeded lanes (float64-fallback
    cells, escapes): every row and the ix plane, bit for bit."""
    import os
    from mp3stego_tpu_torch.ops import search_plane as SP
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    mdct = np.load(os.path.join(gold, "encode_golden.npz"))["mdct_freq"]
    rng = np.random.default_rng(12)
    loud = rng.integers(-2 ** 30, 2 ** 30, size=(48, 576)) \
        >> rng.integers(0, 24, size=(48, 1))
    xr = np.concatenate([mdct.transpose(1, 0, 2, 3).reshape(-1, 576),
                         loud]).astype(np.int32)
    mb = rng.integers(300, 4095, size=len(xr)).astype(np.int32)
    hide = {}
    if mode == "hide":
        hide = dict(hide_bits=rng.integers(0, 2, 300).astype(np.uint8),
                    hide_cur=np.cumsum(rng.integers(0, 3, len(xr))))
    got = SP.search_all(torch.from_numpy(xr).to(card), mb, 0, **hide)
    want = SP.search_all(torch.from_numpy(xr), mb, 0, **hide)
    for k in SP.ROWS + ("ix",):
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("key", ["hidden_short", "hidden_long",
                                 "hidden_toolong"])
def test_card_golden_hide_bytes(card, key, tmp_path):
    import os
    from mp3stego_tpu_torch import Encoder
    from mp3stego_tpu_torch.steganography import _frame_message
    gold = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "golden", "stego_golden.npz"))
    wav = tmp_path / "g.wav"
    wav.write_bytes(gold["wav_bytes"].tobytes())
    msg = {"hidden_short": "ddd", "hidden_toolong": "ddd" * 100,
           "hidden_long": gold["msg_long"].tobytes().decode()}[key]
    outs = {}
    for dev in (card, "cpu"):
        out = str(tmp_path / f"{torch.device(dev).type}.mp3")
        too_long = Encoder(str(wav), out, 320, hide_str=_frame_message(msg),
                           device=dev).encode()
        assert too_long is (key == "hidden_toolong")
        with open(out, "rb") as f:
            outs[torch.device(dev).type] = f.read()
    assert outs["cuda"] == outs["cpu"] == gold[key].tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_on_file_rows_equals_plain_version(card, dtype):
    """K1 as the batched decode launches it: one row per (file, channel)
    of a chunk (23 stereo 30 s song slices), int16 interleaved per file."""
    from mp3stego_tpu_torch.ops import synth as sf
    blk = _blk(2 * 23, 2298, 23, dtype, card)
    before = sf.launches
    got = sf.synth_fused(blk, "int16", 2)
    want = sf.synth_fused_torch(blk, "int16", 2)
    torch.cuda.synchronize()
    assert sf.launches == before + 1
    assert got.shape == (23, 2298 * 576, 2)
    assert torch.equal(got, want)


def test_batched_decode_one_launch_per_chunk(card, tmp_path):
    """Seven goldens in chunks of two (per samplerate): one K1 launch per
    chunk, and each file's PCM bit for bit its own decode on the card."""
    import os
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    from mp3stego_tpu_torch.ops import synth as sf
    from mp3stego_tpu_torch.parallel import batch_decode as BD
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    blobs = [np.load(os.path.join(gold, "encode_golden.npz"))["mp3_bytes"]]
    mr = np.load(os.path.join(gold, "multirate_golden.npz"))
    blobs += [mr[f"mp3_{t}"] for t in ("32000_64", "44100_128", "48000_96",
                                       "32000_192")]
    blobs += [blobs[0], blobs[2]]
    paths = []
    for i, b in enumerate(blobs):
        paths.append(str(tmp_path / f"{i}.mp3"))
        with open(paths[-1], "wb") as f:
            f.write(b.tobytes())
    metas = [dh.parse_mp3(b.tobytes(), 0) for b in blobs]
    chunks = BD._chunks(metas, 2)
    before = sf.launches
    outs = BD.decode_files_batched(paths, device=card, chunk_files=2)
    assert sf.launches - before == len(chunks) == 4
    for p, got in zip(metas, outs):
        assert np.array_equal(got, dp.decode_pcm(p, "float32", card))
    outs = BD.decode_files_batched(paths, dtype="float64", out="int16",
                                   device=card, chunk_files=2)
    for p, got in zip(metas, outs):
        assert np.array_equal(got, dp.decode_pcm_i16_host(p))


@pytest.mark.parametrize("out", ["float", "int16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,t", [(2, 1), (2, 9), (4, 41), (2, 2298)])
def test_kernel_with_a_halo_equals_plain_version(card, dtype, out, rows, t):
    """K1 after a seeded two-granule halo: bit for bit its plain version,
    and the plain decode of the longer rows less their first two granules;
    a misaligned halo is refused."""
    from mp3stego_tpu_torch.ops import synth as sf
    full = _blk(rows, t + 2, rows * 11 + t, dtype, card)
    blk, halo = full[:, 2:].contiguous(), full[:, :2].contiguous()
    before = sf.launches
    got = sf.synth_fused(blk, out, 2, halo=halo)
    want = sf.synth_fused_torch(blk, out, 2, halo=halo)
    longer = sf.synth_fused_torch(full, out, 2)
    torch.cuda.synchronize()
    assert sf.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, longer[:, 2:] if out == "float"
                       else longer[:, 2 * 576:])
    flat = torch.zeros(halo.numel() + 1, dtype=dtype, device=card)
    with pytest.raises(ValueError, match="aligned halo"):
        sf.synth_fused(blk, out, 2, halo=flat[1:].view(halo.shape))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_decode_on_one_card(card, dtype):
    """The synthetic batch sharded over 2, 8 and 64 entries of cuda:0 (one
    granule a shard at 64): bit for bit the unsharded card decode, one K2
    and one K1 launch a shard."""
    from chip_smoke import synthetic_prep
    from mp3stego_tpu_torch.ops import decode_plane as dp
    from mp3stego_tpu_torch.ops import synth as sf
    from mp3stego_tpu_torch.parallel import decode_granules_sharded, make_mesh
    prep = synthetic_prep(64)
    whole = dp.decode_granules(dp.prep_to_torch(prep, card),
                               dp.DTYPES[dtype]).cpu().numpy()
    for frames in (2, 8, 64):
        mesh = make_mesh(files=1, frames=frames, devices=["cuda:0"] * frames)
        k2, k1 = dp.launches, sf.launches
        got = decode_granules_sharded(prep, mesh, dtype)
        assert dp.launches - k2 == sf.launches - k1 == frames
        assert np.array_equal(got, whole), frames


def test_batched_decode_and_encode_on_a_card_mesh(card, tmp_path):
    """Five goldens, one a chunk, round-robin over 4 entries of cuda:0:
    bit for bit the batch without a mesh; two encodes likewise, the
    goldens' bytes, each file's frames serialized by the kernel from its
    resident ``ix``."""
    import os
    from mp3stego_tpu_torch.ops import serialize as SZ
    from mp3stego_tpu_torch.parallel import (decode_files_batched,
                                             encode_files_batched, make_mesh)
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    eg = np.load(os.path.join(gold, "encode_golden.npz"))["mp3_bytes"]
    mr = np.load(os.path.join(gold, "multirate_golden.npz"))
    blobs = [eg] + [mr[f"mp3_{t}"] for t in ("32000_64", "48000_96")] \
        + [eg, eg]
    paths = []
    for i, b in enumerate(blobs):
        paths.append(str(tmp_path / f"{i}.mp3"))
        with open(paths[-1], "wb") as f:
            f.write(b.tobytes())
    mesh = make_mesh(files=4, devices=["cuda:0"] * 4)
    for dtype, out in (("float32", "float"), ("float64", "int16")):
        got = decode_files_batched(paths, mesh, dtype, out=out,
                                   chunk_files=1)
        want = decode_files_batched(paths, None, dtype, out=out,
                                    device=card, chunk_files=1)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    wav = str(tmp_path / "g.wav")
    with open(wav, "wb") as f:
        f.write(np.load(os.path.join(gold, "stego_golden.npz"))[
            "wav_bytes"].tobytes())
    jobs = [(wav, str(tmp_path / f"e{i}.mp3")) for i in range(2)]
    before = SZ.launches
    encode_files_batched(jobs, 320, mesh)
    assert SZ.launches == before + 2
    for _, out in jobs:
        with open(out, "rb") as f:
            assert f.read() == eg.tobytes()


def _search_lanes(name: str):
    """(spectra (N, 576) int32, budgets (N,) int32): the lanes of
    ``chip_smoke.search_lanes`` (the golden fixture's spectra, the seeded
    loud, escape and forced-flag lanes of tests/test_torch_search_plane.py)
    and lanes holding INT32_MIN."""
    if name != "int32_min":
        from chip_smoke import search_lanes
        return search_lanes(name)
    rng = np.random.default_rng(3)
    xr = (rng.integers(-2 ** 31, 2 ** 31, size=(24, 576))
          >> rng.integers(0, 30, size=(24, 1))).astype(np.int32)
    xr[::3, ::7] = -2 ** 31
    xr[1, :] = 0
    xr[1, 5] = -2 ** 31
    return xr, rng.integers(200, 4000, size=24).astype(np.int32)


SEARCH_MODES = ["clear", "hide", "hide_no_bits", "windows", "cost"]


@pytest.mark.parametrize("mode", SEARCH_MODES)
@pytest.mark.parametrize("name", ["fixture", "loud", "escape", "forced",
                                  "int32_min"])
def test_search_kernel_equals_plain_version(card, name, mode):
    """K4 (``csrc/search.cu``) against its plain version, both on the card,
    in one launch: every row, evaluation count and the ix plane bit for
    bit; ``cost_step`` at every step."""
    from mp3stego_tpu_torch.ops import search_plane as SP
    xr, mb = _search_lanes(name)
    xr_d, mb_d = torch.from_numpy(xr).to(card), torch.from_numpy(mb).to(card)
    if mode == "cost":
        for s in range(-127, 1):
            before = SP.launches
            got = SP.cost_step(xr_d, s, 0)
            assert SP.launches == before + 1
            assert torch.equal(got, SP.cost_step_torch(xr_d, s, 0)), s
        return
    hide = None
    if mode == "hide":           # ascending cursors, the last past the end
        rng = np.random.default_rng(3)
        hide = (rng.integers(0, 2, size=3 * len(xr) // 2).astype(np.uint8),
                np.cumsum(rng.integers(0, 4, size=len(xr))))
    elif mode == "hide_no_bits":
        hide = (np.zeros(0, np.uint8), np.zeros(len(xr), np.int64))
    before = SP.launches
    if mode == "windows":
        got = SP.search_windows(xr_d, mb_d, 0)
        want = SP.search_windows_torch(xr_d, mb_d, 0)
    else:
        got = SP.search(xr_d, mb_d, 0, hide)
        want = SP.search_torch(xr_d, mb_d, 0, hide)
    torch.cuda.synchronize()
    assert SP.launches == before + 1
    for k in SP.ROWS + SP.COUNTS + ("ix",):
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    if name == "forced" and mode == "clear":
        flags = got["flags"].cpu().numpy()
        for bit in (SP.FLAG_ADDR, SP.FLAG_OOB, SP.FLAG_ITER):
            assert (flags & bit).any(), bit


@pytest.mark.parametrize("sr_idx", [5, 8, 17])
def test_search_kernel_equals_plain_version_at_other_band_rows(card, sr_idx):
    """K4 against its plain version under band rows other than row 0's:
    row 5 has an odd boundary (45), so a pair's two samples can lie in two
    regions, and rows 8 and 17 end in bands of 2 samples. Clear, hide and
    the 8 windows bit for bit; ``cost_step`` at a few steps."""
    from mp3stego_tpu_torch.ops import search_plane as SP
    rng = np.random.default_rng(sr_idx)
    for name in ("fixture", "loud", "escape"):
        xr, mb = _search_lanes(name)
        xr_d = torch.from_numpy(xr).to(card)
        mb_d = torch.from_numpy(mb).to(card)
        hide = (rng.integers(0, 2, size=len(xr)).astype(np.uint8),
                np.cumsum(rng.integers(0, 3, size=len(xr))))
        for got, want in (
                (SP.search(xr_d, mb_d, sr_idx),
                 SP.search_torch(xr_d, mb_d, sr_idx)),
                (SP.search(xr_d, mb_d, sr_idx, hide),
                 SP.search_torch(xr_d, mb_d, sr_idx, hide)),
                (SP.search_windows(xr_d, mb_d, sr_idx),
                 SP.search_windows_torch(xr_d, mb_d, sr_idx))):
            for k in SP.ROWS + SP.COUNTS + ("ix",):
                assert torch.equal(got[k], want[k]), (name, k)
        for s in (-100, -60, -30, 0):
            assert torch.equal(SP.cost_step(xr_d, s, sr_idx),
                               SP.cost_step_torch(xr_d, s, sr_idx)), (name, s)


def test_search_kernel_refuses_what_it_cannot_launch(card):
    from mp3stego_tpu_torch.ops import search_plane as SP
    xr, mb = _search_lanes("loud")
    xr_d, mb_d = torch.from_numpy(xr).to(card), torch.from_numpy(mb).to(card)
    with pytest.raises(ValueError, match="int32"):
        SP.search(xr_d.to(torch.int64), mb_d, 0)
    with pytest.raises(ValueError, match="int32"):
        SP.cost_step(xr_d.to(torch.int64), -30, 0)
    with pytest.raises(ValueError, match="contiguous"):
        SP.search(xr_d.T.contiguous().T, mb_d, 0)
    with pytest.raises(ValueError, match="contiguous"):
        SP.search_windows(xr_d, torch.stack([mb_d, mb_d], 1)[:, 0], 0)
    with pytest.raises(ValueError, match="576"):
        SP.search(xr_d[:, :288].contiguous(), mb_d, 0)
    with pytest.raises(ValueError, match="budgets"):
        SP.search(xr_d, mb_d[:5], 0)


def test_card_lane_cost_equals_native(card):
    """``search_plane.cost_step`` on the card against the native
    ``rate_cost_step`` at all 128 steps, on the encode golden's spectra
    and loud seeded lanes."""
    import os
    from mp3stego_tpu_torch.models import encoder as E
    from mp3stego_tpu_torch.ops import search_plane as SP
    lib = E._native_rate_lib()
    assert lib is not None
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    mdct = np.load(os.path.join(gold, "encode_golden.npz"))["mdct_freq"]
    rng = np.random.default_rng(13)
    loud = rng.integers(-2 ** 31, 2 ** 31, size=(48, 576)) \
        >> rng.integers(0, 28, size=(48, 1))
    xr = np.ascontiguousarray(np.concatenate(
        [mdct.transpose(1, 0, 2, 3).reshape(-1, 576), loud]).astype(np.int32))
    xr_d = torch.from_numpy(xr).to(card)
    for s in range(128):
        want = np.empty(len(xr), np.int64)
        lib.rate_cost_step(xr, len(xr), s - 127, 0, 1 << 20, want)
        got = SP.cost_step(xr_d, s - 127, 0).cpu().numpy()
        assert np.array_equal(got, want), s


def _granule_prep(name: str, card, tmp_path) -> dict:
    """A prep on the card for K2: ``synthetic`` (every block type, one mixed
    granule, MS, intensity, linbits escapes), crafted streams (intensity with
    MS on short blocks; the 8 kHz MPEG-2.5 mixed stream, whose unreordered
    middle columns only 8 kHz has), an LSF stream, a mono stream encoded on
    the card, the linbits stream (escapes in most granules), a concat batch
    of it whose escapes come reversed with a pad entry past the axis, and
    the fixture's device-Huffman ``raw_dense`` plane."""
    import os
    from chip_smoke import synthetic_prep
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    if name == "synthetic":
        return dp.prep_to_torch(synthetic_prep(64), card)
    if name in ("linbits", "padded batch"):
        from mp3stego_tpu_torch.parallel.batch_decode import \
            prepare_batch_concat
        lin = dp.host_prepare(dh.parse_mp3(np.load(os.path.join(
            gold, "huffman_golden.npz"))["linbits"].tobytes(), 0))
        if name == "linbits":
            return dp.prep_to_torch(lin, card)
        batch = prepare_batch_concat([lin, lin, lin])
        tt = batch["raw_i8"].shape[1]
        for k, extra in (("exc_t", tt), ("exc_ch", 1), ("exc_s", 7),
                         ("exc_val", 999)):
            batch[k] = np.concatenate([np.asarray([extra], batch[k].dtype),
                                       batch[k][::-1]])
        return dp.prep_to_torch(batch, card)
    if name in ("is_ms_short", "mixed_8k_lsf"):
        data = np.load(os.path.join(gold, "crafted_golden.npz"))[name]
    elif name == "mpeg2_22k05_80":
        data = np.load(os.path.join(gold, "torch_lsf_golden.npz"))[name]
    elif name == "mono":
        from mp3stego_tpu_torch.models.encoder import MP3Encoder
        from mp3stego_tpu_torch.utils.wav import read_wav, write_wav
        t = np.arange(44100) / 44100
        wav = str(tmp_path / "mono.wav")
        write_wav(wav, 44100, (np.sin(2 * np.pi * 330 * t) * 20000)
                  .astype(np.int16))
        enc = MP3Encoder(read_wav(wav, 128), device=card)
        enc.encode()
        data = np.frombuffer(bytes(enc.out_buffer), np.uint8)
    else:
        from mp3stego_tpu_torch.ops import huffman_device as hd
        data = np.load(os.path.join(gold, "encode_golden.npz"))["mp3_bytes"]
        parsed, desc = dh.parse_mp3_light(data.tobytes(), 0)
        words, fields = (torch.from_numpy(a).to(card) for a in hd.pack(desc))
        prep = dp.prep_to_torch(dp.host_prepare(parsed, raw=False), card)
        prep["raw_dense"] = hd.decode_samples(words, fields)
        return prep
    parsed = dh.parse_mp3(data.tobytes(), 0)
    assert name != "mono" or parsed.header.channels == 1
    return dp.prep_to_torch(dp.host_prepare(parsed), card)


GRANULE_PREPS = ["synthetic", "is_ms_short", "mixed_8k_lsf", "mpeg2_22k05_80",
                 "mono", "linbits", "padded batch", "raw_dense"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", GRANULE_PREPS)
def test_granule_kernel_equals_plain_version(card, name, dtype, tmp_path):
    """K2 (``csrc/granule.cu``) bit for bit its plain version on the card,
    signs of zero included, in one launch."""
    from mp3stego_tpu_torch.ops import decode_plane as dp
    prep = _granule_prep(name, card, tmp_path)
    before = dp.launches
    got = dp.granule_blocks(prep, dtype)
    want = dp.granule_blocks_torch(prep, dtype)
    torch.cuda.synchronize()
    assert dp.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(got.signbit(), want.signbit())


def _granule_span(prep: dict, lo: int, hi: int) -> dict:
    """A host_prepare dict cut to granule indices [lo, hi), its escapes
    with it."""
    from mp3stego_tpu_torch.ops import decode_plane as dp
    out = dict(prep)
    for k in dp.T_AXIS1_KEYS:
        out[k] = np.ascontiguousarray(prep[k][:, lo:hi])
    for k in dp.T_AXIS0_KEYS:
        out[k] = np.ascontiguousarray(prep[k][lo:hi])
    keep = (prep["exc_t"] >= lo) & (prep["exc_t"] < hi)
    for k in dp.EXC_KEYS:
        out[k] = prep[k][keep]
    out["exc_t"] = (out["exc_t"] - lo).astype(prep["exc_t"].dtype)
    return out


def _walk_prep(case: str, card, dtype, wide: bool) -> dict:
    """A prep on the card at an edge of K2's persistent walk: one granule,
    fewer granules than the grid's CTAs, a run that ends part-way (the
    last CTA's run shorter than the others), a concat batch of three
    files."""
    import os
    from chip_smoke import synthetic_prep
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    from mp3stego_tpu_torch.parallel.batch_decode import prepare_batch_concat
    if case == "one granule":
        prep = _granule_span(synthetic_prep(64), 5, 6)
    elif case == "fewer granules than CTAs":
        prep = _granule_span(synthetic_prep(64), 3, 40)
    elif case == "a run that ends part-way":
        cap = dp._grid_cap(card, dtype, wide)
        # runs of 3 (2 cap < t <= 3 cap), t even and not a multiple of 3
        t = 2 * cap + 2 if (2 * cap + 2) % 3 else 2 * cap + 4
        prep = synthetic_prep(t)
        run = -(-t // min(t, cap))
        assert t % run, (t, run)
    else:
        gold = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "golden")
        blobs = [np.load(os.path.join(gold, "encode_golden.npz"))[
            "mp3_bytes"], np.load(os.path.join(gold, "huffman_golden.npz"))[
            "linbits"]]
        prep = prepare_batch_concat([dp.host_prepare(dh.parse_mp3(
            b.tobytes(), 0)) for b in blobs + blobs[:1]])
    prep = dp.prep_to_torch(prep, card)
    if wide:
        from chip_smoke import dense_prep
        prep = dense_prep(prep)
    return prep


@pytest.mark.parametrize("wide", [False, True], ids=["int8", "int32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["one granule", "fewer granules than CTAs",
                                  "a run that ends part-way",
                                  "concat batch"])
def test_granule_kernel_walk_edges(card, case, dtype, wide):
    """K2's persistent CTAs each walk a contiguous run of granule indices:
    bit for bit the plain version, signs of zero included, at the walk's
    edges on both sample planes, in one launch."""
    from mp3stego_tpu_torch.ops import decode_plane as dp
    prep = _walk_prep(case, card, dtype, wide)
    before = dp.launches
    got = dp.granule_blocks(prep, dtype)
    want = dp.granule_blocks_torch(prep, dtype)
    torch.cuda.synchronize()
    assert dp.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.signbit(), want.signbit())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_granule_kernel_rounds_a_file_alike_alone_and_in_a_batch(card,
                                                                 dtype):
    """A file's blocks from the kernel are the same alone and inside a
    concat batch (``parallel.batch_decode``), bit for bit: the job the
    float32 plane's fixed-block matmuls did before the kernel."""
    import os
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    from mp3stego_tpu_torch.parallel.batch_decode import prepare_batch_concat
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    blobs = [np.load(os.path.join(gold, "encode_golden.npz"))["mp3_bytes"],
             np.load(os.path.join(gold, "multirate_golden.npz"))[
                 "mp3_44100_128"]]
    preps = [dp.host_prepare(dh.parse_mp3(b.tobytes(), 0))
             for b in blobs + blobs[:1]]
    batch = prepare_batch_concat(preps)
    whole = dp.granule_blocks(dp.prep_to_torch(batch, card), dtype)
    for i, p in enumerate(preps):
        t = p["raw_i8"].shape[1]
        alone = dp.granule_blocks(dp.prep_to_torch(p, card), dtype)
        lo = i * batch["t_max"]
        assert torch.equal(whole[:, lo:lo + t], alone), i


def test_granule_stages_on_the_card(card):
    """``stages`` on a CUDA prep: the plain stages beside the kernel, equal
    to the CPU plane's; the PCM is the kernel's."""
    from chip_smoke import synthetic_prep
    from mp3stego_tpu_torch.ops import decode_plane as dp
    prep = synthetic_prep(16)
    got, want = {}, {}
    before = dp.launches
    pcm = dp.decode_granules(dp.prep_to_torch(prep, card), torch.float64,
                             stages=got)
    assert dp.launches == before + 1
    ref = dp.decode_granules(dp.prep_to_torch(prep, "cpu"), torch.float64,
                             stages=want)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    assert torch.equal(pcm.cpu(), ref)


def test_granule_kernel_refuses_what_it_cannot_launch(card):
    from chip_smoke import synthetic_prep
    from mp3stego_tpu_torch.ops import decode_plane as dp
    prep = dp.prep_to_torch(synthetic_prep(8), card)
    before = dp.launches
    with pytest.raises(ValueError, match="float32 or float64"):
        dp.granule_blocks(prep, torch.float16)
    cases = {"contiguous": ("sfl", torch.zeros((2, 22, 8), dtype=torch.int8,
                                               device=card).transpose(1, 2)),
             "gg must be": ("gg", prep["gg"].int()),
             "lies on": ("mode", prep["mode"].cpu()),
             "exc_start must be": ("exc_start", prep["exc_start"][:-1])}
    for match, (key, value) in cases.items():
        with pytest.raises(ValueError, match=match):
            dp.granule_blocks(dict(prep, **{key: value}), torch.float32)
    with pytest.raises(ValueError, match="no sample plane"):
        dp.granule_blocks({k: v for k, v in prep.items() if k != "raw_i8"},
                          torch.float32)
    assert dp.launches == before


def _grid_lanes() -> np.ndarray:
    from chip_smoke import grid_lanes
    return np.ascontiguousarray(np.concatenate(
        [_search_lanes(n)[0] for n in ("fixture", "loud", "escape", "forced",
                                       "int32_min")] + [grid_lanes()]))


@pytest.mark.parametrize("with_hide", [False, True])
@pytest.mark.parametrize("sr_idx", [0, 5, 8, 13])
def test_cost_grid_kernel_equals_plain_version(card, sr_idx, with_hide):
    """K5 (``csrc/cost_grid.cu``) against its plain version, both on the
    card, in one launch: every row of every cell bit for bit on the golden
    fixture's spectra and the seeded, forced-flag, INT32_MIN and edge
    lanes; the wrapper's host dict equals the plain version's."""
    from mp3stego_tpu_torch.ops import quant_batch as QB
    xr = torch.from_numpy(_grid_lanes()).to(card)
    rows = QB.ROWS_HIDE if with_hide else QB.ROWS_CLEAR
    before = QB.launches
    got = QB._launch(xr, sr_idx, rows)
    want = QB.cost_all_steps_torch(xr, sr_idx, with_hide)
    torch.cuda.synchronize()
    assert QB.launches == before + 1
    assert got.shape == want.shape == (rows, xr.shape[0], 128)
    for r in range(rows):
        assert torch.equal(got[r], want[r]), r
    cells = QB.cost_all_steps(xr, sr_idx, with_hide)
    assert QB.launches == before + 2
    for k, v in QB._unpack(want.cpu().numpy(), with_hide).items():
        assert cells[k].dtype == v.dtype and np.array_equal(cells[k], v), k


def test_cost_grid_kernel_takes_numpy_and_empty_spectra(card):
    from mp3stego_tpu_torch.ops import quant_batch as QB
    xr = _grid_lanes()
    before = QB.launches
    got = QB.cost_all_steps(xr, 0, True)                 # to CUDA, launched
    assert QB.launches == before + 1
    want = QB.cost_all_steps(torch.from_numpy(xr), 0, True)   # the CPU
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    empty = QB.cost_all_steps(torch.from_numpy(xr[:0]).to(card), 0)
    assert QB.launches == before + 1
    assert all(v.shape == (0, 128) for v in empty.values())


def test_cost_grid_kernel_refuses_what_it_cannot_launch(card):
    from mp3stego_tpu_torch.ops import quant_batch as QB
    xr = torch.from_numpy(_grid_lanes()).to(card)
    with pytest.raises(ValueError, match="int32"):
        QB.cost_all_steps(xr.to(torch.int64), 0)
    with pytest.raises(ValueError, match="contiguous"):
        QB.cost_all_steps(xr.T.contiguous().T, 0)
    with pytest.raises(ValueError, match="576"):
        QB.cost_all_steps(xr[:, :288].contiguous(), 0)


@pytest.mark.parametrize("case", ["clear", "hidden_short", "hidden_long",
                                  "hidden_toolong", "vbr"])
def test_card_grid_engine_bytes(card, case, tmp_path, monkeypatch):
    """The cost-grid engine (``MP3STEGO_TPU_SEARCH_PLANE=0``) on the card:
    the goldens' bytes and the plane engine's, one K3 and one K5 launch a
    clear or hidden encode (VBR adds its K4 step costs)."""
    import os
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.ops import encode_plane as EP
    from mp3stego_tpu_torch.ops import quant_batch as QB
    from mp3stego_tpu_torch.steganography import _frame_message
    from mp3stego_tpu_torch.utils.wav import read_wav
    gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    sg = np.load(os.path.join(gdir, "stego_golden.npz"))
    wav = tmp_path / "g.wav"
    wav.write_bytes(sg["wav_bytes"].tobytes())
    msg = {"hidden_short": "ddd", "hidden_toolong": "ddd" * 100,
           "hidden_long": sg["msg_long"].tobytes().decode()}.get(case)
    bits = "" if msg is None else _frame_message(msg)
    kbps = 160 if case == "vbr" else 320

    def encode():
        enc = MP3Encoder(read_wav(str(wav), kbps), hide_str=bits,
                         vbr=case == "vbr", device=card)
        enc.encode()
        return enc

    monkeypatch.setenv("MP3STEGO_TPU_SEARCH_PLANE", "0")
    k3, k5 = EP.launches, QB.launches
    grid = encode()
    assert QB.launches == k5 + 1
    if case != "vbr":
        assert EP.launches == k3 + 1
    monkeypatch.delenv("MP3STEGO_TPU_SEARCH_PLANE")
    plane = encode()
    assert bytes(grid.out_buffer) == bytes(plane.out_buffer)
    assert grid.hide_str_offset == plane.hide_str_offset
    if case == "clear":
        want = np.load(os.path.join(gdir, "encode_golden.npz"))["mp3_bytes"]
        assert bytes(grid.out_buffer) == want.tobytes()
    elif msg is not None:
        assert bytes(grid.out_buffer) == sg[case].tobytes()


# ------------------------------------------------- utils/transfer on the card

def _slow_producer(card, shape, value, stream=None):
    """A tensor of ``value`` on ``card`` that a long kernel queued before it
    on ``stream`` (None: the current one) keeps unwritten for a while."""
    s = stream or torch.cuda.current_stream(card)
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)           # tens of ms
        return torch.full(shape, value, dtype=torch.int32, device=card)


def test_card_fetches_leave_held_results_and_views_intact(card):
    """Each fetch waits on the producer's stream and lands in a pinned
    buffer; a result the caller holds (or a view of it) is never the
    buffer of a later fetch."""
    from mp3stego_tpu_torch.utils import transfer as X
    first = X.fetch_pieces([_slow_producer(card, (1 << 20,), 1)])[0]
    assert (first == 1).all()
    view = first[5:]
    second = X.fetch_pieces([_slow_producer(card, (1 << 20,), 2)])[0]
    del first
    for v in range(3, 8):
        got = X.fetch_pieces([_slow_producer(card, (1 << 20,), v),
                              _slow_producer(card, (3, 5), -v)])
        assert (got[0] == v).all() and (got[1] == -v).all()
    assert (view == 1).all() and (second == 2).all()
    assert torch.from_numpy(second).is_pinned()


def test_card_upload_buffer_is_not_reused_while_its_copy_runs(card):
    """put_pieces returns before its copy has run (a long kernel holds the
    stream): the next upload takes another buffer, and the host may
    change its array at once."""
    from mp3stego_tpu_torch.utils import transfer as X
    pool = X.pool(card)
    n = 1 << 22
    a = np.full(n, 7, np.int32)
    b = np.full(n, 9, np.int32)
    before = {id(s) for s in pool._slabs if s.busy()}
    torch.cuda._sleep(100_000_000)
    ta = X.put_pieces(a, card)
    a[:] = 0                                    # the caller's to change
    tb = X.put_pieces(b, card)
    b[:] = 0
    mine = [s for s in pool._slabs if s.busy() and id(s) not in before]
    assert len(mine) == 2                       # both copies still queued
    assert (ta == 7).all().item() and (tb == 9).all().item()
    torch.cuda.synchronize(card)
    assert not any(s.busy() for s in mine)


def test_card_fetch_concat_waits_on_the_current_stream(card):
    """fetch_concat and fetch_pieces on a stream that is not the default
    one: the side stream waits on that stream's work, and every part lands
    at its offset."""
    from mp3stego_tpu_torch.utils import transfer as X
    other = torch.cuda.Stream(card)
    with torch.cuda.stream(other):
        parts = [_slow_producer(card, (2, n, 3), k)
                 for k, n in enumerate((4, 1, 6))]
        got = X.fetch_concat(parts, 1)
        single = X.fetch_pieces(parts)
    want = np.concatenate([np.full((2, n, 3), k, np.int32)
                           for k, n in enumerate((4, 1, 6))], axis=1)
    np.testing.assert_array_equal(got, want)
    for k, s in enumerate(single):
        assert (s == k).all()


def test_card_probe_without_the_golden_stream(card, tmp_path, monkeypatch):
    """measure_probe where tests/golden is missing (an installed package):
    the plane rates are the defaults, the rest is measured."""
    from mp3stego_tpu_torch.utils import calibrate as C
    monkeypatch.setattr(C, "_GOLD", str(tmp_path / "missing.npz"))
    p = C.measure_probe()
    assert p.probed
    assert (p.device_gps, p.h2d_bpg, p.host_plane_gps) == (
        C._DEFAULTS["device_gps"], C._DEFAULTS["h2d_bpg"],
        C._DEFAULTS["host_plane_gps"])
    assert p.link_out_mbps > 0 and p.device_search_gps > 0


def _host_fill_parse(data: bytes):
    """``parse_mp3(defer_samples=False)``: the samples filled on the
    host."""
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    p = dh.parse_mp3(data, 0, defer_samples=False)
    assert p.lanes is None and not p.samples_pending
    return p


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("name", ["fixture", "48000_320", "mixed_44k",
                                  "linbits", "flipped"])
def test_single_file_decode_scans_on_the_card(card, precision, name):
    """``decode_pcm_i16`` and ``decode_pcm`` of a default parse scan its
    samples on the card, one scan launch each, and write the bytes of the
    host fill's route (``defer_samples=False``); the host fill never
    runs."""
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    from mp3stego_tpu_torch.ops import huffman_device as hd
    data = _huffman_streams()[name]
    host = _host_fill_parse(data)
    want = dp.decode_pcm_i16(host, card, precision)
    want_f = dp.decode_pcm(host, precision, card)
    p = dh.parse_mp3(data, 0)
    assert p.lanes is not None and p.samples_pending
    before = hd.launches
    got = dp.decode_pcm_i16(p, card, precision)
    got_f = dp.decode_pcm(p, precision, card)
    assert hd.launches == before + 2
    assert p.samples_pending
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got_f.dtype == want_f.dtype and got_f.tobytes() == want_f.tobytes()


def test_intensity_stereo_decode_on_the_card_reads_the_host_fill(card):
    """An intensity-stereo stream: its positions need the right channel's
    samples on the host, so the deferred fill runs once beside the scan,
    and the bytes are the host fill's route's."""
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.ops import decode_plane as dp
    data = _huffman_streams()["is_long"]
    want = dp.decode_pcm_i16(_host_fill_parse(data), card, "float64")
    p = dh.parse_mp3(data, 0)
    got = dp.decode_pcm_i16(p, card, "float64")
    assert not p.samples_pending and got.tobytes() == want.tobytes()


def test_batched_decode_launches_no_scan(card, tmp_path):
    """``decode_files_batched`` fills its files' samples on the host and
    packs them for K2: no Huffman scan runs on the card."""
    import os
    from mp3stego_tpu_torch.ops import huffman_device as hd
    from mp3stego_tpu_torch.parallel import batch_decode as BD
    paths = []
    for name in ("fixture", "44100_128", "48000_96"):
        paths.append(os.path.join(str(tmp_path), f"{name}.mp3"))
        with open(paths[-1], "wb") as f:
            f.write(_huffman_streams()[name])
    before = hd.launches
    for dtype, out in (("float32", "float"), ("float64", "int16")):
        outs = BD.decode_files_batched(paths, dtype=dtype, out=out,
                                       device=card)
        assert len(outs) == 3 and all(len(o) for o in outs)
    assert hd.launches == before


def _seeded_song_wav(seconds: float, seed: int):
    """A seeded 44.1 kHz stereo song (a drifting tone, its overtone, noise
    under a slow envelope) as a 320 kbps ``WavFile``."""
    from mp3stego_tpu_torch.utils.wav import WavFile
    sr = 44100
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(220 * 2 ** (2 * np.sin(t / 6.0))) / sr
    sig = (0.35 * np.sin(phase) + 0.15 * np.sin(3.01 * phase)
           + 0.2 * np.sin(2 * np.pi * t / 11.0) ** 2
           * rng.standard_normal(t.size))
    right = 0.8 * np.roll(sig, 999) + 0.05 * rng.standard_normal(t.size)
    pcm = np.clip(np.stack([sig, right], axis=1) * 30000, -32768, 32767)
    pcm = pcm.astype(np.int16).reshape(-1)
    return WavFile(file_path="song.wav", bitrate=320, num_of_channels=2,
                   samplerate=sr, bits_per_sample=16,
                   num_of_samples=pcm.size // 2, mpeg_mode=0, buffer=pcm)


@pytest.mark.parametrize("hide", [False, True])
def test_card_serializer_writes_the_c_routes_bytes(card, hide, monkeypatch):
    """A seeded 60 s song's encode on the card, clear and hiding 6,000
    bits: the frames go through the serializer kernel once (its launch
    count), from the resident ``ix``; its bytes equal
    ``_plane_serialize_native``'s on the same arrays fetched to the host,
    and the whole encode's equal those of the C route (``ix`` fetched)."""
    from mp3stego_tpu_torch.models import encoder as E
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch import native
    from mp3stego_tpu_torch.ops import serialize as SZ
    msg = "".join(np.random.default_rng(5).choice(["0", "1"], 6000)) \
        if hide else ""
    seen = []
    orig = MP3Encoder._plane_serialize_card

    def spy(self, res, p23, gg, scfsi_f, paddings, nf):
        n0 = len(self.out_buffer)
        orig(self, res, p23, gg, scfsi_f, paddings, nf)
        seen.append((dict(res), p23.copy(), gg.copy(), scfsi_f, paddings, nf,
                     bytes(self.out_buffer[n0:])))
    monkeypatch.setattr(MP3Encoder, "_plane_serialize_card", spy)
    before = SZ.launches
    enc = MP3Encoder(_seeded_song_wav(60.0, 7), hide_str=msg, device=card)
    enc.encode()
    assert SZ.launches == before + 1 and len(seen) == 1
    res, p23, gg, scfsi_f, paddings, nf, got = seen[0]
    assert res["ix"].device.type == "cuda"
    host = dict(res, ix=res["ix"].cpu().numpy())
    kept, enc.out_buffer = enc.out_buffer, bytearray()
    enc._plane_serialize_native(native.get_lib(), host, p23, gg, scfsi_f,
                                paddings, nf)
    assert got == bytes(enc.out_buffer)
    monkeypatch.setattr(E, "_ix_home", lambda ix: ix.cpu().numpy())
    c_route = MP3Encoder(_seeded_song_wav(60.0, 7), hide_str=msg,
                         device=card)
    c_route.encode()
    assert SZ.launches == before + 1 and len(seen) == 1
    assert bytes(c_route.out_buffer) == bytes(kept)
