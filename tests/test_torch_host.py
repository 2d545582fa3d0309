"""Host plane of the torch port against the JAX package, on the same bytes.

The port copies the JAX-free host modules (tables, bitstream parse, native
loader, ``host_prepare``); these tests hold every ``ParsedMP3`` array field,
the stego bit string and the device-plane input dict equal to the JAX
package's, on the 320 kbps fixture, the MPEG-2/2.5 streams and the
multirate goldens.

The streams of ``mpeg2_golden.npz`` are the reference encoder's LSF layout,
which no decoder reads (its side info drops two fields, so frames land at
half-byte offsets); both packages refuse them alike. The decodable MPEG-2/2.5
streams are ``torch_lsf_golden.npz``: the same PCM inputs encoded by the JAX
package's spec-valid LSF writer (``lsf_compliant=True``), pinned here by
re-encoding.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mp3stego_tpu.bitstream import decoder_host as jdh  # noqa: E402
from mp3stego_tpu.ops import decode_plane as jdp  # noqa: E402
from mp3stego_tpu_torch import tables as PT  # noqa: E402
from mp3stego_tpu_torch.bitstream import decoder_host as pdh  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as pdp  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

MPEG2 = (("mpeg2_24k_64", 24000, 64), ("mpeg2_22k05_80", 22050, 80),
         ("mpeg25_8k_32", 8000, 32))
MULTIRATE = ("32000_64", "32000_192", "44100_128", "48000_96", "48000_320")
STREAMS = (("fixture",) + tuple(m[0] for m in MPEG2)
           + tuple(f"mp3_{t}" for t in MULTIRATE))


@pytest.fixture(scope="module")
def goldens():
    return {n: np.load(os.path.join(GOLD, f"{n}.npz"))
            for n in ("mpeg2_golden", "multirate_golden", "stego_golden",
                      "torch_lsf_golden")}


def _stream_bytes(name, goldens, request) -> bytes:
    if name == "fixture":
        with open(request.getfixturevalue("fixture_mp3"), "rb") as f:
            return f.read()
    if name.startswith("mp3_"):
        return goldens["multirate_golden"][name].tobytes()
    return goldens["torch_lsf_golden"][name].tobytes()


def _assert_same(a, b, where):
    """Deep equality across the two packages' (distinct) classes."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _check_parse(name, goldens, request):
    """Both packages' Python parsers, named explicitly: with ``auto`` the
    JAX side takes its native parser only where its library loaded, and
    the two engines fill ``side_infos`` differently."""
    data = _stream_bytes(name, goldens, request)
    jp = jdh.parse_mp3(data, 0, backend="python")
    pp = pdh.parse_mp3(data, 0, backend="python")
    assert jp.num_frames > 0
    _assert_same(jp, pp, name)
    assert pdh.stego_bits(pp) == jdh.stego_bits(jp)


def _check_host_prepare(name, goldens, request):
    """Python parse and the NumPy sample-plane pack on both sides (the
    native pack lists the linbits escapes in another order)."""
    data = _stream_bytes(name, goldens, request)
    jprep = jdp.host_prepare(jdh.parse_mp3(data, 0, backend="python"),
                             native_pack=False)
    pprep = pdp.host_prepare(pdh.parse_mp3(data, 0, backend="python"),
                             native_pack=False)
    assert set(pprep) == set(jprep) == set(pdp.ALL_KEYS) == set(jdp.ALL_KEYS)
    for k in pdp.ALL_KEYS:
        assert pprep[k].dtype == jprep[k].dtype, k
        assert np.array_equal(pprep[k], jprep[k]), k


@pytest.mark.parametrize("name", STREAMS)
def test_parse_matches_jax_package(name, goldens, request):
    _check_parse(name, goldens, request)


@pytest.mark.parametrize("name", STREAMS)
def test_host_prepare_matches_jax_package(name, goldens, request):
    _check_host_prepare(name, goldens, request)


@pytest.mark.parametrize("check,name", [
    (_check_parse, "mp3_44100_128"), (_check_parse, "mp3_48000_96"),
    (_check_parse, "mp3_48000_320"), (_check_host_prepare, "fixture")])
def test_cross_package_checks_hold_without_jax_native(check, name, goldens,
                                                      request, monkeypatch):
    """The cases that once followed whichever parser engine the JAX
    package's worker had loaded pass with its native library off."""
    import mp3stego_tpu.native as jnative
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    check(name, goldens, request)


@pytest.mark.parametrize("name", STREAMS)
def test_native_pack_equals_numpy_pack(name, goldens, request):
    """The port's C++ sample-plane pack against its NumPy pack: the same
    int8 plane and the same escapes, in either order."""
    p = pdh.parse_mp3(_stream_bytes(name, goldens, request), 0,
                      backend="python")
    a, b = pdp.host_prepare(p), pdp.host_prepare(p, native_pack=False)
    for k in pdp.ALL_KEYS:
        if k not in pdp.EXC_KEYS:
            assert np.array_equal(a[k], b[k]), k

    def escapes(prep):
        cols = [prep[k].astype(np.int64) for k in pdp.EXC_KEYS]
        return sorted(zip(*cols))

    assert escapes(a) == escapes(b)


@pytest.mark.parametrize("key", ("hidden_short", "hidden_long",
                                 "hidden_toolong"))
def test_stego_bits_match_jax_package(key, goldens):
    data = goldens["stego_golden"][key].tobytes()
    bits = pdh.stego_bits(pdh.parse_mp3(data, 0))
    assert bits and bits == jdh.stego_bits(jdh.parse_mp3(data, 0))


def test_python_parser_matches_native(goldens, request):
    """Both engines of the copied parser agree on every stream the
    cross-package tests read (the native one is built from the JAX
    package's C++ sources into the port's own build directory), on every
    field; on MPEG-1 streams the native engine leaves ``side_infos`` empty
    and fills only the dense per-granule arrays the planes read. With
    ``test_parse_matches_jax_package`` (Python engines on both sides) this
    holds the port's native parse, the engine every decode uses, to the
    JAX package field by field whichever engine the JAX side loaded."""
    from mp3stego_tpu_torch import native
    assert native.get_lib() is not None
    assert os.path.dirname(native._SO) == native.BUILD_DIR
    for name in STREAMS:
        data = _stream_bytes(name, goldens, request)
        a = pdh.parse_mp3(data, 0, backend="native")
        b = pdh.parse_mp3(data, 0, backend="python")
        assert a.num_frames > 0
        mpeg1 = a.header.mpeg_version == 1
        assert a.side_infos == [] if mpeg1 else a.side_infos
        for f in dataclasses.fields(a):
            if f.name != "side_infos" or a.side_infos:
                _assert_same(getattr(a, f.name), getattr(b, f.name),
                             f"{name}.{f.name}")


def test_tables_read_the_jax_package_pack():
    """The port reads its own copy of the JAX package's pack (beside its
    tables module), and every table it derives equals the JAX package's."""
    from mp3stego_tpu import tables as JT
    assert PT._PACK_PATH == os.path.join(os.path.dirname(PT.__file__),
                                         "iso_tables.npz")
    with open(PT._PACK_PATH, "rb") as a, \
            open(os.path.join(os.path.dirname(JT.__file__),
                              "iso_tables.npz"), "rb") as b:
        assert a.read() == b.read()
    for name in ("HUFF_CODE", "SYNTH_WINDOW", "BAND_INDEX_ISO", "PRE_TAB",
                 "QUAD_LUT", "TRANSFORM_HUF"):
        assert np.array_equal(getattr(PT, name), getattr(JT, name)), name
    assert np.array_equal(PT.sine_block(), JT.sine_block())
    assert np.array_equal(PT.synth_filter_matrix(), JT.synth_filter_matrix())


@pytest.mark.parametrize("name,sr,br", MPEG2)
def test_lsf_golden_is_the_jax_compliant_encoding(name, sr, br, goldens):
    from mp3stego_tpu.models.encoder import MP3Encoder
    from mp3stego_tpu.utils.wav import WavFile
    pcm = goldens["mpeg2_golden"][name + "_pcm"]
    w = WavFile(file_path="synth.wav", bitrate=br, num_of_channels=2,
                samplerate=sr, bits_per_sample=16,
                num_of_samples=len(pcm) // 2, mpeg_mode=0, buffer=pcm)
    enc = MP3Encoder(w, device_search=False, lsf_compliant=True)
    enc.encode(quiet=True)
    assert bytes(enc.out_buffer) == goldens["torch_lsf_golden"][name].tobytes()


@pytest.mark.parametrize("name", [m[0] for m in MPEG2])
def test_reference_layout_lsf_refused_alike(name, goldens):
    data = goldens["mpeg2_golden"][name].tobytes()
    with pytest.raises(ValueError, match="lsf_compliant") as jerr:
        jdh.parse_mp3(data, 0)
    with pytest.raises(ValueError, match="lsf_compliant") as perr:
        pdh.parse_mp3(data, 0)
    assert str(perr.value) == str(jerr.value)


ENCODER_TABLES = {
    "ENWINDOW": lambda T: T.ENWINDOW,
    "subband_filter_fixed": lambda T: T.subband_filter_fixed(),
    "mdct_cos_fixed": lambda T: T.mdct_cos_fixed(),
    "MDCT_CS_FIX": lambda T: T.MDCT_CS_FIX,
    "MDCT_CA_FIX": lambda T: T.MDCT_CA_FIX,
    "loop_tables": lambda T: np.concatenate(
        [np.asarray(a, np.float64).ravel() for a in T.loop_tables()]),
    "SUBDV_TABLE": lambda T: T.SUBDV_TABLE,
    "BAND_ALL": lambda T: T.BAND_ALL,
    "HUFF_LINMAX": lambda T: T.HUFF_LINMAX,
    "SLEN1_TAB": lambda T: T.SLEN1_TAB,
}


@pytest.mark.parametrize("name", list(ENCODER_TABLES))
def test_encoder_tables_equal_jax_package(name):
    """The encoder's constant state (this system has no trained weights):
    the Q31 analysis tables, the quantizer's step/LUT tables and the band
    and region tables equal the JAX package's, dtype and all."""
    from mp3stego_tpu import tables as JT
    got, want = ENCODER_TABLES[name](PT), ENCODER_TABLES[name](JT)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
