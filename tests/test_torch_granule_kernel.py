"""The decode granule plane's wrapper (``ops/decode_plane.granule_blocks``)
on the CPU, where it takes its plain version, against the JAX package; and
what the wrapper hands the CUDA kernel (``csrc/granule.cu``).

* A CPU prep takes ``granule_blocks_torch`` and launches nothing.
* float32: the plain version, whose IMDCT sums in ascending order (the
  kernel's order), within 1e-5 of the JAX package's float32 plane
  (``granule_blocks`` run op by op on the CPU, as its own tests run it;
  ``atol`` scaled by the blocks' peak) on goldens of every samplerate
  family and the crafted streams; its int16 PCM within 1 LSB of the float64
  plane on fewer than 1e-3 of the fixture's samples and 2e-3 of the tone
  streams'.
* float64: the plain version still equals the NumPy plane stage by stage on
  the crafted streams (intensity, MS, short, mixed, 8 kHz).
* A file's float32 blocks alone equal its blocks inside a concat batch.
* The tables the kernel reads are ``_consts``'s own tensors, equal to
  tables built here from their definitions; the escapes it reads, each
  granule's range of ``exc_start`` written over the int8 plane as its CTAs
  write them, rebuild ``dense_raw`` (escapes past the granule axis
  dropped) from the native and the NumPy pack, a concat batch and an
  unsorted list.
* The wrapper's refusals, before any dispatch.
* ``csrc/granule.cu`` itself, built for the host with g++ against the
  emulation of ``tests/cuda_host_shim.py`` and run through the wrapper's
  launch code (``decode_plane._launch``) on one to three emulated SMs: bit
  for bit ``granule_blocks_torch`` in both dtypes, signs of zero included,
  and in float64 the NumPy plane's blocks, PCM and stages after the IMDCT,
  on the synthetic prep (with and without the reference start window), the
  crafted streams, the linbits stream on the int8 plane and on the int32
  plane, a mono stream, one granule, runs that end part-way and a granule
  of more escapes than the CTA has threads.
* The float32 cosine tables' exact symmetry, which the kernel's float IMDCT
  uses, and the float64 tables' lack of it; K2's ``-Xptxas -v`` resources
  read from a kept build log.

Tolerance: exact unless stated. Inputs come from the goldens and seeded
numpy preps; the JAX parser runs its Python engine (``backend="python"``).
"""

import contextlib
import ctypes
import math
import os
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
import cuda_host_shim  # noqa: E402
from mp3stego_tpu.bitstream import decoder_host as jdh  # noqa: E402
from mp3stego_tpu.ops import decode_plane as jdp  # noqa: E402
from mp3stego_tpu_torch import tables as T  # noqa: E402
from mp3stego_tpu_torch.ops import _cuda  # noqa: E402
from mp3stego_tpu_torch.ops import decode_plane as dp  # noqa: E402
from mp3stego_tpu_torch.parallel.batch_decode import \
    prepare_batch_concat  # noqa: E402

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
F32, F64 = torch.float32, torch.float64


def _stream(name: str) -> bytes:
    """MP3 bytes of a golden: the fixture, a multirate or LSF golden, or a
    crafted stream."""
    if name == "fixture":
        return np.load(os.path.join(GOLD, "encode_golden.npz"))[
            "mp3_bytes"].tobytes()
    for npz, key in (("multirate_golden.npz", f"mp3_{name}"),
                     ("torch_lsf_golden.npz", name),
                     ("crafted_golden.npz", name)):
        z = np.load(os.path.join(GOLD, npz))
        if key in z.files:
            return z[key].tobytes()
    raise KeyError(name)


def _prep(name: str) -> dict:
    """The JAX package's host_prepare dict (the schema both packages
    share) of a golden, or the seeded synthetic batch."""
    if name == "synthetic":
        return graft._synthetic_prep(32)
    return jdp.host_prepare(jdh.parse_mp3(_stream(name), 0,
                                          backend="python"))


CRAFTED = ("is_long", "is_ms_long", "is_ms_short", "mixed_44k",
           "mixed_8k_lsf", "lsf_is_scale0", "lsf_is_ms_scale1")
TONES = ("32000_64", "48000_320", "mpeg2_24k_64", "mpeg25_8k_32")


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", ["synthetic", "mixed_8k_lsf"])
def test_cpu_prep_takes_the_plain_version(name, dtype):
    prep = dp.prep_to_torch(_prep(name), "cpu")
    before = dp.launches
    got = dp.granule_blocks(prep, dtype)
    assert dp.launches == before
    assert got.dtype == dtype and got.shape == (2, prep["mode"].shape[1],
                                                32, 36)
    assert torch.equal(got, dp.granule_blocks_torch(prep, dtype))


@pytest.mark.parametrize("name", TONES + CRAFTED)
def test_f32_plain_version_matches_jax(name):
    """The ascending float32 IMDCT against the JAX float32 plane, which
    sums its IMDCT as a matmul with XLA's contraction: 1e-5 of the peak."""
    prep = _prep(name)
    want = np.asarray(jdp.granule_blocks(
        {k: jnp.asarray(v) for k, v in prep.items()}, jnp.dtype("float32")))
    got = dp.granule_blocks(dp.prep_to_torch(prep, "cpu"), F32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("name,max_rate", [("fixture", 1e-3)]
                         + [(n, 2e-3) for n in TONES]
                         + [(n, 2e-3) for n in CRAFTED]
                         # the synthetic batch is noise far above full
                         # scale, not audio; the parent's blocked-matmul
                         # float32 plane flipped 2.79e-3 of its samples
                         + [("synthetic", 3e-3)])
def test_f32_int16_within_one_lsb_of_f64(name, max_rate):
    prep = dp.prep_to_torch(_prep(name), "cpu")
    got = dp.decode_granules_i16(prep, F32).numpy().astype(np.int32)
    want = dp.decode_granules_i16(prep, F64).numpy().astype(np.int32)
    d = np.abs(got - want)
    assert d.max() <= 1
    assert (d != 0).mean() < max_rate


@pytest.mark.parametrize("name", CRAFTED)
def test_f64_plain_version_equals_numpy_plane_by_stage(name):
    prep = _prep(name)
    want = {}
    ref = jdp.decode_granules_np(prep, stages=want)
    got = {}
    pcm = dp.decode_granules(dp.prep_to_torch(prep, "cpu"), F64, stages=got)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(pcm.numpy(), ref)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_file_alike_alone_and_in_a_concat_batch(dtype):
    """Each file's blocks at its place in the concat axis equal the file's
    own blocks, bit for bit: a row's sums never depend on the batch."""
    preps = [_prep(n) for n in ("fixture", "44100_128", "fixture")]
    batch = prepare_batch_concat(preps)
    whole = dp.granule_blocks(dp.prep_to_torch(batch, "cpu"), dtype)
    for i, p in enumerate(preps):
        t = p["raw_i8"].shape[1]
        alone = dp.granule_blocks(dp.prep_to_torch(p, "cpu"), dtype)
        lo = i * batch["t_max"]
        assert torch.equal(whole[:, lo:lo + t], alone), i


@pytest.mark.parametrize("ref_start", ["0", "1"])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_tables_are_the_planes_own(dtype, ref_start, monkeypatch):
    """The tables the wrapper hands the kernel are ``_consts``'s tensors,
    C-contiguous in the dtype, of the sizes the kernel reads, and equal to
    the tables built from their definitions."""
    monkeypatch.setenv("MP3STEGO_TPU_REF_START_WINDOW", ref_start)
    cpu = torch.device("cpu")
    tabs = dp._kernel_tables(dtype, cpu)
    c = dp._c(dtype, cpu)
    want = {
        "pow43": [float(i) ** (4.0 / 3.0) for i in range(8207)],
        "e1lut": [2.0 ** ((i - 266) / 4.0) for i in range(512)],
        "e2lut": [2.0 ** (-(i / 2.0)) for i in range(64)],
        "quarter": [2.0 ** (i / 4.0) for i in range(4)],
        "is_coef": dp._is_coef(),
        "cs": np.tile(T.ALIAS_CS, 31), "ca": np.tile(T.ALIAS_CA, 31),
        "c_long_t": T.imdct_long_cos().T, "c_short_t": T.imdct_short_cos().T,
        "sine": T.sine_block(), "sqrt2": math.sqrt(2.0)}
    assert len(tabs) == len(dp._TABLES)
    for t, (name, size) in zip(tabs, dp._TABLES):
        assert t is getattr(c, name), name
        assert t.dtype == dtype and t.is_contiguous() and t.numel() == size
        ref = torch.as_tensor(np.asarray(want[name], np.float64), dtype=dtype)
        assert torch.equal(t.reshape(-1), ref.reshape(-1)), name


def _linbits(native_pack: bool) -> dict:
    """The port's host_prepare of the linbits stream: the native pack lists
    escapes granule by granule, the NumPy one channel by channel."""
    from mp3stego_tpu_torch.bitstream import decoder_host as pdh
    return dp.host_prepare(pdh.parse_mp3(np.load(os.path.join(
        GOLD, "huffman_golden.npz"))["linbits"].tobytes(), 0),
        native_pack=native_pack)


def _escape_cases():
    def padded(lin):
        # a concat batch, its escapes reversed, a pad entry past the axis
        batch = prepare_batch_concat([lin, lin, lin])
        tt = batch["raw_i8"].shape[1]
        for k, extra in (("exc_t", tt), ("exc_ch", 1), ("exc_s", 7),
                         ("exc_val", 999)):
            batch[k] = np.concatenate([np.asarray([extra], batch[k].dtype),
                                       batch[k][::-1]])
        return batch

    return {
        "native pack": lambda: _linbits(True),
        "numpy pack": lambda: _linbits(False),
        "jax prep": lambda: _prep("synthetic"),
        "padded unsorted batch": lambda: padded(_linbits(False)),
        "no escapes": lambda: _prep("is_long"),
    }


@pytest.mark.parametrize("name", list(_escape_cases()))
def test_escape_index_rebuilds_dense_raw(name):
    """What the kernel reads of the int8 plane: granule t's escapes are
    ``exc_*[exc_start[t]:exc_start[t + 1]]``, all of granule t; written over
    the int8 plane granule by granule, they give ``dense_raw``."""
    prep = _escape_cases()[name]()
    tp = dp.prep_to_torch(prep, "cpu")
    dp._check_prep(tp, F32)
    tt = prep["raw_i8"].shape[1]
    start = tp["exc_start"].numpy()
    assert start.dtype == np.int32 and start.shape == (tt + 1,)
    assert start[0] == 0 and start[-1] == tp["exc_t"].numel()
    assert (np.diff(start) >= 0).all()
    got = tp["raw_i8"].numpy().astype(np.int32)
    exc = {k: tp[k].numpy() for k in dp.EXC_KEYS}
    for t in range(tt):
        lo, hi = start[t], start[t + 1]
        assert (exc["exc_t"][lo:hi] == t).all(), t
        got[exc["exc_ch"][lo:hi], t, exc["exc_s"][lo:hi]] = \
            exc["exc_val"][lo:hi]
    assert np.array_equal(got, dp.dense_raw(prep))
    if name != "no escapes":
        assert np.abs(got).max() > 127
    else:
        assert tp["exc_t"].numel() == 0
    inputs = dp.kernel_inputs(tp, F64)
    assert len(inputs) == 1 + len(dp._ESCAPES) + len(dp._SIDE) \
        + len(dp._TABLES)
    assert inputs[0] is tp["raw_i8"]
    assert all(a is tp[k] for a, (k, _, _) in zip(inputs[1:], dp._ESCAPES))


def test_int32_plane_hands_the_kernel_no_escapes():
    prep = dp.prep_to_torch(_linbits(True), "cpu")
    dense = {k: v for k, v in prep.items()
             if k not in dp.RAW_KEYS + ("exc_start",)}
    dense["raw_dense"] = torch.from_numpy(dp.dense_raw(_linbits(True)))
    inputs = dp.kernel_inputs(dense, F32)
    assert inputs[0] is dense["raw_dense"]
    assert inputs[1:1 + len(dp._ESCAPES)] == [None] * len(dp._ESCAPES)
    assert torch.equal(dp.granule_blocks(dense, F32),
                       dp.granule_blocks(prep, F32))


def _refusals():
    def drop(*keys):
        return lambda p: {k: v for k, v in p.items() if k not in keys}

    def put(key, fn):
        return lambda p: dict(p, **{key: fn(p[key])})

    return [
        ("float16", lambda p: p, torch.float16, "float32 or float64"),
        ("no plane", drop(*dp.RAW_KEYS), F32, "no sample plane"),
        ("no escapes", drop("exc_val"), F32, "without"),
        ("no escape index", drop("exc_start"), F32, "without"),
        ("short escape index", put("exc_start", lambda v: v[:-1]), F32,
         "exc_start must be"),
        ("int64 escape index", put("exc_start", lambda v: v.long()), F64,
         "exc_start must be"),
        ("escape lists of two lengths", put("exc_val", lambda v: v[:-1]),
         F32, "exc_val must be"),
        ("int16 plane", put("raw_i8", lambda v: v.to(torch.int16)), F32,
         "sample plane must be"),
        ("short rows", put("raw_i8", lambda v: v[..., :288].contiguous()),
         F32, "sample plane must be"),
        ("non-contiguous", put("sfl", lambda v: v.transpose(1, 2)
                               .contiguous().transpose(1, 2)), F32,
         "contiguous"),
        ("int32 gain", put("gg", lambda v: v.to(torch.int32)), F64,
         "gg must be"),
        ("missing key", drop("is_pos"), F64, "no is_pos"),
        ("meta device", lambda p: {k: torch.empty(v.shape, dtype=v.dtype,
                                                  device="meta")
                                   for k, v in p.items()}, F32,
         "CPU or CUDA"),
    ]


@pytest.mark.parametrize("name,make,dtype,match", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_wrapper_refuses_before_dispatch(name, make, dtype, match):
    prep = dp.prep_to_torch(graft._synthetic_prep(8), "cpu")
    before = dp.launches
    with pytest.raises(ValueError, match=match):
        dp.granule_blocks(make(prep), dtype)
    assert dp.launches == before


def test_float32_cosines_are_exactly_symmetric_float64_not():
    """The float kernel computes 18 long and 6 short IMDCT sums and mirrors
    the rest; that needs the float32 tables' exact symmetry, which
    ``_consts`` asserts. The float64 tables lack it, so float64 computes all
    36."""
    f32, f64 = dp._c(F32, "cpu"), dp._c(F64, "cpu")
    assert dp.imdct_symmetric(f32.c_long_t, f32.c_short_t)
    assert not dp.imdct_symmetric(f64.c_long_t, f64.c_short_t)
    for n in range(9):
        assert not torch.equal(f64.c_long_t[:, 17 - n], -f64.c_long_t[:, n])
    broken = f32.c_long_t.clone()
    broken[3, 30] = torch.nextafter(broken[3, 30], torch.tensor(2.0))
    assert not dp.imdct_symmetric(broken, f32.c_short_t)


def test_ptxas_resources_read_k2_from_the_kept_build_log(monkeypatch):
    """``_cuda.ptxas_resources`` reads each ``granule_kernel``
    instantiation's registers, static shared memory and spills from a
    build's kept ``-Xptxas -v`` log, by its mangled name: one
    instantiation's spills are not another's."""
    def entry(name, regs, smem, spills):
        return [f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'",
                f"ptxas info    : Function properties for {name}",
                f"    0 bytes stack frame, {spills} bytes spill stores, "
                f"{spills} bytes spill loads",
                f"ptxas info    : Used {regs} registers, used 1 barriers, "
                f"{smem} bytes smem, 904 bytes cmem[0]"]
    kern = "_ZN12_GLOBAL__N_114granule_kernelI{}EEvNS_6ParamsIT_T0_EE"
    log = "\n".join(entry(kern.format("da"), 72, 34000, 24)
                    + entry(kern.format("fi"), 56, 25000, 0))
    monkeypatch.setitem(_cuda.builds, "granule", {"log": log})
    assert _cuda.ptxas_resources("granule", "granule_kernelIda") == dict(
        registers=72, smem=34000, spill_stores=24, spill_loads=24)
    assert _cuda.ptxas_resources("granule", "granule_kernelIfi") == dict(
        registers=56, smem=25000, spill_stores=0, spill_loads=0)
    with pytest.raises(RuntimeError, match="granule_kernelIfa"):
        _cuda.ptxas_resources("granule", "granule_kernelIfa")


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/granule.cu built for the host with g++ against the emulation of
    ``tests/cuda_host_shim.py``. Returns the loaded library."""
    return cuda_host_shim.build("granule", tmp_path_factory.mktemp(
        "granule_host"), dp._SIGNATURES)


def _on_host(lib, monkeypatch, sms: int):
    """Route ``dp._launch`` to the host build: CPU tensors, stream 0, the
    occupancy the host build reports on a grid of ``sms`` SMs. Returns a
    launch that fails instead of hanging."""
    def occupancy(dev, dtype, wide):
        out = [ctypes.c_int(0) for _ in range(3)]
        assert lib.granule_occupancy(int(dtype == F64), int(wide),
                                     *(ctypes.addressof(v) for v in out)) == 0
        ctas, warps, smem = (v.value for v in out)
        assert ctas >= 1 and warps == 9
        assert smem == (0 if dtype == F64 else 2 * 32 * 36 * 4)
        return dict(ctas=ctas, warps=warps, smem=smem)
    monkeypatch.setattr(_cuda, "load", lambda name, sig: lib)
    monkeypatch.setattr(dp, "occupancy", occupancy)
    monkeypatch.setattr(dp, "_grid_cap", lambda dev, dtype, wide:
                        sms * occupancy(dev, dtype, wide)["ctas"])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())

    def launch(prep, dtype):
        box = []
        plane = dp._check_prep(prep, dtype)
        th = threading.Thread(target=lambda: box.append(
            dp._launch(prep, dtype, plane)), daemon=True)
        th.start()
        th.join(300)
        assert not th.is_alive(), "the host build of the kernel hung"
        return box[0]
    return launch


def _span(prep: dict, lo: int, hi: int) -> dict:
    """A host_prepare dict cut to granule indices [lo, hi), its escapes
    with it."""
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


def _loud(t: int) -> dict:
    """The synthetic prep with every sample an escape (|x| > 127): 1,152 a
    granule index, past the 288 a CTA fetches ahead."""
    prep = graft._synthetic_prep(t)
    raw = dp.dense_raw(prep)
    raw = np.where(raw >= 0, raw + 200, raw - 200).astype(np.int32)
    ch, tt, s = np.nonzero(np.abs(raw) > 127)
    prep["raw_i8"] = np.clip(raw, -128, 127).astype(np.int8)
    prep["exc_t"] = tt.astype(np.int32)
    prep["exc_ch"] = ch.astype(np.int8)
    prep["exc_s"] = s.astype(np.int16)
    prep["exc_val"] = raw[ch, tt, s].astype(np.int16)
    return prep


def _mono() -> dict:
    """host_prepare of a seeded 0.3 s mono stream the port encodes on the
    CPU."""
    import tempfile
    from mp3stego_tpu_torch.bitstream import decoder_host as pdh
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.utils.wav import read_wav, write_wav
    rng = np.random.default_rng(5)
    t = np.arange(13230)
    sig = 0.4 * np.sin(2 * np.pi * 440 * t / 44100) \
        + 0.05 * rng.standard_normal(len(t))
    with tempfile.TemporaryDirectory() as d:
        wav = os.path.join(d, "mono.wav")
        write_wav(wav, 44100, np.clip(sig * 20000, -32768, 32767)
                  .astype(np.int16))
        enc = MP3Encoder(read_wav(wav, 128), device="cpu")
        enc.encode()
    parsed = pdh.parse_mp3(bytes(enc.out_buffer), 0)
    assert parsed.header.channels == 1
    return dp.host_prepare(parsed)


# (name, the numpy prep, the int32 plane, emulated SMs): the host build's
# occupancy (3 CTAs an SM) gives grids of 3 to 9 CTAs, so most cases walk
# runs of several granules, and the "part-way" ones end a run early
HOST_CASES = [
    ("synthetic", lambda: graft._synthetic_prep(32), False, 2),
    ("synthetic, int32 plane", lambda: graft._synthetic_prep(32), True, 2),
    ("synthetic, reference start window", lambda: graft._synthetic_prep(16),
     False, 1),
] + [(n, (lambda n=n: _prep(n)), False, 1) for n in CRAFTED] + [
    ("linbits", lambda: _linbits(True), False, 1),
    ("linbits, int32 plane", lambda: _linbits(True), True, 1),
    ("mono", _mono, False, 2),
    ("one granule", lambda: _span(graft._synthetic_prep(8), 3, 4), False, 3),
    ("one granule, int32 plane", lambda: _span(graft._synthetic_prep(8), 3,
                                               4), True, 3),
    ("runs end part-way", lambda: _span(graft._synthetic_prep(32), 1, 12),
     False, 1),
    ("runs end part-way, int32 plane",
     lambda: _span(graft._synthetic_prep(32), 2, 31), True, 3),
    ("every sample an escape", lambda: _loud(6), False, 1),
]


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name,make,wide,sms", HOST_CASES,
                         ids=[c[0] for c in HOST_CASES])
def test_kernel_source_on_the_host_equals_plain_and_numpy(
        name, make, wide, sms, dtype, host_kernel, monkeypatch):
    """csrc/granule.cu, built for the host, through the wrapper's launch
    code: bit for bit ``granule_blocks_torch`` (signs of zero included) and,
    in float64, the NumPy plane's blocks by stage (after the IMDCT and
    before the synthesis) and its PCM."""
    if "reference start window" in name:
        monkeypatch.setenv("MP3STEGO_TPU_REF_START_WINDOW", "1")
    launch = _on_host(host_kernel, monkeypatch, sms)
    prep = make()
    tp = dp.prep_to_torch(prep, "cpu")
    if wide:
        dense = {k: v for k, v in tp.items()
                 if k not in dp.RAW_KEYS + ("exc_start",)}
        dense["raw_dense"] = torch.from_numpy(dp.dense_raw(prep))
        tp = dense
    tt = tp["mode"].shape[1]
    run = -(-tt // min(tt, dp._grid_cap(None, dtype, wide)))
    if "part-way" in name:
        assert tt % run, (tt, run)
    got = launch(tp, dtype)
    want = dp.granule_blocks_torch(tp, dtype)
    assert got.shape == (2, tt, 32, 36) and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(got.signbit(), want.signbit())
    if name == "every sample an escape":
        assert (np.bincount(prep["exc_t"]) > 288).all()
    if dtype == F64:
        stages = {}
        pcm = dp.decode_granules_np(prep, stages=stages)
        mine = {}
        got_pcm = dp.synth_from_blocks(got, mine)
        for k in ("post_imdct", "pre_synth"):
            np.testing.assert_array_equal(mine[k].numpy(), stages[k],
                                          err_msg=k)
        np.testing.assert_array_equal(got_pcm.numpy(), pcm)
