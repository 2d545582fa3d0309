"""utils/transfer.py: the card's staged transfers, held on the CPU.

The staging path (``_put_staged``, ``_fetch_staged``, ``_concat_staged``)
is what the card runs, with pinned buffers and side streams; here it runs
with an unpinned pool on CPU tensors, ``PIECE_BYTES`` small enough that
every copy is split. The public functions on a CPU device are plain
``from_numpy`` / ``.numpy()``. The JAX package's ``put_pieces`` /
``fetch_pieces`` give the same values.
"""

import numpy as np
import pytest
import torch

from mp3stego_tpu.utils import transfer as JX
from mp3stego_tpu_torch.utils import transfer as X

CPU = torch.device("cpu")
DTYPES = (np.int8, np.int16, np.int32, np.int64, np.float32, np.float64)
# 0-d, empty, one piece, above a piece (PIECE_BYTES = 64 below)
SHAPES = ((), (0, 5), (3,), (7, 33))


def _array(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, dtype=dtype,
                        endpoint=True)


@pytest.fixture
def staging(monkeypatch):
    monkeypatch.setattr(X, "PIECE_BYTES", 64)
    return X.StagingPool(CPU, pin=False)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_staged_round_trip_is_exact(staging, dtype, shape):
    a = _array(dtype, shape, 1)
    (t,) = X._put_staged([a], CPU, staging)
    assert t.shape == a.shape and t.numpy().dtype == a.dtype
    (back,) = X._fetch_staged([t], staging)
    assert back.shape == a.shape and back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)
    # the public path on the CPU is plain and shares memory
    pt = X.put_pieces(a, "cpu")
    assert np.shares_memory(pt.numpy(), a) or a.size == 0
    np.testing.assert_array_equal(X.fetch_pieces([pt])[0], a)


def test_put_tree_equals_per_array_puts(staging):
    tree = {f"{np.dtype(d).name}{i}": _array(d, s, i)
            for i, (d, s) in enumerate(zip(DTYPES, SHAPES * 2))}
    tree["mask"] = _array(np.int8, (9, 2), 7) > 0
    got = X._put_staged(list(tree.values()), CPU, staging)
    for (k, a), t in zip(tree.items(), got):
        one = X._put_staged([a], CPU, staging)[0]
        assert t.dtype == one.dtype and t.shape == one.shape, k
        assert torch.equal(t, one), k
    # every tensor of a tree starts at an ALIGN-ed offset of one buffer
    base = got[0].untyped_storage().data_ptr()
    for t in got:
        if t.numel():
            assert t.untyped_storage().data_ptr() == base
            assert (t.data_ptr() - base) % X.ALIGN == 0
    assert list(X.put_tree(tree, "cpu")) == list(tree)


def test_a_later_fetch_leaves_an_earlier_result_intact(staging):
    first_src = torch.from_numpy(_array(np.float64, (40, 9), 2))
    first = X._fetch_staged([first_src], staging)[0]
    view = first[3:]                       # the caller keeps a view only
    want = first_src.numpy()[3:].copy()
    del first
    for seed in range(3, 6):
        X._fetch_staged([torch.from_numpy(_array(np.float64, (40, 9),
                                                 seed))], staging)
    np.testing.assert_array_equal(view, want)
    assert len(staging._slabs) == 2        # held one, reused the other
    del view
    X._fetch_staged([first_src], staging)
    assert len(staging._slabs) == 2        # the released buffer came back


def test_the_pool_grows_a_free_buffer_too_small(staging):
    X._fetch_staged([torch.zeros(10, dtype=torch.uint8)], staging)
    assert len(staging._slabs) == 1
    big = X._GRAIN * 3 + 5
    X._fetch_staged([torch.zeros(big, dtype=torch.uint8)], staging)
    assert len(staging._slabs) == 1 and staging.nbytes() >= big


@pytest.mark.parametrize("dim", (0, 1, 2))
def test_fetch_concat_equals_numpy_concatenate(staging, dim):
    parts = []
    for k, n in enumerate((3, 1, 4)):
        shape = [2, 5, 6]
        shape[dim] = n
        parts.append(torch.from_numpy(_array(np.float32, shape, k)))
    want = np.concatenate([p.numpy() for p in parts], axis=dim)
    got = X._concat_staged(parts, dim, staging)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(X.fetch_concat(parts, dim), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_same_values_as_the_jax_package(staging, dtype):
    arrs = [_array(dtype, s, 9) for s in SHAPES]
    want = JX.fetch_pieces([JX.put_pieces(a) for a in arrs])
    got = X._fetch_staged(X._put_staged(arrs, CPU, staging), staging)
    for a, w, g in zip(arrs, want, got):
        assert g.shape == np.asarray(w).shape == a.shape
        np.testing.assert_array_equal(g, np.asarray(w))
    jtree = JX.put_tree({"a": arrs[3], "b": arrs[2]})
    ttree = X.put_tree({"a": arrs[3], "b": arrs[2]}, "cpu")
    for k in ("a", "b"):
        np.testing.assert_array_equal(ttree[k].numpy(), np.asarray(jtree[k]))


def test_the_pool_keeps_at_most_keep_bytes_free(staging, monkeypatch):
    monkeypatch.setattr(X, "KEEP_BYTES", X._GRAIN)
    srcs = [torch.from_numpy(_array(np.int32, (X._GRAIN // 4,), k))
            for k in range(4)]
    held = [X._fetch_staged([s], staging)[0] for s in srcs]
    assert len(staging._slabs) == 4        # every result holds its buffer
    keep = held.pop(1)
    del held                               # three buffers come free
    last = X._fetch_staged([srcs[0]], staging)[0]
    # the two held buffers (the one just taken reused a free one), and
    # the free ones up to KEEP_BYTES
    free = [s for s in staging._slabs if not s.busy()]
    assert sum(s.buf.numel() for s in free) <= X.KEEP_BYTES
    assert len(staging._slabs) == 3
    del last
    staging.trim()
    assert len(staging._slabs) == 1        # only the held one stays
    np.testing.assert_array_equal(keep, srcs[1].numpy())
    del keep
    staging.trim()
    assert staging.nbytes() == 0


def test_staging_is_filled_without_torchs_thread_pool(staging, monkeypatch):
    """The host's copy into a staging buffer is NumPy's, a memcpy on the
    calling thread, and not ``Tensor.copy_``, which spreads a large copy
    over torch's intra-op threads and waits for the slowest of them."""
    real = torch.Tensor.copy_
    into = []

    def copy_(dst, src, *a, **k):
        into.append(dst.data_ptr())
        return real(dst, src, *a, **k)
    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    arrays = [_array(np.int32, (1 << 16,), 3), _array(np.int8, (7, 33), 4),
              _array(np.int8, (9, 2), 5) > 0, _array(np.float64, (), 6)]
    got = X._put_staged(arrays, CPU, staging)
    (slab,) = staging._slabs
    lo = slab.buf.data_ptr()
    assert into and not [p for p in into if lo <= p < lo + slab.buf.numel()]
    for a, t in zip(arrays, got):
        assert t.numpy().dtype == a.dtype
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("entry", ["decode_pcm", "Decoder", "MP3Encoder",
                                   "cost_all_steps", "decode_files_batched",
                                   "encode_files_batched",
                                   "decode_file_streaming"])
def test_every_entry_point_keeps_the_one_device_rule(entry, encode_golden,
                                                     tmp_path, monkeypatch):
    """``resolve_device`` is the port's one device rule: given no device
    and no card, every entry point raises its error, word for word, which
    names the CUDA device and the way to the CPU."""
    from mp3stego_tpu_torch.bitstream import decoder_host as dh
    from mp3stego_tpu_torch.models.decoder import Decoder
    from mp3stego_tpu_torch.models.encoder import MP3Encoder
    from mp3stego_tpu_torch.models.streaming import decode_file_streaming
    from mp3stego_tpu_torch.ops import decode_plane as dp
    from mp3stego_tpu_torch.ops import quant_batch as QB
    from mp3stego_tpu_torch.parallel import (decode_files_batched,
                                             encode_files_batched)
    from mp3stego_tpu_torch.utils.wav import WavFile
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        X.resolve_device()
    assert "CUDA" in str(want.value) and "device='cpu'" in str(want.value)
    assert X.resolve_device("cpu") == torch.device("cpu")
    data = encode_golden["mp3_bytes"].tobytes()
    mp3 = tmp_path / "e.mp3"
    mp3.write_bytes(data)
    pcm = np.zeros(2 * 1152, np.int16)
    wav = WavFile(file_path="w.wav", bitrate=128, num_of_channels=2,
                  samplerate=44100, bits_per_sample=16,
                  num_of_samples=pcm.size, mpeg_mode=0, buffer=pcm)
    calls = {
        "decode_pcm": lambda: dp.decode_pcm(dh.parse_mp3(data), "float32"),
        "Decoder": lambda: Decoder(str(mp3), str(tmp_path / "o.wav"),
                                   precision="float32"),
        "MP3Encoder": lambda: MP3Encoder(wav),
        "cost_all_steps": lambda: QB.cost_all_steps(
            np.zeros((1, 576), np.int32), 0),
        "decode_files_batched": lambda: decode_files_batched([str(mp3)]),
        "encode_files_batched": lambda: encode_files_batched(
            [("a.wav", "a.mp3")]),
        "decode_file_streaming": lambda: decode_file_streaming(
            str(mp3), str(tmp_path / "s.wav"), 9),
    }
    with pytest.raises(RuntimeError) as got:
        calls[entry]()
    assert str(got.value) == str(want.value)
