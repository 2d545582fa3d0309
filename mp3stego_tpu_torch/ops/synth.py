"""The fused polyphase synthesis (kernel K1): its CUDA wrapper and its plain
version.

From the IMDCT blocks ``blk`` (rows, T, 32, 36), one row per (file, channel)
from zero state, in five steps (decoder/Frame.py:65-103, 624-631):

1. overlap-add ``y[g] = blk[g][..., :18] + blk[g-1][..., 18:]`` (zeros for
   g = 0);
2. frequency inversion: ``y *= -1`` where band and sub-step are both odd;
3. step major ``st[r, i]``, r = 18 g + sub-step;
4. ``V[r, k] = sum_{i<32} st[r, i] * N[k, i]`` with N the (64, 32)
   synthesis matrix;
5. the 16-tap FIR ``pcm[r, k] = sum_{j<16} D[j, k] * V[r-j, 32 (j%2) + k]``
   with D the ISO synthesis window (16, 32) and V rows below 0 zero;

then float PCM (rows, T, 576), or int16 interleaved per file (files, T*576,
channels), saturated or (``tables.ref_pcm_wrap``) wrapped as ``to_i16``.

A row need not start from zero state: ``halo`` (rows, 2, 32, 36) holds the
blocks of the two granules before granule 0 of each row (a time range of a
frame-sharded decode, ``parallel.frame_shard``). Granule -2's tail and
granule -1 carry all the state a row has: granule 0's overlap-add reads
granule -1's tail, and the FIR's 15 history steps are granule -1's last 15
V rows, whose ``y`` is granule -1's head plus granule -2's tail. So the PCM
is bit for bit that of the row ``[halo | blk]`` from zero state, less its
first two granules.
Both sums run in ascending order from +0, every product and sum rounded on
its own: the float64 NumPy plane's order (``decode_granules_np``).

* ``synth_fused`` — the wrapper the decode plane calls. A CPU tensor takes
  the plain version; a CUDA tensor launches ``csrc/synth.cu`` (it replaces
  the TPU kernel ``mp3stego_tpu/ops/pallas_kernels.py::_fir_kernel`` and the
  overlap, inversion and V matmul around it) or raises. There is no fallback
  from the card to the plain version.
* ``synth_fused_torch`` — the plain PyTorch version: the same five steps as
  eager ops in the same order (the V sum as 32 steps of ``v = v + st_i *
  N_i``, the FIR as 16 steps of ``pcm = pcm + D_j * V``). The kernel equals
  it bit for bit on the card, in float32 and float64, in both epilogues.
* ``launches`` — how many times the kernel was launched in this process.
"""

import ctypes
import functools

import torch
from torch.profiler import record_function

from mp3stego_tpu_torch import tables as T

launches = 0
# the kernel's grid.y: the most (file, channel) rows one launch takes
MAX_ROWS = 65535
OUTS = ("float", "int16")

# blk, halo (or None), N transposed, the window, out; rows, T, out_i16,
# channels, wrap; the stream
_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p)
_SIGNATURES = {
    "synth_fused_f32": (ctypes.c_int, _ARGS),
    "synth_fused_f64": (ctypes.c_int, _ARGS),
    "synth_fused_tile": (ctypes.c_int, (ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p)),
}
_ENTRY = {torch.float32: "synth_fused_f32", torch.float64: "synth_fused_f64"}


@functools.lru_cache(maxsize=None)
def _tables(dtype: torch.dtype, device: torch.device):
    """(N transposed (32, 64), the window D (16, 32), the frequency-inversion
    signs (32, 18)) in ``dtype`` on ``device``."""
    f = functools.partial(torch.as_tensor, dtype=dtype, device=device)
    inv = torch.ones((32, 18), dtype=torch.float64)
    inv[1::2, 1::2] = -1.0
    return (f(T.synth_filter_matrix().T.copy()).contiguous(),
            f(T.SYNTH_WINDOW.reshape(16, 32)).contiguous(),
            inv.to(dtype=dtype, device=device))


def _check(blk: torch.Tensor, out: str, channels: int, halo=None):
    if blk.dim() != 4 or blk.shape[2:] != (32, 36) or blk.shape[0] < 1 \
            or blk.shape[1] < 1:
        raise ValueError(f"synth_fused wants blk (rows, T >= 1, 32, 36), got "
                         f"{tuple(blk.shape)}")
    if out not in OUTS:
        raise ValueError(f"out must be one of {OUTS}, got {out!r}")
    if channels < 1 or blk.shape[0] % channels:
        raise ValueError(f"{blk.shape[0]} rows are not files of {channels} "
                         f"channels")
    if blk.dtype not in _ENTRY:
        raise ValueError(f"synth_fused takes float32 or float64, got "
                         f"{blk.dtype}")
    if halo is not None and (
            tuple(halo.shape) != (blk.shape[0], 2, 32, 36)
            or halo.dtype != blk.dtype or halo.device != blk.device):
        raise ValueError(f"the halo must be ({blk.shape[0]}, 2, 32, 36) "
                         f"{blk.dtype} on {blk.device}, got "
                         f"{tuple(halo.shape)} {halo.dtype} on {halo.device}")


def ascending_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` as K eager steps ``out = out + x_k * w_k``
    from +0: each product and each sum rounded on its own, in ascending k
    (the float64 NumPy plane's order; no BLAS, no fused multiply-add)."""
    out = x.new_zeros(x.shape[:-1] + (w.shape[1],))
    for k in range(w.shape[0]):
        out.add_(x[..., k:k + 1] * w[k])
    return out


def overlap_freqinv(blk: torch.Tensor, halo: torch.Tensor = None):
    """Steps 1 and 2: (y after the overlap-add, y after the frequency
    inversion), each (rows, T, 32, 18). Granule 0 adds the tail of the
    last granule of ``halo`` (rows, H, 32, 36), or zeros without one."""
    tail = blk[..., 18:]
    first = torch.zeros_like(tail[:, :1]) if halo is None \
        else halo[:, -1:, :, 18:]
    prev = torch.cat([first, tail[:, :-1]], dim=1)
    y = blk[..., :18] + prev
    return y, y * _tables(blk.dtype, blk.device)[2]


def synth_fir_torch(v_ext: torch.Tensor, ts_total: int) -> torch.Tensor:
    """Step 5, plain: (rows, 15 + S, 64) V with 15 history rows in front ->
    (rows, S, 32), summed in ascending j (Frame.py:97-101)."""
    d = _tables(v_ext.dtype, v_ext.device)[1]
    va, vb = v_ext[..., :32], v_ext[..., 32:]
    pcm = v_ext.new_zeros((v_ext.shape[0], ts_total, 32))
    for j in range(16):
        src = va if j % 2 == 0 else vb
        pcm = pcm + d[j] * src[:, 15 - j:15 - j + ts_total]
    return pcm


def to_i16(pcm: torch.Tensor) -> torch.Tensor:
    """float PCM -> int16 WAV samples on its device: saturating by default
    (tables.ref_pcm_wrap), or numpy's ``(pcm * 32767).astype(int16)``
    truncate-and-wrap (the reference's conversion) under
    MP3STEGO_TPU_REF_PCM_WRAP=1."""
    x = pcm * 32767.0
    if not T.ref_pcm_wrap():
        x = x.clamp(-32768.0, 32767.0)
    return x.to(torch.int32).to(torch.int16)


def interleave_i16(pcm: torch.Tensor, channels: int) -> torch.Tensor:
    """(files * channels, T, 576) float PCM -> (files, T * 576, channels)
    int16, the WAV's sample order."""
    rows, tt = pcm.shape[0], pcm.shape[1]
    return to_i16(pcm).reshape(rows // channels, channels, tt * 576) \
        .transpose(1, 2).contiguous()


def _synth_v(y: torch.Tensor) -> torch.Tensor:
    """Steps 3 and 4: inverted y (rows, T, 32, 18) -> V (rows, 18T, 64)."""
    rows, tt = y.shape[0], y.shape[1]
    st = y.transpose(2, 3).reshape(rows, tt * 18, 32)
    return ascending_matmul(st, _tables(y.dtype, y.device)[0])


def synth_fused_torch(blk: torch.Tensor, out: str = "float",
                      channels: int = 1, halo: torch.Tensor = None
                      ) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, in ``blk``'s dtype and on
    its device: the five steps as eager ops in the kernel's order. With a
    ``halo`` the overlap-add of granule 0 reads its tail and the FIR's
    history is granule -1's V (zeros without one)."""
    _check(blk, out, channels, halo)
    rows, tt = blk.shape[0], blk.shape[1]
    with record_function("overlap_freqinv"):
        y = overlap_freqinv(blk, halo)[1]
        if halo is not None:
            y_prev = overlap_freqinv(halo[:, 1:], halo[:, :1])[1]
    with record_function("synth_v"):
        v = _synth_v(y)                                      # (rows, 18T, 64)
        history = v.new_zeros((rows, 15, 64)) if halo is None \
            else _synth_v(y_prev)[:, 3:]
    with record_function("synth_fir"):
        v_ext = torch.cat([history, v], dim=1)
        pcm = synth_fir_torch(v_ext, tt * 18).reshape(rows, tt, 576)
    return pcm if out == "float" else interleave_i16(pcm, channels)


def tile(dtype: torch.dtype) -> tuple:
    """(granules per CTA, dynamic shared memory bytes per CTA) of the
    kernel for ``dtype``; builds the kernel on first use."""
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("synth", _SIGNATURES)
    g, smem = ctypes.c_int(), ctypes.c_int()
    lib.synth_fused_tile(int(dtype == torch.float64), ctypes.byref(g),
                         ctypes.byref(smem))
    return g.value, smem.value


def synth_fused(blk: torch.Tensor, out: str = "float",
                channels: int = 1, halo: torch.Tensor = None) -> torch.Tensor:
    """(rows, T, 32, 36) IMDCT blocks -> float PCM (rows, T, 576), or int16
    (rows / channels, T * 576, channels) with ``out="int16"``; ``halo``
    (rows, 2, 32, 36), the blocks of granules -2 and -1 of each row, or
    None for rows that start their stream.

    On a CUDA tensor (float32 or float64, C-contiguous, 16-byte aligned, at
    most ``MAX_ROWS`` rows, the halo likewise) this launches the
    hand-written kernel on the current stream; anything else on the card
    raises. A CPU tensor takes ``synth_fused_torch``."""
    global launches
    _check(blk, out, channels, halo)
    if blk.device.type == "cpu":
        return synth_fused_torch(blk, out, channels, halo)
    if blk.device.type != "cuda":
        raise ValueError(f"synth_fused runs on CPU or CUDA tensors, got "
                         f"{blk.device}")
    for name, t in (("blk", blk), ("halo", halo)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"the CUDA synth_fused takes a C-contiguous, "
                             f"16-byte aligned {name}")
    rows, tt = blk.shape[0], blk.shape[1]
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} (file, channel) rows exceed the synthesis "
                         f"kernel's {MAX_ROWS}")
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("synth", _SIGNATURES)
    n_t, d, _ = _tables(blk.dtype, blk.device)
    if out == "float":
        res = torch.empty((rows, tt, 576), dtype=blk.dtype, device=blk.device)
    else:
        res = torch.empty((rows // channels, tt * 576, channels),
                          dtype=torch.int16, device=blk.device)
    stream = torch.cuda.current_stream(blk.device).cuda_stream
    with torch.cuda.device(blk.device):
        rc = getattr(lib, _ENTRY[blk.dtype])(
            blk.data_ptr(), None if halo is None else halo.data_ptr(),
            n_t.data_ptr(), d.data_ptr(), res.data_ptr(),
            rows, tt, int(out == "int16"), channels, int(T.ref_pcm_wrap()),
            stream)
    if rc != 0:
        raise RuntimeError(f"synth_fused kernel launch failed: CUDA error {rc}")
    launches += 1
    return res
