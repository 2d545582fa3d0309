"""The synthesis FIR (kernel K1): its CUDA wrapper and its plain version.

``pcm[c, t, k] = sum_{j<16} D[j, k] * v_ext[c, t + 15 - j, 32 * (j % 2) + k]``:
the 16-tap polyphase window over the V history (decoder/Frame.py:80-101),
with ``v_ext`` (ch, 15 + S, 64) carrying 15 history rows in front of the S
sub-steps and ``D`` the ISO synthesis window reshaped (16, 32).

* ``synth_fir`` — the wrapper the decode plane calls. A CPU tensor takes the
  plain version; a CUDA tensor launches ``csrc/synth_fir.cu`` (it replaces
  the TPU kernel ``mp3stego_tpu/ops/pallas_kernels.py::_fir_kernel``) or
  raises. There is no fallback from the card to the plain version.
* ``synth_fir_torch`` — the plain PyTorch version: the reference's
  ascending-j sum as two eager ops per tap. The kernel rounds in the same
  order and equals it bit for bit on the card.
* ``launches`` — how many times the kernel was launched in this process.
"""

import ctypes
import functools

import torch

from mp3stego_tpu_torch import tables as T

launches = 0
# the kernel's grid.y: the most channel rows one launch takes
MAX_ROWS = 65535

_SIGNATURES = {
    "synth_fir_f32": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_void_p)),
}


@functools.lru_cache(maxsize=None)
def _window(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The (16, 32) synthesis window D in ``dtype`` on ``device``."""
    return torch.as_tensor(T.SYNTH_WINDOW.reshape(16, 32), dtype=dtype,
                           device=device).contiguous()


def _check_shape(v_ext: torch.Tensor, ts_total: int):
    if (v_ext.dim() != 3 or v_ext.shape[2] != 64 or ts_total < 1
            or v_ext.shape[1] != 15 + ts_total):
        raise ValueError(f"synth_fir wants v_ext (ch, 15 + {ts_total}, 64) "
                         f"with ts_total >= 1, got {tuple(v_ext.shape)}")


def synth_fir_torch(v_ext: torch.Tensor, ts_total: int) -> torch.Tensor:
    """Plain PyTorch FIR: (ch, 15 + S, 64) -> (ch, S, 32), in v_ext's dtype
    and on its device, summed in ascending j (Frame.py:97-101)."""
    _check_shape(v_ext, ts_total)
    d = _window(v_ext.dtype, v_ext.device)
    va, vb = v_ext[..., :32], v_ext[..., 32:]
    pcm = v_ext.new_zeros((v_ext.shape[0], ts_total, 32))
    for j in range(16):
        src = va if j % 2 == 0 else vb
        pcm = pcm + d[j] * src[:, 15 - j:15 - j + ts_total]
    return pcm


def synth_fir(v_ext: torch.Tensor, ts_total: int) -> torch.Tensor:
    """(ch, 15 + S, 64) V history -> (ch, S, 32) PCM sub-steps.

    On a CUDA tensor (float32, C-contiguous) this launches the hand-written
    kernel on the current stream; anything else on the card raises. A CPU
    tensor (float32 or float64) takes ``synth_fir_torch``."""
    global launches
    _check_shape(v_ext, ts_total)
    if v_ext.device.type == "cpu":
        return synth_fir_torch(v_ext, ts_total)
    if v_ext.device.type != "cuda":
        raise ValueError(f"synth_fir runs on CPU or CUDA tensors, got "
                         f"{v_ext.device}")
    if v_ext.dtype != torch.float32:
        raise ValueError(f"the CUDA synth_fir takes float32, got {v_ext.dtype}")
    if not v_ext.is_contiguous():
        raise ValueError("the CUDA synth_fir takes a C-contiguous v_ext")
    from mp3stego_tpu_torch.ops import _cuda
    lib = _cuda.load("synth_fir", _SIGNATURES)
    ch = v_ext.shape[0]
    out = torch.empty((ch, ts_total, 32), dtype=torch.float32,
                      device=v_ext.device)
    d = _window(torch.float32, v_ext.device)
    stream = torch.cuda.current_stream(v_ext.device).cuda_stream
    with torch.cuda.device(v_ext.device):
        rc = lib.synth_fir_f32(v_ext.data_ptr(), d.data_ptr(), out.data_ptr(),
                               ch, ts_total, stream)
    if rc != 0:
        raise RuntimeError(f"synth_fir kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
