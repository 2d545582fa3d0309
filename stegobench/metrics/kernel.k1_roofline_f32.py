"""kernel.k1_roofline_f32: K1 (``csrc/synth.cu``) in float32 as a share of
its roofline, in %: the least time its work could take
(``bounds_f32.k1_s``, from each traced request's granules and launches)
over the traced time of the kernels whose name holds ``KERNEL``. Moves
``xrt``."""

import bounds_f32
import trace_math

UNIT = "%"
MOVES = "xrt"
KERNEL = "synth_fused_kernel"


def read(run):
    us = trace_math.kernel_us(run.ops, KERNEL)
    if not us:
        return None
    need = sum(bounds_f32.k1_s(w["granules"], launches=w["launches"])
               for w in run.works)
    return 100.0 * need / (us / 1e6)
