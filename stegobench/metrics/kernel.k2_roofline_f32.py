"""kernel.k2_roofline_f32: K2 (``csrc/granule.cu``) in float32 as a share
of its roofline, in %: the least time its work could take
(``bounds_f32.k2_s``, from each traced request's granules) over the
traced time of the kernels whose name holds ``KERNEL``. Moves ``xrt``."""

import bounds_f32
import trace_math

UNIT = "%"
MOVES = "xrt"
KERNEL = "granule_kernel"


def read(run):
    us = trace_math.kernel_us(run.ops, KERNEL)
    if not us:
        return None
    need = sum(bounds_f32.k2_s(w["granules"]) for w in run.works)
    return 100.0 * need / (us / 1e6)
