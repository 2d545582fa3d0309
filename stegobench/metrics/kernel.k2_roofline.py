"""kernel.k2_roofline: K2 (``csrc/granule.cu``) as a share of its roofline,
in %: the least time its work could take on the card (``bounds.k2_s``,
from each traced request's granules and escapes) over
the traced time of the kernels whose name holds ``KERNEL``. Moves ``xrt``."""

import bounds
import trace_math

UNIT = "%"
MOVES = "xrt"
KERNEL = "granule_kernel"


def read(run):
    us = trace_math.kernel_us(run.ops, KERNEL)
    if not us:
        return None
    need = sum(bounds.k2_s(w["granules"], w["escapes"])
               for w in run.works)
    return 100.0 * need / (us / 1e6)
