"""kernel.k3_roofline: K3 (``csrc/analysis.cu``) as a share of its
roofline, in %: the least time its work could take on the card
(``bounds.k3_s``, from each traced request's granules) over the traced
time of the kernels whose name holds ``KERNEL``. Moves ``xrt``."""

import bounds
import trace_math

UNIT = "%"
MOVES = "xrt"
KERNEL = "analysis_kernel"


def read(run):
    us = trace_math.kernel_us(run.ops, KERNEL)
    if not us:
        return None
    need = sum(bounds.k3_s(w["granules"]) for w in run.works)
    return 100.0 * need / (us / 1e6)
