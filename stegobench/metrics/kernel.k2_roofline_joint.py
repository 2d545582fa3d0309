"""kernel.k2_roofline_joint: K2 (``csrc/granule.cu``) on joint-stereo files
with short blocks and scalefactors, as a share of its roofline, in %: the
least time its work could take (``bounds_joint.k2_s``, from each traced
request's granules, short granules and mid/side granules) over the traced
time of the kernels whose name holds ``KERNEL``. Moves ``xrt``."""

import bounds_joint
import trace_math

UNIT = "%"
MOVES = "xrt"
KERNEL = "granule_kernel"


def read(run):
    us = trace_math.kernel_us(run.ops, KERNEL)
    if not us or any("short_granules" not in w for w in run.works):
        return None
    need = sum(bounds_joint.k2_s(w["granules"], w["short_granules"],
                                 w["ms_granules"]) for w in run.works)
    return 100.0 * need / (us / 1e6)
