"""batch.k1_roofline: ``kernel.k1_roofline``'s reading (the same reader,
the same bound) in a cell whose end-to-end metric is the card's kernel
time, not ``xrt``. Moves ``kernel_ms_per_audio_s``."""

import core

UNIT = "%"
MOVES = "kernel_ms_per_audio_s"


def read(run):
    return core.load("metrics", "kernel.k1_roofline").read(run)
