"""request.unspanned: the share of the traced requests' wall, on the
caller's thread, in which no span of the program was open, in %: the
kind's own glue (the hide's ``WavFile`` build, its message framing) and
the program's work outside every span. Moves ``xrt``."""

import program_spans

UNIT = "%"
MOVES = "xrt"


def read(run):
    return program_spans.unspanned_pct(run)
