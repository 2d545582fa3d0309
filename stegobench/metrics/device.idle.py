"""device.idle: the share of the traced stretch's wall in which the card
ran nothing, in %: 100 x (1 - the union of its kernel, copy and set
intervals / the stretch's host-clock wall). Moves ``xrt``."""

UNIT = "%"
MOVES = "xrt"


def read(run):
    if not run.ops or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
