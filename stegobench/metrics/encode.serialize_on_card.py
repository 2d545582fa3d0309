"""encode.serialize_on_card: the share of the encoded frames that the card
serialized, in %: 100 x the ``card_frames`` of the program's spans
``finish.serialize`` (``MP3Encoder._plane_serialize``; the frames packed
by ``csrc/serialize.cu``) over their ``frames``, over the traced requests;
None where no such span carries the ``card_frames`` count (a program
without it). Moves ``xrt``."""

import program_spans

UNIT = "%"
MOVES = "xrt"


def read(run):
    got = program_spans.of(run)
    if got is None:
        return None
    frames = card = 0
    seen = False
    for s in got:
        if s.name == "finish.serialize" and "card_frames" in s.counts:
            seen = True
            frames += s.counts.get("frames", 0)
            card += s.counts["card_frames"]
    if not seen or frames <= 0:
        return None
    return 100.0 * card / frames
