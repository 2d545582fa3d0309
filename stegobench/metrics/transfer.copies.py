"""transfer.copies: the decode's copies to and from the card, in ms a
second of audio: the program's ``h2d`` and ``d2h`` stages
(``ops/decode_plane.decode_pcm_i16``, ``utils/transfer.py``) over the
traced requests. Moves ``xrt``."""

UNIT = "ms/audio_s"
MOVES = "xrt"


def read(run):
    s = run.stage_s("h2d", "d2h")
    if not s or not run.audio_s():
        return None
    return s * 1e3 / run.audio_s()
