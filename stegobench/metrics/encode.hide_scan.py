"""encode.hide_scan: the hide's host scan in cursor order, in ms a second
of audio: the program's ``hide scan (host)`` stage
(``MP3Encoder._encode_hide``, ``_scan_block``) over the traced requests.
Moves ``xrt``."""

UNIT = "ms/audio_s"
MOVES = "xrt"


def read(run):
    s = run.stage_s("hide scan (host)")
    if not s or not run.audio_s():
        return None
    return s * 1e3 / run.audio_s()
