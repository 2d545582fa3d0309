"""encode.finish: the encoder's host finish, in ms a second of audio: the
program's ``redo (host)`` and ``assemble+serialize (host)`` stages
(``models/encoder.py`` ``_plane_redo``, ``_plane_finish`` and the native
serializer) over the traced requests. Moves ``xrt``."""

UNIT = "ms/audio_s"
MOVES = "xrt"


def read(run):
    s = run.stage_s("redo (host)", "assemble+serialize (host)")
    if not s or not run.audio_s():
        return None
    return s * 1e3 / run.audio_s()
