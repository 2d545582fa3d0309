"""decode.host: the decode's host half, in ms a second of audio: the
benchmark's span around ``parse_mp3`` and the program's ``host_prepare``
stage (``ops/decode_plane.decode_pcm_i16``), over the traced requests.
Moves ``xrt``."""

UNIT = "ms/audio_s"
MOVES = "xrt"


def read(run):
    prep = run.stage_s("host_prepare")
    if not prep or not run.audio_s():
        return None
    return (run.span_s("parse_mp3") + prep) * 1e3 / run.audio_s()
