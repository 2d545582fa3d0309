"""decode.parse_native: the native parser's fill pass, in ms a second of
audio: the program's span ``parse.native`` (the ``mp3_parse`` call inside
``bitstream/decoder_host.parse_mp3_native``) over the traced requests.
Moves ``xrt``."""

import program_spans

UNIT = "ms/audio_s"
MOVES = "xrt"


def read(run):
    return program_spans.ms_per_audio_s(run, "parse.native")
