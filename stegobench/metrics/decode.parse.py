"""decode.parse: the decode's parse, in ms a second of audio: the
program's own span ``parse_mp3`` (``bitstream/decoder_host.parse_mp3``)
over the traced requests. Moves ``xrt``."""

import program_spans

UNIT = "ms/audio_s"
MOVES = "xrt"


def read(run):
    return program_spans.ms_per_audio_s(run, "parse_mp3")
