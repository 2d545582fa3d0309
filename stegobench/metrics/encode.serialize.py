"""encode.serialize: the encoder's frame serialization, in ms a second of
audio: the program's span ``finish.serialize``
(``MP3Encoder._plane_serialize``, the native serializer) over the traced
requests. Moves ``xrt``."""

import program_spans

UNIT = "ms/audio_s"
MOVES = "xrt"


def read(run):
    return program_spans.ms_per_audio_s(run, "finish.serialize")
