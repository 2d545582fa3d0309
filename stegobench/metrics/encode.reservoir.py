"""encode.reservoir: the encoder's reservoir chain and stuffing, in ms a
second of audio: the program's span ``finish.reservoir``
(``MP3Encoder._plane_reservoir``, a Python loop over the frames) over the
traced requests. Moves ``xrt``."""

import program_spans

UNIT = "ms/audio_s"
MOVES = "xrt"


def read(run):
    return program_spans.ms_per_audio_s(run, "finish.reservoir")
