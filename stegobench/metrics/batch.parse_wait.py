"""batch.parse_wait: the batched decode's wait for its parse pool, in ms a
second of audio: the program's span ``batch.parse_wait``
(``parallel/batch_decode.py``, the caller's thread waiting for every
file's read and ``parse_mp3``) over the traced requests. Moves
``kernel_ms_per_audio_s``, as ``batch.xrt`` does."""

import program_spans

UNIT = "ms/audio_s"
MOVES = "kernel_ms_per_audio_s"


def read(run):
    return program_spans.ms_per_audio_s(run, "batch.parse_wait")
