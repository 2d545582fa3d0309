"""batch.prep_wait: the batched decode's wait for its chunk preparation,
in ms a second of audio: the program's spans ``batch.prep_wait``
(``parallel/batch_decode.py``, the caller's thread waiting for the prep
thread's ``host_prepare`` calls, concat and pinning of the next chunk)
over the traced requests. Moves ``kernel_ms_per_audio_s``."""

import program_spans

UNIT = "ms/audio_s"
MOVES = "kernel_ms_per_audio_s"


def read(run):
    return program_spans.ms_per_audio_s(run, "batch.prep_wait")
