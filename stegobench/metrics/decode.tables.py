"""decode.tables: the decode's per-granule tables, in ms a second of
audio: the program's span ``prepare.tables``
(``ops/decode_plane.host_prepare``: block types, the reorder and mid/side
masks, scalefactor and intensity planes, counted by ``short_granules`` and
``ms_granules``) over the traced requests. Moves ``xrt``."""

import program_spans

UNIT = "ms/audio_s"
MOVES = "xrt"


def read(run):
    return program_spans.ms_per_audio_s(run, "prepare.tables")
