"""Throughput over many files: the batched decode and the batched encode.

``decode_files_batched`` runs the decode plane over a chunk of files at once
(one granule axis for the granule half, one synthesis-kernel launch over
every (file, channel) row); ``encode_files_batched`` runs one analysis and search
pass over every file of a (samplerate, channels) group. Both run on the card
unless the caller passes ``device="cpu"``.
"""

from mp3stego_tpu_torch.parallel.batch_decode import (  # noqa: F401
    decode_files_batched, prepare_batch_concat,
)
from mp3stego_tpu_torch.parallel.batch_encode import (  # noqa: F401
    encode_files_batched,
)
