"""Scale-out: the device mesh, the batched decode and encode over many
files, and the frame-sharded decode of one stream.

``make_mesh`` builds a (files, frames) grid of torch devices (an entry may
repeat, so one card can hold several shards). ``decode_files_batched``
runs the decode plane over a chunk of files at once (one granule axis for
the granule half, one synthesis-kernel launch over every (file, channel)
row), its chunks round-robin over the mesh's ``files`` devices;
``prepare_batch`` and ``decode_batch_device`` are the stacked file-axis
layout and its decode; ``encode_files_batched`` runs one analysis and
search pass over every file of a (samplerate, channels) group, its
sub-batches round-robin over the ``files`` devices;
``decode_granules_sharded`` splits one stream's granules over the
``frames`` devices, each range synthesised after a two-granule halo. All
run on the card unless the caller passes CPU devices.
"""

from mp3stego_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from mp3stego_tpu_torch.parallel.batch_decode import (  # noqa: F401
    decode_files_batched, prepare_batch, prepare_batch_concat,
)
from mp3stego_tpu_torch.parallel.batch_encode import (  # noqa: F401
    encode_files_batched,
)
from mp3stego_tpu_torch.parallel.frame_shard import (  # noqa: F401
    decode_granules_sharded,
)
