"""Pipelines: the Decoder (MP3->WAV) wiring the host bitstream plane to the
torch decode plane, and the Encoder (WAV->MP3, hide) wiring the torch
analysis and search planes to the host rate-control carries."""

from mp3stego_tpu_torch.models.decoder import Decoder  # noqa: F401
from mp3stego_tpu_torch.models.encoder import Encoder  # noqa: F401
