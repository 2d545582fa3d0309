"""Pipelines: the Decoder (MP3->WAV) wiring the host bitstream plane
to the torch decode plane."""

from mp3stego_tpu_torch.models.decoder import Decoder  # noqa: F401
