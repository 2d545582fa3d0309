"""Steganography façade — decode and reveal.

API-compatible with the reference mp3stego.steganography (steganography.py:10-183),
including the ``reveal_massage`` spelling, sys.exit path validation, and the
always-delete temporary-WAV behaviour of reveal. Built on the port's Decoder.

Beyond the reference surface, the constructor takes ``precision`` and
``device``: ``"float64"`` (default) is the bit-exact parity mode (the host
C++/NumPy plane, byte-identical WAVs); ``"float32"`` runs the decode plane in
torch on ``device`` (CUDA when None; a missing card raises), within 1 int16
LSB of the parity mode on fewer than 1e-3 of samples.

Encoding, hiding, clearing and capacity need the encoder, which is not
ported yet: those methods raise ``NotImplementedError``.
"""

import os
import sys
from contextlib import contextmanager

from mp3stego_tpu_torch.models.decoder import Decoder, check_precision

_NEEDS_ENCODER = ("needs the encoder, which the torch port does not have yet "
                  "(ROADMAP.md queue 1, item {item}); use mp3stego_tpu")


def str_to_binary_str(string: str) -> str:
    """UTF-8 string -> MSB-first bit string (reference steganography.py:10-24)."""
    data = string.encode("utf-8")
    return "".join(format(b, "08b") for b in data)


def _exists_or_exit(path: str):
    if not os.path.exists(path):
        sys.exit(f'File {path} not found.')


def _mp3_to_wav_paths(input_file_path: str, wav_file_path: str = "") -> str:
    """Validate an (mp3 in, wav out) pair; derive the default wav path.

    Same checks, messages and default (``input[:-4] + ".wav"``) as the
    reference (steganography.py:65-73).
    """
    _exists_or_exit(input_file_path)
    if wav_file_path == '':
        wav_file_path = input_file_path[:-4] + ".wav"
    if input_file_path[-4:] != '.mp3' or wav_file_path[-4:] != '.wav':
        sys.exit("input_file_path must be mp3 file, wav_file_path must be wav file.")
    return wav_file_path


class Steganography:
    """Façade for decode/reveal over MP3 files.

    :param quiet: if False, prints information about the processes and the files.
    :param precision: decode numeric plane mode — "float64" (bit-exact parity,
        host) or "float32" (torch plane on ``device``).
    :param keep_id3: accepted for API parity with ``mp3stego_tpu``; it only
        affects hide/clear, which are not ported. Default from
        ``MP3STEGO_TPU_KEEP_ID3``.
    :param device: the float32 plane's device; None means CUDA, and a missing
        card raises here rather than running on the CPU.
    """

    def __init__(self, quiet: bool = True, precision: str = "float64",
                 keep_id3: bool = None, device=None):
        self.quiet = quiet
        self.precision = precision
        self.device = check_precision(precision, device)
        if keep_id3 is None:
            keep_id3 = os.environ.get("MP3STEGO_TPU_KEEP_ID3", "0") == "1"
        self.keep_id3 = keep_id3
        self._last_bitrate = 0
        self._last_decoder = None

    @contextmanager
    def _banner(self, start: str, finish: str):
        """The reference's Start/Finished framing prints, quiet-gated."""
        if not self.quiet:
            print(f"\n##################\n{start}")
        yield
        if not self.quiet:
            print(f"\nFinished {finish}.\n##################")

    def _decode(self, input_file_path, wav_file_path, reveal=False,
                txt_file_path=""):
        self._last_decoder = Decoder(input_file_path, wav_file_path,
                                     precision=self.precision,
                                     device=self.device)
        self._last_bitrate = self._last_decoder.decode(
            self.quiet, reveal=reveal, txt_file_path=txt_file_path)

    def _drop_temp_wav(self):
        self._last_decoder.delete_wav_file()
        if not self.quiet:
            print("Wav file has been deleted.")

    # ------------------------------------------------------------------- public

    def decode_mp3_to_wav(self, input_file_path: str, wav_file_path: str = "") -> int:
        """Decode an mp3 file into a wav file; returns the bitrate in kbps.

        :param input_file_path: the input mp3 file path.
        :param wav_file_path: the output wav file desired path.
        """
        with self._banner(f"Start Decoding {input_file_path} to  "
                          f"{wav_file_path}.", "Decoding"):
            wav_file_path = _mp3_to_wav_paths(input_file_path, wav_file_path)
            self._decode(input_file_path, wav_file_path)
        return self._last_bitrate

    def reveal_massage(self, input_file_path: str, txt_file_path: str):
        """Reveal a hidden string from an mp3 file into a txt file.

        :param input_file_path: the input mp3 file path.
        :param txt_file_path: the output txt file desired path.
        """
        with self._banner(f"Start Revealing hidden message in "
                          f"{input_file_path} to  {txt_file_path}.", "Revealing"):
            wav_file_path = _mp3_to_wav_paths(input_file_path)
            if txt_file_path[-4:] != '.txt':
                sys.exit("txt_file_path must be txt file.")
            self._decode(input_file_path, wav_file_path, reveal=True,
                         txt_file_path=txt_file_path)
            self._drop_temp_wav()

    def encode_wav_to_mp3(self, wav_file_path: str, output_file_path: str,
                          bitrate: int = 320, vbr: bool = None):
        """Not ported yet: raises ``NotImplementedError``."""
        raise NotImplementedError("encode_wav_to_mp3 "
                                  + _NEEDS_ENCODER.format(item=6))

    def hide_message(self, input_file_path: str, output_file_path: str,
                     message: str) -> bool:
        """Not ported yet: raises ``NotImplementedError``."""
        raise NotImplementedError("hide_message "
                                  + _NEEDS_ENCODER.format(item=6))

    def clear_file(self, input_file_path: str, output_file_path: str):
        """Not ported yet: raises ``NotImplementedError``."""
        raise NotImplementedError("clear_file " + _NEEDS_ENCODER.format(item=6))

    def message_capacity(self, input_file_path: str) -> int:
        """Not ported yet: raises ``NotImplementedError``."""
        raise NotImplementedError("message_capacity "
                                  + _NEEDS_ENCODER.format(item=6))
