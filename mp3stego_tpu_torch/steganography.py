"""Steganography façade — the public operations.

API-compatible with the reference mp3stego.steganography (steganography.py:10-183),
including the ``reveal_massage`` spelling, the ``len#message`` framing, sys.exit
path validation, and the always-delete temporary-WAV behaviour of
hide/reveal/clear. Built on the port's Decoder and Encoder.

Beyond the reference surface, the constructor takes ``precision`` and
``device``. Every plane runs in torch on ``device``: None means CUDA, and a
missing card raises (``device="cpu"`` asks for the CPU). ``precision=
"float64"`` (default) is the bit-exact parity decode (byte-identical WAVs,
on the card as on the host C++ plane that ``device="cpu"`` runs);
``"float32"`` stays within 1 int16 LSB of it on fewer than 1e-3 of
samples. Encoding (and so hide, clear and capacity) runs the analysis and
search planes whatever the precision, with bytes identical to the JAX
package's.
"""

import os
import sys
import tempfile
from contextlib import contextmanager

from mp3stego_tpu_torch.bitstream import decoder_host as dh
from mp3stego_tpu_torch.bitstream.id3 import parse_id3, syncsafe
from mp3stego_tpu_torch.models.decoder import Decoder, check_precision
from mp3stego_tpu_torch.models.encoder import Encoder


def str_to_binary_str(string: str) -> str:
    """UTF-8 string -> MSB-first bit string (reference steganography.py:10-24)."""
    data = string.encode("utf-8")
    return "".join(format(b, "08b") for b in data)


def _frame_message(message: str) -> str:
    """Length-prefix framing used by hide: ``"{len}#{msg}"`` -> bit string."""
    return str_to_binary_str(f"{len(message)}#{message}")


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


def _wav_to_mp3_paths(wav_file_path: str, output_file_path: str):
    """Validate a (wav in, mp3 out) pair (reference steganography.py:75-78)."""
    _exists_or_exit(wav_file_path)
    if output_file_path[-4:] != '.mp3' or wav_file_path[-4:] != '.wav':
        sys.exit("wav_file_path must be wav file, output_file_path must be mp3 file.")


class Steganography:
    """Façade for encode/decode/hide/reveal/clear over MP3 files.

    :param quiet: if False, prints information about the processes and the files.
    :param precision: decode numeric plane mode — "float64" (bit-exact
        parity) or "float32".
    :param keep_id3: carry the input's leading ID3v2 tag over to the output
        of ``hide_message``/``clear_file`` (the reference's re-encode drops
        tags — reference decoder.py skips ID3 and its encoder writes bare
        frames, so the default stays off for parity). Default from
        ``MP3STEGO_TPU_KEEP_ID3``.
    :param device: the planes' device, the decoder's and the encoder's.
        None means CUDA, and a missing card raises at construction.
    """

    def __init__(self, quiet: bool = True, precision: str = "float64",
                 keep_id3: bool = None, device=None):
        self.quiet = quiet
        self.precision = precision
        self.device = check_precision(precision, device)
        self.encode_device = device
        if keep_id3 is None:
            keep_id3 = os.environ.get("MP3STEGO_TPU_KEEP_ID3", "0") == "1"
        self.keep_id3 = keep_id3
        self._last_bitrate = 0
        self._last_decoder = None
        self._last_encoder = None

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

    def _encode(self, wav_file_path, output_file_path, bitrate, hide_bits="",
                vbr=None):
        self._last_encoder = Encoder(wav_file_path, output_file_path,
                                     bitrate=bitrate, hide_str=hide_bits,
                                     vbr=vbr, device=self.encode_device)
        return self._last_encoder.encode(quiet=self.quiet)

    def _drop_temp_wav(self):
        self._last_decoder.delete_wav_file()
        if not self.quiet:
            print("Wav file has been deleted.")

    def _id3_block(self, path: str) -> bytes:
        """The file's leading ID3v2 tag bytes (header + frames + footer),
        or b"" when absent/invalid or ``keep_id3`` is off."""
        if not self.keep_id3:
            return b""
        try:
            with open(path, "rb") as f:
                head = f.read(14)
                if len(head) < 14 or head[:3] != b"ID3":
                    return b""
                f.seek(0)
                # the tag's total extent is in the first 14 bytes; read just
                # the block and re-validate through the real parser
                total = syncsafe(head[6:10]) + (20 if head[5] & 0x10 else 10)
                block = f.read(total)
        except OSError:
            return b""
        tag = parse_id3(block)
        return block if tag.is_valid and len(block) == tag.offset else b""

    def _restore_id3(self, tag_block: bytes, output_file_path: str):
        if not tag_block:
            return
        with open(output_file_path, "rb") as f:
            body = f.read()
        with open(output_file_path, "wb") as f:
            f.write(tag_block)
            f.write(body)
        if not self.quiet:
            print(f"ID3v2 tag ({len(tag_block)} bytes) carried over.")

    # ------------------------------------------------------------------- public

    def encode_wav_to_mp3(self, wav_file_path: str, output_file_path: str,
                          bitrate: int = 320, vbr: bool = None):
        """Encode a wav file into an mp3 file.

        :param wav_file_path: the wav file path.
        :param output_file_path: the output mp3 file desired path.
        :param bitrate: the bitrate of the wav file (the target average
            with ``vbr``).
        :param vbr: constant-quality VBR with a Xing tag (beyond the
            reference).
        """
        with self._banner(f"Start Encoding {wav_file_path} to  "
                          f"{output_file_path}.", "Encoding"):
            _wav_to_mp3_paths(wav_file_path, output_file_path)
            self._encode(wav_file_path, output_file_path, bitrate, vbr=vbr)

    def message_capacity(self, input_file_path: str) -> int:
        """Largest message (chars) ``hide_message`` can embed in this file.

        Beyond the reference, whose only capacity signal is the ``too_long``
        bool after a full hide. The stego channel carries one bit per
        nonzero Huffman table selection of the RE-ENCODE (reference
        MP3_Encoder.py:808-809), and the pair transform neither zeroes nor
        un-zeroes a table — so a clear re-encode's extractable bit count is
        the channel capacity. The ``"{len}#{msg}"`` framing overhead (which
        itself grows with the message length) is solved for, honouring the
        reference's off-by-one (the final usable bit never embeds —
        ``too_long`` tests ``offset < len-1``, encoder.py parity).
        """
        with self._banner(f"Start Measuring capacity of {input_file_path}.",
                          "Measuring"):
            wav_file_path = _mp3_to_wav_paths(input_file_path)
            self._decode(input_file_path, wav_file_path)
            with tempfile.NamedTemporaryFile(suffix=".mp3",
                                             delete=False) as tmp:
                tmp_mp3 = tmp.name
            try:
                self._encode(wav_file_path, tmp_mp3,
                             bitrate=self._last_bitrate)
                with open(tmp_mp3, "rb") as f:
                    usable = len(dh.stego_bits(dh.parse_mp3(f.read(), 0)))
            finally:
                os.remove(tmp_mp3)
                self._drop_temp_wav()
        # largest c with bits("{c}#{'x'*c}") - 1 <= usable - 1, i.e.
        # 8*(digits(c) + 1 + c) <= usable + 1 (off-by-one: the last framed
        # bit need not land)
        c = max(0, (usable + 1) // 8 - 1)
        while c > 0 and 8 * (len(str(c)) + 1 + c) > usable + 1:
            c -= 1
        return c

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

    def hide_message(self, input_file_path: str, output_file_path: str,
                     message: str) -> bool:
        """Hide a string in an mp3 file; returns True if it was too long to fit.

        :param input_file_path: the input mp3 file path.
        :param output_file_path: the output mp3 desired path.
        :param message: the message to hide in the mp3 file.
        """
        with self._banner(f"Start Hiding {message} in {output_file_path}.",
                          "Hiding"):
            tag = self._id3_block(input_file_path)
            wav_file_path = _mp3_to_wav_paths(input_file_path)
            self._decode(input_file_path, wav_file_path)
            _wav_to_mp3_paths(wav_file_path, output_file_path)
            too_long = self._encode(wav_file_path, output_file_path,
                                    bitrate=self._last_bitrate,
                                    hide_bits=_frame_message(message))
            self._restore_id3(tag, output_file_path)
            self._drop_temp_wav()
        return too_long

    def clear_file(self, input_file_path: str, output_file_path: str):
        """Re-encode an mp3 file without any hidden string.

        :param input_file_path: the input mp3 file path.
        :param output_file_path: the output mp3 desired path.
        """
        with self._banner(f"Start Cleaning {input_file_path} into "
                          f"{output_file_path}.", "Cleaning"):
            tag = self._id3_block(input_file_path)
            wav_file_path = _mp3_to_wav_paths(input_file_path)
            self._decode(input_file_path, wav_file_path)
            _wav_to_mp3_paths(wav_file_path, output_file_path)
            self._encode(wav_file_path, output_file_path,
                         bitrate=self._last_bitrate)
            self._restore_id3(tag, output_file_path)
            self._drop_temp_wav()
