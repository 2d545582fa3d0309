"""MP3 -> WAV decode pipeline.

API-compatible with the reference Decoder (decoder/decoder.py:9-117): same
constructor, ``decode(quiet, reveal, txt_file_path)`` returning bitrate//1000,
``delete_wav_file()``, METADATA.txt side-file when not quiet, and the exact
``len#message`` reveal framing (decoder/decoder.py:86-108).

The pipeline is the one the benchmark's decode times: the host parse
(``bitstream.decoder_host.parse_mp3``: sync walk, side info, reservoir,
scalefactors; on an MPEG-1 stream the Huffman samples are left to the card's
scan) -> numeric plane (``ops.decode_plane.decode_pcm_i16``) -> int16 WAV.
``precision`` selects "float64" (the bit-exact plane) or "float32"; both run
the torch plane on ``device``, CUDA by default (a missing card raises).
Under ``device="cpu"`` float64 runs the host C++ plane, whose bytes the
card's float64 plane equals.
"""

import os
import sys
import time

import torch

from mp3stego_tpu_torch.bitstream import decoder_host as dh
from mp3stego_tpu_torch.bitstream.id3 import parse_id3
from mp3stego_tpu_torch.ops import decode_plane as dp
from mp3stego_tpu_torch.utils.profiling import StageTimer, byte_bar, trace
from mp3stego_tpu_torch.utils.transfer import resolve_device
from mp3stego_tpu_torch.utils.wav import write_wav

PRECISIONS = ("float64", "float32")


def check_precision(precision: str, device=None) -> torch.device:
    """Validate ``precision``; return the decode plane's device: ``device``,
    or CUDA when None (a missing card raises)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return resolve_device(device)


class Decoder:
    """Decode an MP3 file into a WAV file (and optionally reveal hidden data).

    :param file_path: the mp3 file path.
    :param output_file_path: the wav output file path.
    :param precision: "float64" (bit-exact parity mode) or "float32".
    :param device: the decode plane's device; None means CUDA. "cpu" runs
        float64 on the host C++ plane and float32 on the torch CPU plane.

    ``timer`` holds the last ``decode``'s per-stage wall times; on a CUDA
    device each stage boundary waits for the card.
    """

    def __init__(self, file_path: str, output_file_path: str,
                 precision: str = "float64", device=None):
        self.__file_path = file_path
        self.__output_file_path = output_file_path
        self.__precision = precision
        self.__device = check_precision(precision, device)

        if not os.path.exists(self.__file_path):
            sys.exit(f'File {self.__file_path} not found.')

        with open(self.__file_path, 'rb') as f:
            self.__data = f.read()

        self.__id3 = parse_id3(self.__data)
        self.__offset = self.__id3.offset if self.__id3.is_valid else 0
        self.output_bits = ""
        self.timer = None

    def __parse_metadata(self):
        id3 = self.__id3
        with open('METADATA.txt', 'w') as metadata:
            metadata.write(f'METADATA FOR FILE: {self.__file_path}\n')
            metadata.write('################################\n\n\n')
            metadata.write(f'ID3 Version: {id3.version}\n')
            if len(id3.id3_flags) > 0:
                metadata.write('ID3 Flags:\n')
                for flag in id3.id3_flags:
                    metadata.write(f'- {flag}\n')
                metadata.write('\n')

            metadata.write('\nID3 Frames:\n')
            for i, frame in enumerate(id3.id3_frames):
                metadata.write(f'Frame number: {i}\n')
                metadata.write(f'Frame ID: {frame.id}\n')
                metadata.write(f'Content: {frame.content}\n')
                if len(frame.frame_flags) > 0:
                    metadata.write('Frame Flags:\n')
                    for flag in frame.frame_flags:
                        metadata.write(f'- {flag}\n')
                metadata.write('\n')

    def decode(self, quiet: bool = True, reveal: bool = False,
               txt_file_path: str = "") -> int:
        """Decode to WAV; optionally extract the hidden message to a txt file.

        :return: the bitrate of the mp3 file in kbps.
        """
        if not quiet and self.__id3.is_valid:
            self.__parse_metadata()

        dev = self.__device
        sync = (lambda: torch.cuda.synchronize(dev)) \
            if dev.type == "cuda" else None
        timer = self.timer = StageTimer(sync=sync)
        start = time.time()
        with trace():
            with timer.stage("bitstream parse (host)"):
                bar = byte_bar(len(self.__data) - self.__offset,
                               enabled=not quiet)
                parsed = dh.parse_mp3(self.__data, self.__offset,
                                      progress_cb=bar.update)
                bar.close()
            self.output_bits = dh.stego_bits(parsed)
            if parsed.header is None:
                # no sync word at all (the reference IndexErrors here)
                sys.exit(f"File {self.__file_path} is not a valid "
                         f"MP3 file.")

            if self.__precision == "float64" and dev.type == "cpu":
                with timer.stage("numeric plane (float64)"):
                    # fused native plane -> interleaved int16 (one pass);
                    # NumPy parity oracle when the toolchain is absent
                    pcm_i16 = dp.decode_pcm_i16_host(parsed)
                    if pcm_i16 is None:
                        pcm_i16 = dp.pcm_to_i16(
                            dp.decode_pcm(parsed, "float64", dev))
            else:
                # torch plane, int16 conversion in its synthesis kernel
                pcm_i16 = dp.decode_pcm_i16(parsed, dev, self.__precision,
                                            timer=timer)
        parsing_time = time.time() - start
        if not quiet:
            print('\nParsed', parsed.num_frames, 'frames in', parsing_time,
                  'seconds.')
            if parsed.vbr_tag is not None:
                self.__write_vbr_metadata(parsed)

        with timer.stage("wav write"):
            write_wav(self.__output_file_path, parsed.header.sampling_rate,
                      pcm_i16)
        if not quiet:
            timer.print_report()
        if not quiet:
            print(f"Wav file created on {self.__output_file_path}")

        if reveal:
            if txt_file_path[-4:] != '.txt':
                sys.exit("txt_file_path must be txt file.")
            self.__write_revealed(txt_file_path)

        # Xing/VBRI-tagged stream: the first header's rate is the tag
        # frame's (meaningless) one — report the tag-derived average,
        # rounded to a valid Layer III rate so hide/clear can re-encode at
        # it. Untagged streams keep exact reference behavior.
        kbps = parsed.header.bit_rate // 1000
        if parsed.skip_first_pcm and parsed.vbr_tag is not None:
            from mp3stego_tpu_torch.bitstream import vbr
            kbps = vbr.avg_bitrate_kbps(parsed.vbr_tag,
                                        parsed.header) or kbps
        return kbps

    def __write_vbr_metadata(self, parsed):
        """Append the tag frame's stream statistics to METADATA.txt
        (superset of the reference's ID3-only dump; only ever written for
        tagged streams, which the reference mis-decodes as audio)."""
        from mp3stego_tpu_torch.bitstream import vbr
        tag = parsed.vbr_tag
        mode = "a" if os.path.exists('METADATA.txt') else "w"
        with open('METADATA.txt', mode) as f:
            f.write(f'\nVBR TAG ({tag.kind.upper()}) FOR FILE: '
                    f'{self.__file_path}\n')
            f.write('################################\n\n')
            if tag.frames is not None:
                f.write(f'Frames: {tag.frames}\n')
            if tag.stream_bytes is not None:
                f.write(f'Stream bytes: {tag.stream_bytes}\n')
            avg = vbr.avg_bitrate_kbps(tag, parsed.header)
            if avg is not None:
                f.write(f'Average bitrate: {avg} kbps\n')
            if tag.quality is not None:
                f.write(f'Quality: {tag.quality}\n')
            if tag.toc is not None:
                f.write(f'Seek TOC entries: {len(tag.toc)}\n')

    def __write_revealed(self, txt_file_path: str):
        """'len#message' framing parse (decoder/decoder.py:90-108, quirks and all)."""
        output_str = ''.join(
            chr(int(''.join(x), 2)) for x in zip(*[iter(self.output_bits)] * 8))
        message_len_str = ''
        for ch in output_str:
            if ch == '#':
                break
            message_len_str += ch
        try:
            message_len = int(message_len_str)
        except Exception:
            message_len = 0
            message_len_str = ""

        if (len(message_len_str) + 1 + message_len) > len(output_str):
            output_str = output_str[len(message_len_str) + 1:]
        else:
            output_str = output_str[
                len(message_len_str) + 1: len(message_len_str) + 1 + message_len]
        with open(txt_file_path, 'wb') as f:
            f.write(bytes(output_str, 'utf-8'))

    def delete_wav_file(self):
        """Deletes the output wav file."""
        if os.path.exists(self.__output_file_path):
            os.remove(self.__output_file_path)
