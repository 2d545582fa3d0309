"""WAV read/write.

Writing matches scipy.io.wavfile bytes (the reference writes via scipy,
MP3_Parser.py:91). Reading replicates the reference WavReader's RIFF walk and
constraints (encoder/WAV_Reader.py:30-118): PCM only, 32/44.1/48 kHz, 8/16/32-bit
declared sizes but samples always loaded as int16, and the interleaved two-cursor
buffer addressing used by the encoder's sample feeder.
"""

import struct
import sys
from dataclasses import dataclass, field

import numpy as np


def wav_header(rate: int, channels: int, payload_bytes: int,
               bits: int = 16) -> bytes:
    """The 44-byte PCM WAV header (scipy.io.wavfile layout) for a payload of
    known size — shared by write_wav and the streaming decoder."""
    block_align = channels * (bits // 8)
    return (b"RIFF" + struct.pack("<I", 36 + payload_bytes) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, rate,
                                    rate * block_align, block_align, bits)
            + b"data" + struct.pack("<I", payload_bytes))


def write_wav(path: str, rate: int, data: np.ndarray):
    """Minimal PCM WAV writer, byte-identical to scipy.io.wavfile.write for
    int16 input."""
    data = np.asarray(data)
    channels = 1 if data.ndim == 1 else data.shape[1]
    payload = data.tobytes()
    with open(path, "wb") as f:
        f.write(wav_header(rate, channels, len(payload),
                           bits=data.dtype.itemsize * 8))
        f.write(payload)


@dataclass
class WavFile:
    file_path: str = ""
    bitrate: int = 320
    num_of_channels: int = 2
    samplerate: int = 44100
    bits_per_sample: int = 16
    num_of_samples: int = 0
    mpeg_mode: int = 0          # 0 stereo / 3 mono (encoder MODES)
    emphasis: int = 0
    copyright: int = 0
    original: int = 1
    buffer: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int16))


def read_wav(path: str, bitrate: int = 320,
             use_mmap: bool = False) -> WavFile:
    """Parse a PCM WAV into a WavFile. ``use_mmap=True`` maps the sample
    region instead of loading it (O(1) memory for the streaming encoder;
    consumers already zero-pad short reads, so the missing tail padding of
    a truncated file behaves identically)."""
    with open(path, "rb") as f:
        header = f.read(128)
        w = WavFile(file_path=path, bitrate=bitrate)

        idx = header.find(b"RIFF")
        if idx == -1:
            sys.exit("Bad WAVE file.")
        if header.find(b"WAVE") == -1:
            sys.exit("Bad WAVE file.")
        idx = header.find(b"fmt ")
        if idx == -1:
            sys.exit("Bad WAVE file.")
        idx += 4
        sub1 = struct.unpack("<I", header[idx:idx + 4])[0]
        if sub1 != 16:
            sys.exit("Unsupported WAVE file, compression used instead of PCM.")
        idx += 4
        fmt = struct.unpack("<H", header[idx:idx + 2])[0]
        if fmt != 1:
            sys.exit("Unsupported WAVE file, compression used instead of PCM.")
        idx += 2
        w.num_of_channels = struct.unpack("<H", header[idx:idx + 2])[0]
        w.mpeg_mode = 0 if w.num_of_channels > 1 else 3
        idx += 2
        w.samplerate = struct.unpack("<I", header[idx:idx + 4])[0]
        # Deliberate superset of the reference (WAV_Reader.py:68 admits only
        # the MPEG-1 rates): all nine Layer III samplerates are accepted —
        # the encoder's MPEG-2/2.5 branches are golden-tested and otherwise
        # unreachable through files (see PARITY.md deviations).
        if w.samplerate not in (32000, 44100, 48000,          # MPEG-1
                                16000, 22050, 24000,          # MPEG-2
                                8000, 11025, 12000):          # MPEG-2.5
            sys.exit("Unsupported sampling frequency.")
        idx += 4 + 4 + 2  # byte rate, block align
        w.bits_per_sample = struct.unpack("<H", header[idx:idx + 2])[0]
        if w.bits_per_sample not in (8, 16, 32):
            sys.exit("Unsupported WAVE file, samples not int8, int16 or int32 type.")
        idx = header.find(b"data")
        if idx == -1:
            sys.exit("Bad WAVE file.")
        idx += 4
        sub2 = struct.unpack("<I", header[idx:idx + 4])[0]
        w.num_of_samples = int(sub2 * 8 / w.bits_per_sample / w.num_of_channels)

        f.seek(idx + 4)
        want = w.num_of_samples * w.num_of_channels * 2  # WAV_Reader.py:108 over-asks
        if use_mmap:
            data_off = f.tell()
            f.seek(0, 2)
            avail = max(0, (f.tell() - data_off) // 2)
            n_map = min(want, avail)
            buf = (np.memmap(path, dtype=np.int16, mode="r",
                             offset=data_off, shape=(n_map,))
                   if n_map else np.zeros(0, np.int16))
        else:
            buf = np.fromfile(f, dtype=np.int16, count=want)
    # zero-pad so the encoder's two-cursor stepping never runs off the end
    if not use_mmap and len(buf) < want:
        buf = np.concatenate([buf, np.zeros(want - len(buf), dtype=np.int16)])
    w.buffer = buf

    # bitrate/samplerate index validation, in the reference's order: bitrate
    # FIRST, with the MPEG version derived from the (possibly -1) samplerate
    # index exactly like find_mpeg_version (WAV_Reader.py:27-28, util.py:110)
    from mp3stego_tpu_torch import tables as T
    sr_idx = next((i for i in range(9)
                   if w.samplerate == int(T.SAMPLE_RATES[i])), -1)
    version = 3 if sr_idx < 3 else (2 if sr_idx < 6 else 0)
    if not any(bitrate == int(T.BIT_RATES[i][version]) for i in range(16)):
        sys.exit("Unsupported bitrate configuration.")
    if sr_idx < 0:
        sys.exit("Unsupported samplerate configuration.")
    return w
