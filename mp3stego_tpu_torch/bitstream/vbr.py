"""Xing/Info/VBRI tag-frame detection (beyond-reference real-world compat).

Most VBR (and many CBR) MP3 files in the wild start with a metadata frame
written by the encoder: a valid, silent MP3 frame whose main-data region
carries a "Xing"/"Info" (LAME/Fraunhofer) or "VBRI" (Fraunhofer) tag with
the stream's total frame count, byte count, a 100-point seek TOC and a
quality indicator. Real decoders skip this frame; the reference
(MP3_Parser.py walks every synced frame) decodes it as ~1152 samples of
silence and reports the tag frame's (meaningless) header bitrate.

This framework detects the tag, drops its silence from the PCM output, and
reports the tag-derived average bitrate for VBR streams.
``MP3STEGO_TPU_KEEP_TAG_FRAME=1`` restores reference behavior (tag frame
decoded as audio, header bitrate reported). Detection requires an exact
fourcc at the version/channel-dependent offset AND an all-zero side-info
block, so an audio frame cannot false-positive.
"""

import os
import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["VbrTag", "parse_vbr_tag", "keep_tag_frame", "avg_bitrate_kbps"]


@dataclass(frozen=True)
class VbrTag:
    kind: str                      # "xing" | "info" | "vbri"
    frames: "int | None"           # total audio frames in the stream
    stream_bytes: "int | None"     # total stream bytes (incl. the tag frame)
    toc: "np.ndarray | None"       # 100-point (Xing) / table (VBRI) seek TOC
    quality: "int | None"


def keep_tag_frame() -> bool:
    """Reference-parity mode: decode the tag frame as audio."""
    return os.environ.get("MP3STEGO_TPU_KEEP_TAG_FRAME") == "1"


def _side_info_bytes(h) -> int:
    """ISO 11172-3/13818-3 side-info block size (bytes) for Layer III."""
    if h.mpeg_version == 1:
        return 32 if h.channels == 2 else 17
    return 17 if h.channels == 2 else 9


def parse_vbr_tag(data: bytes, offset: int = 0):
    """Return the stream's VbrTag if frame 0 at ``offset`` is a tag frame.

    Layouts: Xing/Info sits right after the side info ("Xing" marks VBR,
    "Info" marks CBR — both are tag frames), followed by a u32 flag word
    (1=frames, 2=bytes, 4=toc[100], 8=quality) and the selected fields, all
    big-endian. VBRI sits at a fixed 32 bytes past the header: version,
    delay, quality (u16), bytes, frames (u32), then a seek table. A tag
    frame's side info is all zero bytes (no main data, main_data_begin=0);
    that is required here so Huffman data of a real first frame can never
    alias into a detection.
    """
    from mp3stego_tpu_torch.bitstream.decoder_host import (HEADER_SIZE,
                                                     frame_size_of,
                                                     parse_header)

    n = len(data)
    if (offset + HEADER_SIZE > n or data[offset] != 0xFF
            or data[offset + 1] < 0xE0):
        return None
    h = parse_header(*data[offset:offset + 4])
    size = frame_size_of(h)
    if size <= 0 or h.layer != 3:
        return None
    end = min(offset + size, n)
    si = _side_info_bytes(h)

    # ---- Xing / Info: right after the side-info block
    pos = offset + 4 + si
    if pos + 8 <= end and data[pos:pos + 4] in (b"Xing", b"Info"):
        if any(data[offset + 4:offset + 4 + si]):
            return None   # real audio frame that happens to contain the fourcc
        kind = "xing" if data[pos:pos + 4] == b"Xing" else "info"
        (flags,) = struct.unpack_from(">I", data, pos + 4)
        cur = pos + 8
        frames = stream_bytes = quality = None
        toc = None
        if flags & 1 and cur + 4 <= end:
            (frames,) = struct.unpack_from(">I", data, cur)
            cur += 4
        if flags & 2 and cur + 4 <= end:
            (stream_bytes,) = struct.unpack_from(">I", data, cur)
            cur += 4
        if flags & 4 and cur + 100 <= end:
            toc = np.frombuffer(data[cur:cur + 100], dtype=np.uint8).copy()
            cur += 100
        if flags & 8 and cur + 4 <= end:
            (quality,) = struct.unpack_from(">I", data, cur)
        return VbrTag(kind, frames, stream_bytes, toc, quality)

    # ---- VBRI: fixed 32 bytes past the header
    pos = offset + 4 + 32
    if pos + 26 <= end and data[pos:pos + 4] == b"VBRI":
        if any(data[offset + 4:offset + 4 + si]):
            return None
        _ver, _delay, quality = struct.unpack_from(">HHH", data, pos + 4)
        (stream_bytes,) = struct.unpack_from(">I", data, pos + 10)
        (frames,) = struct.unpack_from(">I", data, pos + 14)
        entries, scale, esize, eframes = struct.unpack_from(
            ">HHHH", data, pos + 18)
        toc = None
        if esize in (1, 2, 4) and pos + 26 + entries * esize <= end:
            fmt = {1: "B", 2: "H", 4: "I"}[esize]
            raw = struct.unpack_from(f">{entries}{fmt}", data, pos + 26)
            toc = np.asarray(raw, dtype=np.int64) * scale
            _ = eframes
        return VbrTag("vbri", frames, stream_bytes, toc, quality)
    return None


def avg_bitrate_kbps(tag: VbrTag, h) -> "int | None":
    """Tag-derived average bitrate, rounded to the nearest valid Layer III
    rate for this MPEG version (so a re-encode at the reported rate is
    always representable). None when the tag lacks frames or bytes."""
    if not tag or not tag.frames or not tag.stream_bytes:
        return None
    from mp3stego_tpu_torch import tables as T

    spf = 1152 if h.mpeg_version == 1 else 576
    seconds = tag.frames * spf / h.sampling_rate
    kbps = tag.stream_bytes * 8.0 / seconds / 1000.0
    # BIT_RATES columns are indexed by the 2-bit header version code:
    # MPEG-1 -> 3, MPEG-2 -> 2, MPEG-2.5 -> 0
    col = {1.0: 3, 2.0: 2, 2.5: 0}.get(float(h.mpeg_version))
    if col is None:
        return None
    valid = [int(r[col]) for r in T.BIT_RATES if int(r[col]) > 0]
    return min(valid, key=lambda r: abs(r - kbps))
