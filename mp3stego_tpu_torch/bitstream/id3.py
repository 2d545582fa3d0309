"""ID3v2 parser (host plane).

Behavioural reference: the reference's mp3stego/decoder/ID3_Parser.py:85-193 and
decoder/util.py:6-19 (7-bit syncsafe integers). Produces the audio start offset
plus the metadata needed for the METADATA.txt dump (decoder/decoder.py:37-57).
"""

from dataclasses import dataclass, field

_ID3_FLAG_NAMES = ["FooterPresent", "ExperimentalIndicator", "ExtendedHeader",
                   "Unsynchronisation"]
_FRAME_FLAG_NAMES = ["DiscardFrameOnTagAlter", "DiscradFrameOnFileAlter", "ReadOnly",
                     "ZLIBCompression", "FrameEncrypted",
                     "FrameContainsGroupInformation"]


def syncsafe(four: bytes) -> int:
    num = 0
    for b in four[:4]:
        num = (num << 7) + b
    return num


@dataclass
class ID3Frame:
    frame_id: str = ""
    flags_raw: int = 0
    content_bytes: bytes = b""

    @property
    def id(self):
        return self.frame_id

    @property
    def content(self):
        try:
            return self.content_bytes.decode("utf-8")
        except Exception:
            return self.content_bytes

    @property
    def frame_flags(self):
        flags = []
        bits = [self.flags_raw >> b & 1 for b in range(3)] + \
               [self.flags_raw >> b & 1 for b in range(8, 11)]
        for i, on in enumerate(bits):
            if on:
                flags.append(_FRAME_FLAG_NAMES[i])
        return flags


@dataclass
class ID3:
    is_valid: bool = False
    offset: int = 0
    version: str = ""
    flags: tuple = (False, False, False, False)
    extended_header_size: int = 0
    id3_frames: list = field(default_factory=list)

    @property
    def id3_flags(self):
        return [_ID3_FLAG_NAMES[i] for i, on in enumerate(self.flags) if on]


def parse_id3(buffer: bytes) -> ID3:
    tag = ID3()
    if len(buffer) < 14 or buffer[:3] != b"ID3":
        return tag
    tag.version = f"2.{buffer[3]}.{buffer[4]}"
    flags = buffer[5]
    for bit in range(4):  # protected bits must be clear
        if (flags >> bit) & 1:
            return tag
    tag.flags = tuple(bool((flags >> b) & 1) for b in range(4, 8))
    tag.is_valid = True
    size = syncsafe(buffer[6:10])
    tag.offset = size + (20 if tag.flags[0] else 10)
    tag.extended_header_size = syncsafe(buffer[10:14]) if tag.flags[2] else 0

    start = 10 + tag.extended_header_size
    footer_size = 10 if tag.flags[0] else 0
    limit = tag.offset - tag.extended_header_size - footer_size
    i = 0
    while i < limit:
        fid = buffer[start + i:start + i + 4]
        if len(fid) < 4 or not all(chr(c).isupper() or chr(c).isdigit() for c in fid):
            break
        i += 4
        field_size = syncsafe(buffer[start + i:start + i + 4])
        i += 4
        fflags = int.from_bytes(buffer[start + i:start + i + 2], "big")
        i += 2
        content = bytes(buffer[start + i:start + i + field_size])
        i += field_size
        tag.id3_frames.append(ID3Frame("".join(chr(c) for c in fid), fflags, content))
    return tag
