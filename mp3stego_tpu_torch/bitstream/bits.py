"""Bit-level I/O primitives for the host bitstream plane.

``BitReader`` replaces the reference's ``util.get_bits`` (decoder/util.py:22-64,
which re-copies the whole buffer per call) with an O(1) windowed read over a
pre-unpacked bit array. ``BitWriter`` reproduces the exact 32-bit-cache
semantics of the reference encoder's ``__put_bits`` (MP3_Encoder.py:1362-1392)
so serialized MP3 bytes are bit-identical.
"""

import numpy as np

_POW2 = (1 << np.arange(63, -1, -1, dtype=np.uint64)).astype(np.uint64)


class BitReader:
    """MSB-first bit reader over a byte buffer, zero-padded past the end."""

    __slots__ = ("bits", "pos", "nbits")

    def __init__(self, data, pad_bytes: int = 8):
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
        buf = np.concatenate([buf, np.zeros(pad_bytes, dtype=np.uint8)])
        self.bits = np.unpackbits(buf)
        self.nbits = (len(buf) - pad_bytes) * 8
        self.pos = 0

    def peek(self, n: int, at: int = -1) -> int:
        p = self.pos if at < 0 else at
        sl = self.bits[p:p + n]
        if len(sl) < n:  # reads may run past even the pad (mirrors zero-padding)
            sl = np.concatenate([sl, np.zeros(n - len(sl), dtype=np.uint8)])
        return int(sl.astype(np.uint64) @ _POW2[64 - n:])

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v

    def skip(self, n: int):
        self.pos += n


class BitWriter:
    """32-bit-cache MSB-first bit writer, bit-exact vs MP3_Encoder.__put_bits.

    The cache is flushed to the byte buffer in whole 4-byte words; ``data_position``
    trails the cache, exactly like the reference's BitstreamStruct.
    """

    __slots__ = ("data", "data_position", "cache", "cache_bits")

    def __init__(self, initial_size: int = 4096):
        self.data = bytearray(initial_size)
        self.data_position = 0
        self.cache = 0
        self.cache_bits = 32

    def put(self, val: int, n: int):
        val = int(val) & 0xFFFFFFFF
        n = int(n)
        if self.cache_bits > n:
            self.cache_bits -= n
            self.cache = (self.cache | ((val << self.cache_bits) & 0xFFFFFFFF)) & 0xFFFFFFFF
        else:
            if self.data_position + 4 >= len(self.data):
                self.data.extend(b"\x00" * (len(self.data) // 2 + 8))
            n -= self.cache_bits
            self.cache = (self.cache | (val >> n)) & 0xFFFFFFFF
            self.data[self.data_position:self.data_position + 4] = self.cache.to_bytes(4, "big")
            self.data_position += 4
            self.cache_bits = 32 - n
            if n != 0:
                self.cache = (val << self.cache_bits) & 0xFFFFFFFF
            else:
                self.cache = 0

    def bits_count(self) -> int:
        return self.data_position * 8 + 32 - self.cache_bits

    def take_frame(self) -> bytes:
        """Return bytes written so far and reset the position (per-frame chunking,
        mirrors __encode_buffer_internal's written/data handoff). The cache
        carries over to the next frame exactly like the reference — bits not
        yet flushed to a whole 32-bit word are NOT included (use take_all
        for a byte-exact snapshot)."""
        out = bytes(self.data[:self.data_position])
        self.data_position = 0
        return out

    def take_all(self) -> bytes:
        """Flush the cache to the byte boundary and return every byte written.

        For standalone frame writers (tests/craft_mp3.py) that need the full
        bit-accurate output of one writer: bits_count() must be a multiple
        of 8 (put a 0-pad first). take_frame's word-granular carry semantics
        are the production-encoder contract and drop up to 3 trailing bytes
        per take — exactly the bug that silently truncated the crafted LSF
        streams' 21-byte header block."""
        n_bits = 32 - self.cache_bits
        assert (self.data_position * 8 + n_bits) % 8 == 0, "pad to byte first"
        tail = self.cache.to_bytes(4, "big")[:n_bits // 8]
        out = bytes(self.data[:self.data_position]) + tail
        self.data_position = 0
        self.cache = 0
        self.cache_bits = 32
        return out
