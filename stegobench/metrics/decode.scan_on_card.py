"""decode.scan_on_card: the share of the decoded frames whose Huffman
samples the card scanned, in %: 100 x the frames of the program's spans
``samples.device`` (``ops/decode_plane.scan_samples``, the scan of
``csrc/huffman.cu``) over those and the frames of its spans ``parse.fill``
(``bitstream/decoder_host``, a host fill of a parse whose samples were
deferred), over the traced requests; None where neither span is there.
Moves ``xrt``."""

import program_spans

UNIT = "%"
MOVES = "xrt"


def read(run):
    got = program_spans.of(run)
    if got is None:
        return None
    frames = {"samples.device": 0, "parse.fill": 0}
    seen = False
    for s in got:
        if s.name in frames:
            seen = True
            frames[s.name] += s.counts.get("frames", 0)
    total = sum(frames.values())
    if not seen or total <= 0:
        return None
    return 100.0 * frames["samples.device"] / total
