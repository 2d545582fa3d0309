#!/usr/bin/env python3
"""Write tests/golden/huffman_golden.npz: the hand-crafted MPEG-1 stream of
linbits escapes of tests/test_torch_huffman.py (tables 23 and 24, values up
to 8,206), as the uint8 array ``linbits``.

    JAX_PLATFORMS=cpu python3 tools/gen_huffman_golden.py

The builder (tests/craft_mp3.py) imports the JAX package, which the card's
smoke run (chip_smoke.py) may not import, so that run reads the stream from
this file; tests/test_torch_huffman.py holds the file equal to what the
builder makes.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "golden", "huffman_golden.npz")


def main() -> int:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, REPO)
    import test_torch_huffman as th
    data = np.frombuffer(th._linbits_stream(), np.uint8)
    np.savez_compressed(OUT, linbits=data)
    print(f"{OUT}: linbits ({data.size} B)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
