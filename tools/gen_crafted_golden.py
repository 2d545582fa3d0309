#!/usr/bin/env python3
"""Write tests/golden/crafted_golden.npz: the hand-crafted MP3 streams of
tests/test_torch_crafted.py (intensity stereo in MPEG-1 and LSF, long and
short, with and without MS; ISO mixed blocks at 44.1 kHz; the 8 kHz mixed
middle region), one uint8 array per stream name.

    JAX_PLATFORMS=cpu python3 tools/gen_crafted_golden.py

The builder (tests/craft_mp3.py) imports the JAX package, which the card's
smoke run (chip_smoke.py) may not import, so that run reads the streams from
this file; tests/test_torch_crafted.py holds the file equal to what the
builder makes.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "golden", "crafted_golden.npz")


def main() -> int:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, REPO)
    import test_torch_crafted as tc
    streams = {name: np.frombuffer(build(), np.uint8)
               for name, build in tc.STREAMS.items()}
    np.savez_compressed(OUT, **streams)
    print(f"{OUT}: {', '.join(f'{k} ({v.size} B)' for k, v in streams.items())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
