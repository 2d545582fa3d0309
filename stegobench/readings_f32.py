"""The readings ``song320.decode_f32``'s limits are set from, in one process
on the card: the cell as it stands on many seeds (the lower reading of each
compared number is the largest of these), then its control, the plain
reference computed in bfloat16 in place of the program (``kinds/decode_f32``,
``control``), on a few more (the upper reading is the smallest of those).
Each run is a whole run of the cell at its own size, with a short window.

    python3 stegobench/readings_f32.py --seeds 12 --control-seeds 3 \
        --seconds 3

Prints one JSON line a run and, last, the readings of each compared
number.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import core  # noqa: E402

CELL = "song320.decode_f32"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=7_100_000_001)
    ap.add_argument("--control", default="bfloat16")
    args = ap.parse_args(argv)
    runs = [(args.first_seed + k, None) for k in range(args.seeds)] + [
        (args.first_seed + 1000 + k, args.control)
        for k in range(args.control_seeds)]
    seen = {"program": {}, "control": {}}
    for seed, control in runs:
        over = {"control": control} if control else None
        r = core.run_cell(CELL, seed, args.seconds, False, overrides=over,
                          log=lambda m: None)
        side = "control" if control else "program"
        print(json.dumps(dict(side=side, seed=seed, correct=r["correct"],
                              attempted=r["attempted"], failed=r["failed"],
                              checks=r["checks"])), flush=True)
        for k, c in r["checks"].items():
            seen[side].setdefault(k, []).append(c["value"])
    print(json.dumps(dict(
        workload=CELL,
        lower={k: max(v) for k, v in seen["program"].items()},
        upper={k: min(v) for k, v in seen["control"].items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
