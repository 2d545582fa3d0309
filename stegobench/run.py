"""Run one cell of the benchmark once and print its result line.

    python3 stegobench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Set-up (imports, the inputs made from the seed, the kernels loaded or
built, one warm request of each input), then the measured window, then the
check against the plain reference. The last line of standard output is the
result as JSON; the compared numbers, each beside its limit, are the last
lines of standard error. Without a CUDA card, or without the program in
the checkout, it exits with code 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import core
    try:
        if not os.path.isdir(os.path.join(ROOT, "mp3stego_tpu_torch")):
            raise core.Refused("the program (mp3stego_tpu_torch) is not in "
                               f"the checkout at {ROOT}")
        result = core.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_setup=T0)
    except core.Refused as e:
        print(f"stegobench: refused: {e}", file=sys.stderr)
        return 2
    print(core.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
