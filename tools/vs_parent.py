"""Shared half of ``tools/encode_vs_parent.py`` and ``tools/decode_vs_parent.py``.

Each of them times the port's paths of a parent commit's tree and of this
checkout on one CUDA card. ``compare`` writes the inputs into a temporary
directory, runs the script's own ``--worker`` process on each tree in the
order parent, change, change, parent (each imports ``mp3stego_tpu_torch``
from its tree and prints one JSON object of ``walls_ms`` lists and ``sha``
digests), checks that the named outputs' SHA-256 are the same in all four
workers, and folds each path's walls into the median over both workers of a
tree. ``write`` saves the record and prints it with the card's
``nvidia-smi`` name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("parent", "change", "change", "parent")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def parse_args(doc: str, record: str, alone: bool = False,
               only: tuple = ()) -> argparse.Namespace:
    """--parent DIR, --change DIR (default this checkout), --out (default
    ``chiprun_out/<record>``), with ``alone`` the --alone switch, and the
    hidden worker arguments; with ``only`` (kernel names) --only KERNEL."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a copy of the parent commit's tree")
    ap.add_argument("--change", default=REPO,
                    help="the tree to hold against the parent (default: "
                         "this checkout)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  record))
    if alone:
        ap.add_argument("--alone", action="store_true",
                        help="time only the kernels alone, no path walls")
    if only:
        ap.add_argument("--only", choices=only,
                        help="with --alone, time this kernel alone only")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)
    return ap.parse_args()


def import_tree(root: str) -> None:
    """Puts the tree at ``root`` first on the path and checks that
    ``mp3stego_tpu_torch`` comes from it."""
    sys.path.insert(0, root)
    import mp3stego_tpu_torch
    if not mp3stego_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {mp3stego_tpu_torch.__file__}, not "
                           f"the tree at {root}")


def compare(script: str, args: argparse.Namespace, prepare,
            same_bytes=None) -> tuple:
    """Runs ``script``'s workers in ``ORDER`` on the inputs ``prepare(tmp)``
    writes; ``same_bytes`` (the ``sha`` keys to hold, all when None) must be
    equal in every worker. Returns (card line, the workers' records, the
    median of each path's walls per tree)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible to torch")
    card = card_line()
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        prepare(tmp)
        for which in ORDER:
            r = subprocess.run(
                [sys.executable, os.path.abspath(script), "--parent",
                 trees["parent"], "--worker", trees[which], "--tmp", tmp]
                + (["--alone"] if getattr(args, "alone", False) else [])
                + (["--only", args.only] if getattr(args, "only", None)
                   else []),
                capture_output=True, text=True, timeout=1200,
                cwd=trees[which])
            if r.returncode != 0:
                raise RuntimeError(f"{which} worker exited {r.returncode}:\n"
                                   f"{r.stdout}{r.stderr}")
            runs.append(dict(tree=which,
                             **json.loads(r.stdout.strip().splitlines()[-1])))
    keys = list(runs[0]["sha"]) if same_bytes is None else same_bytes
    for r in runs[1:]:
        for k in keys:
            if r["sha"][k] != runs[0]["sha"][k]:
                raise AssertionError(f"{k}: {r['tree']} wrote other bytes "
                                     f"than {runs[0]['tree']}")
    med = {}
    for name in runs[0]["walls_ms"]:
        for which in ("parent", "change"):
            walls = sorted(w for r in runs if r["tree"] == which
                           for w in r["walls_ms"][name])
            med.setdefault(name, {})[which] = walls[len(walls) // 2]
    return card, runs, med


def write(path: str, card: str, runs: list, med: dict, **shown) -> None:
    """Saves the record (card, torch, order, medians, ``shown``, the
    workers' records) at ``path``; prints the card and, as one JSON line,
    the medians and ``shown``."""
    import torch
    record = dict(card=card, torch=torch.__version__,
                  order=[r["tree"] for r in runs], median_ms=med, **shown,
                  runs=runs)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    print(json.dumps(dict(card=card, median_ms=med, **shown)))
