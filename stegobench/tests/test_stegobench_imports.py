"""The import rules: nothing in the benchmark imports JAX or the JAX
package (top-level names compared whole, since the port's name begins with
the JAX package's), the plain reference loads nothing of the port, and no
file reads the JAX package's old benchmark records."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "mp3stego_tpu"}


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    found = {(os.path.relpath(p, BENCH), n) for p in _sources()
             for n in _top_names(p) if n in BANNED}
    assert not found


def test_whole_name_comparison():
    # the port's name begins with the JAX package's and is allowed
    assert "mp3stego_tpu_torch".split(".")[0] not in BANNED
    assert "mp3stego_tpu.ops".split(".")[0] in BANNED


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r, %r]; import reference, pool, "
            "bounds, trace_math; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mp3stego_tpu_torch', 'mp3stego_tpu', 'jax'}); print(bad)"
            % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_no_file_reads_the_old_records():
    for p in _sources():
        if os.path.basename(p) == os.path.basename(__file__):
            continue
        text = open(p).read()
        assert "bench.py" not in text and "BENCH_" not in text, p
