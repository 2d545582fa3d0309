"""The torch port imports, decodes (with either Huffman engine), encodes and
hides, and runs its batched, streaming, VBR and CLI entry points, with JAX
and the JAX package refused.

A fresh interpreter installs a ``sys.meta_path`` finder that refuses the
top-level names ``jax``, ``jaxlib`` and ``mp3stego_tpu`` (exact match:
``mp3stego_tpu_torch`` starts with ``mp3stego_tpu``), then imports the port,
decodes a golden stego file with the torch plane on the CPU, re-encodes the
golden WAV and hides a message with the torch planes on the CPU, then
drives the batched decode and encode, the streaming decode and encode and a
VBR encode through the CLI.

The port also keeps its own copies of the JAX package's data files (the
constant pack and the C++ host sources): they are held byte for byte equal
to the originals, and no module of the port (nor ``chip_smoke.py``) builds
a path into the JAX package's directory.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib.abc, os, sys, tempfile

BLOCKED = ("jax", "jaxlib", "mp3stego_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]

import numpy as np
from mp3stego_tpu_torch import Steganography

gold = np.load(os.path.join("tests", "golden", "stego_golden.npz"))
with tempfile.TemporaryDirectory() as tmp:
    mp3 = os.path.join(tmp, "h.mp3")
    with open(mp3, "wb") as f:
        f.write(gold["hidden_short"].tobytes())
    s = Steganography(quiet=True, precision="float32", device="cpu")
    assert s.decode_mp3_to_wav(mp3, os.path.join(tmp, "h.wav")) == 320
    s.reveal_massage(mp3, os.path.join(tmp, "h.txt"))
    with open(os.path.join(tmp, "h.txt")) as f:
        assert f.read() == "ddd"
    wav = os.path.join(tmp, "g.wav")
    with open(wav, "wb") as f:
        f.write(gold["wav_bytes"].tobytes())
    s.encode_wav_to_mp3(wav, os.path.join(tmp, "e.mp3"))
    enc = np.load(os.path.join("tests", "golden", "encode_golden.npz"))
    with open(os.path.join(tmp, "e.mp3"), "rb") as f:
        assert f.read() == enc["mp3_bytes"].tobytes()
    assert s.hide_message(mp3, os.path.join(tmp, "h2.mp3"), "no jax") is False
    s.reveal_massage(os.path.join(tmp, "h2.mp3"), os.path.join(tmp, "h2.txt"))
    with open(os.path.join(tmp, "h2.txt")) as f:
        assert f.read() == "no jax"
    # the batched, VBR, streaming and CLI entry points
    from mp3stego_tpu_torch.__main__ import main
    from mp3stego_tpu_torch.models.streaming import (
        decode_file_streaming, encode_file_streaming)
    from mp3stego_tpu_torch.parallel import (
        decode_files_batched, encode_files_batched)
    pcm = decode_files_batched([mp3, mp3], device="cpu", chunk_files=1)
    assert len(pcm) == 2 and pcm[0].shape == pcm[1].shape
    info = decode_file_streaming(mp3, os.path.join(tmp, "s.wav"), 9,
                                 device="cpu")
    assert info["bitrate"] == 320
    outs = encode_files_batched([(wav, os.path.join(tmp, "b.mp3"))],
                                device="cpu")
    with open(outs[0], "rb") as f:
        assert f.read() == enc["mp3_bytes"].tobytes()
    encode_file_streaming(wav, os.path.join(tmp, "st.mp3"), chunk_frames=5,
                          device="cpu")
    with open(os.path.join(tmp, "st.mp3"), "rb") as f:
        assert f.read() == enc["mp3_bytes"].tobytes()
    # the scan route: the light parse, then the scan's plain version (the
    # scan runs on a card only; a fake of scan_lanes lets it run here)
    from mp3stego_tpu_torch.bitstream.decoder_host import parse_mp3
    from mp3stego_tpu_torch.ops import decode_plane, huffman_device
    from mp3stego_tpu_torch.utils.wav import write_wav
    on_card = decode_plane.scan_lanes
    decode_plane.scan_lanes = lambda p, device: p.lanes
    with open(mp3, "rb") as f:
        p = parse_mp3(f.read())
    before = huffman_device.launches
    write_wav(os.path.join(tmp, "dh.wav"), p.header.sampling_rate,
              decode_plane.decode_pcm_i16(p, "cpu", "float32"))
    decode_plane.scan_lanes = on_card
    assert huffman_device.launches == before
    assert p.lanes is None or p.samples_pending     # scanned, not filled
    s.decode_mp3_to_wav(mp3, os.path.join(tmp, "h32.wav"))
    with open(os.path.join(tmp, "dh.wav"), "rb") as a, \
            open(os.path.join(tmp, "h32.wav"), "rb") as b:
        assert a.read() == b.read()
    assert main(["--device", "cpu", "encode", wav, os.path.join(tmp, "v.mp3"),
                 "--bitrate", "128", "--vbr"]) == 0
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("NO_JAX_OK")
"""


def test_port_imports_and_decodes_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"     # see tests/test_torch_encoder.py
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout



# the port's copies of the JAX package's files: (copy, original)
COPIES = [("mp3stego_tpu_torch/tables/iso_tables.npz",
           "mp3stego_tpu/tables/iso_tables.npz")] + [
    (f"mp3stego_tpu_torch/native/src/{f}", f"mp3stego_tpu/native/src/{f}")
    for f in ("decode_plane_f64.cpp", "encode_plane.cpp", "mp3_parse.cpp",
              "mp3_serialize.cpp", "rate_search.cpp", "raw_pack.cpp")]


@pytest.mark.parametrize("copy,original", COPIES,
                         ids=[os.path.basename(c) for c, _ in COPIES])
def test_port_copy_equals_jax_package_file(copy, original):
    with open(os.path.join(REPO, copy), "rb") as a, \
            open(os.path.join(REPO, original), "rb") as b:
        assert a.read() == b.read(), f"{copy} drifted from {original}"


def test_port_copies_every_native_source():
    src = os.path.join(REPO, "mp3stego_tpu", "native", "src")
    want = sorted(f for f in os.listdir(src) if f.endswith(".cpp"))
    assert [os.path.basename(c) for c, _ in COPIES[1:]] == want


def test_port_builds_no_path_into_the_jax_package():
    """No module of the port, and not chip_smoke.py, names the JAX
    package's directory in a string (a path built from it)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mp3stego_tpu_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cpp"))]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            text = f.read()
        for quoted in ('"mp3stego_tpu"', "'mp3stego_tpu'"):
            assert quoted not in text, f"{path} names {quoted}"
        # "mp3stego_tpu/..." may name a kernel's origin in a record, never a
        # file that is opened, loaded or joined
        for line in text.splitlines():
            if "mp3stego_tpu/" in line:
                assert not any(call in line for call in
                               ("open(", "load(", "join(", "Path(")), line


# public functions of the JAX package whose port has another name or lives
# in another module: (JAX module, name) -> (port module, name)
COUNTERPARTS = {
    ("ops/decode_plane.py", "decode_granules_impl"):
        ("ops/decode_plane.py", "decode_granules"),
    ("ops/encode_plane.py", "analysis_mdct_i16"):
        ("ops/encode_plane.py", "analysis_interleaved"),
    ("ops/encode_plane.py", "run_analysis"):
        ("ops/encode_plane.py", "analysis_stream"),
    ("ops/huffman_device.py", "decode_pcm_device"):
        ("ops/decode_plane.py", "decode_pcm"),
    ("ops/huffman_device.py", "decode_pcm_i16_device"):
        ("ops/decode_plane.py", "decode_pcm_i16"),
    ("ops/huffman_device.py", "decode_samples_device"):
        ("ops/huffman_device.py", "decode_samples"),
    ("ops/huffman_device.py", "pack_descriptors"):
        ("ops/huffman_device.py", "pack"),
    ("ops/pallas_kernels.py", "available"): ("ops/_cuda.py", "load"),
    ("ops/pallas_kernels.py", "synth_fir_host"):
        ("ops/synth.py", "synth_fused"),
}
# public functions the port does not have, each with the line of
# ROADMAP.md's "Not to port" list that says why
_LOGS = ("the float32 quantize with its logs and host re-check "
         "(`FLAG_LOGOVF`, `FLAG_FINAL_APPROX`, `FLAG_IXBAND`, "
         "`log_steps`/`log_bits`, `fetch_rows_logs`, "
         "`quant_np.verify_cells*`);")
_WIRE = "the int8 `ix` wire plane (`dense_ix`, `fetch_rows`);"
_FIXPOINT = ("the re-pinning hide fixpoint and `_encode_hide_hybrid` "
             "(`search_hide_fused`, `search_single_fused`, `search_batch`);")
NOT_TO_PORT = {
    ("ops/quant_np.py", "verify_cells"): _LOGS,
    ("ops/quant_np.py", "verify_cells_hide"): _LOGS,
    ("ops/quant_np.py", "verify_cells_hide_loop"): _LOGS,
    ("ops/quant_np.py", "verify_cells_loop"): _LOGS,
    ("ops/search_plane.py", "fetch_rows_logs"): _LOGS,
    ("ops/search_plane.py", "dense_ix"): _WIRE,
    ("ops/search_plane.py", "fetch_rows"): _WIRE,
    ("ops/search_plane.py", "search_batch"): _FIXPOINT,
    ("ops/search_plane.py", "search_hide_fused"): _FIXPOINT,
    ("ops/search_plane.py", "search_single_fused"): _FIXPOINT,
    ("utils/calibrate.py", "device_usable"):
        "`calibrate.device_usable`: the port has no host route for a "
        "missing card (it raises, as `resolve_device` does);",
}


def _public(package: str) -> dict:
    """{module path: public top-level function and class names}, read from
    the sources (nothing is imported)."""
    import ast
    root = os.path.join(REPO, package)
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(d, n)
                with open(path) as f:
                    tree = ast.parse(f.read())
                out[os.path.relpath(path, root)] = {
                    node.name for node in tree.body
                    if isinstance(node, (ast.FunctionDef, ast.ClassDef))
                    and not node.name.startswith("_")}
    return out


def test_every_public_function_of_the_jax_package_has_a_port():
    jax_pkg, port = _public("mp3stego_tpu"), _public("mp3stego_tpu_torch")
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = " ".join(f.read().split())
    missing = []
    for module, names in sorted(jax_pkg.items()):
        for name in sorted(names):
            if name in port.get(module, ()):
                continue
            if (module, name) in COUNTERPARTS:
                pmod, pname = COUNTERPARTS[(module, name)]
                assert pname in port.get(pmod, ()), (module, name)
            elif (module, name) in NOT_TO_PORT:
                assert NOT_TO_PORT[(module, name)] in roadmap, (module, name)
            else:
                missing.append(f"{module}:{name}")
    assert not missing, f"no port and no not-to-port entry: {missing}"
    # every entry still names a public function of the JAX package
    for module, name in list(COUNTERPARTS) + list(NOT_TO_PORT):
        assert name in jax_pkg.get(module, ()), (module, name)
