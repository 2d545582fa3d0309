"""Native host-plane library: lazy g++ build + ctypes bindings.

The C++ sources are the port's copy of the JAX package's (``src/*.cpp`` beside
this module, byte for byte equal, held so by tests/test_torch_import.py), so
the port builds from its own directory: the bitstream parser
(mp3_parse.cpp), the int8 sample-plane pack (raw_pack.cpp) and the float64
parity decode plane (decode_plane_f64.cpp), among others. One source is the
port's own: the light parse (mp3_light.cpp), the parser's walk without the
Huffman sample scan, which it leaves to the card (ops/huffman_device.py). Built on first use
with g++ into this package's git-ignored ``_build/`` directory (never into the
JAX package) and loaded via ctypes; every caller has a pure-NumPy fallback,
so the port stays functional without a toolchain.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "native", "src")
_SRCS = [os.path.join(_SRC_DIR, f)
         for f in sorted(os.listdir(_SRC_DIR)) if f.endswith(".cpp")]
BUILD_DIR = os.path.join(_PKG, "_build")


# -ffp-contract=off: decode_plane_f64.cpp must not fuse a*b+c into FMA —
# the float64 parity plane's bit-exactness contract is NumPy's separate
# mul/add rounding (integer-only sources are unaffected by the flag).
# -mprefer-vector-width=512: gcc defaults to 256-bit vectors on some
# x86 microarchitectures; vector width never changes per-element operation
# order, so exactness holds.
_CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-ffp-contract=off",
             "-mprefer-vector-width=512", "-shared", "-fPIC"]


def _host_tag() -> str:
    """Host fingerprint baked into the .so filename: the library is built
    with -march=native, so a build directory copied to a different CPU
    must rebuild instead of silently loading (and SIGILL-ing on) a binary
    compiled for another microarchitecture (or with stale flags)."""
    import hashlib
    import platform
    bits = [platform.machine(), " ".join(_CXXFLAGS)]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    bits.append(line.strip())
                    break
    except OSError:
        bits.append(platform.processor() or "")
    return hashlib.sha256("|".join(bits).encode()).hexdigest()[:12]


_SO = os.path.join(BUILD_DIR, f"libmp3stego_native-{_host_tag()}.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        if (os.path.exists(_SO)
                and all(os.path.getmtime(_SO) >= os.path.getmtime(s)
                        for s in _SRCS)):
            return True
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = ["g++", *_CXXFLAGS, *_SRCS, "-o", tmp]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded native library, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        _bind(lib)
        _lib = lib
        return _lib


def _bind(lib) -> None:
    """Attach restype/argtypes to a loaded libmp3stego_native (the same
    signatures as the JAX package's loader: one set of C sources)."""
    i64 = ctypes.c_int64
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.mp3_count_frames.restype = i64
    lib.mp3_count_frames.argtypes = [p_u8, i64, i64, p_i32]

    lib.mp3_parse.restype = i64
    lib.mp3_parse.argtypes = [
        p_u8, i64, i64,
        p_i32, p_i32, p_i32, p_i32, p_i32, p_i32, p_i32,
        i64,
        p_i32, p_i64, p_i32,   # raw samples are integral (int32)
        p_i32, p_i32, p_i32, p_i32, p_i32, p_i32,
        p_i32, p_i32, p_i32, p_i32, p_u8,
    ]

    lib.mp3_parse_light.restype = i64
    lib.mp3_parse_light.argtypes = [
        p_u8, i64, i64,
        p_i32,                 # the long band edges
        i64,
        p_i32, p_i64,
        p_i32, p_i32, p_i32, p_i32, p_i32, p_i32,
        p_i32, p_i32, p_i32, p_i32, p_u8,
        p_i32, i64, i64, p_i32,   # words, their capacity, pad, fields
        p_i64,                 # words needed
    ]

    i32 = ctypes.c_int32
    p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.mp3_format_frame.restype = i64
    lib.mp3_format_frame.argtypes = [
        p_u32, p_i32, p_u8, i64,
        i32, i32, i32, i32, i32, i32, i32, i32,
        i32, i32, i32, i32, i32, i32, i32,
        p_i32, p_i64, p_i32, p_i32, p_i32, p_i32, p_i32,
        p_u32, p_u8, p_i32, p_i32,
    ]
    p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    p_i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.pack_raw_plane.restype = i64
    lib.pack_raw_plane.argtypes = [
        p_i32, i64, p_i8, p_i32, p_i8, p_i16, p_i16, i64,
    ]

    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    _plane_args = [
        i64,
        p_i32, p_i32, p_i32, p_i32, p_i32, p_i32,   # raw + 5 gr fields
        p_i32, p_i32, p_i32, p_u8,                  # sbg, sfl, sfs, ms
        p_u8, p_i8, p_i8, p_f64,                    # is flag/pos/tab/coef
        p_i32, p_i32, p_i32, p_i32, p_i32,          # walk tables + perm
        p_f64, p_f64, p_f64, p_f64, p_f64,          # pow43, e1, e2, cs, ca
        p_f64, p_f64, p_f64, p_f64, p_f64,          # c_long/short, sine, n, d
        i64,                                        # mix_nlong (0 = ref mixed)
        i64,                                        # mix_s reorder boundary
    ]
    lib.decode_plane_f64.restype = i64
    lib.decode_plane_f64.argtypes = _plane_args + [p_f64]
    lib.decode_plane_i16.restype = i64
    lib.decode_plane_i16.argtypes = _plane_args + [p_i16, i64, i64]

    lib.rate_tables_init.restype = i64
    lib.rate_tables_init.argtypes = [
        p_f64, p_i32, p_i32,            # steptab, steptabi, int2idx
        p_i32, p_i32, p_i32, p_i32,     # hlen, xlen, linbits, linmax
        p_i32, p_i32,                   # qlen0, qlen1
        p_i32, i64, p_i32, p_i32,       # band flat + size, subdv, transform
    ]
    # shared shape: (xr, xrabs, xrmax, <step|rate|bits>, sr_off,
    #                hide, hide_len, hide_off, state[12], ix[576])
    for fn in (lib.rate_exact_eval, lib.rate_bin_search,
               lib.rate_inner_loop):
        fn.restype = i64
        fn.argtypes = [p_i32, p_i32, i64, i64, i64,
                       p_u8, i64, i64, p_i64, p_i32]

    lib.rate_search_file.restype = i64
    lib.rate_search_file.argtypes = [
        p_i32, p_i32, i64, i64, i64, i64,
        p_u8, i64, i64,
        p_i64, p_i32, p_i32, p_i32,
        p_i64, p_i32, i64,      # chain state/ix io + chain_in flag
    ]

    lib.rate_cost_step.restype = i64
    lib.rate_cost_step.argtypes = [p_i32, i64, i64, i64, i64, p_i64]

    lib.encode_analysis.restype = i64
    lib.encode_analysis.argtypes = [
        p_i16, i64, i64,
        p_i64, p_i32, p_i32, p_i32, p_i32,
        p_i32,
    ]

    lib.mp3_format_frames.restype = i64
    lib.mp3_format_frames.argtypes = [
        p_u32, p_i32, p_u8, i64,
        i64,
        i32, i32, i32, p_i32, i32, p_i32, i32, i32,
        i32, i32, i32, i32, i32, i32, i32,
        p_i32, p_i64, p_i32, p_i32, p_i32, p_i32, p_i32,
        p_u32, p_u8, p_i32, p_i32,
    ]


def available() -> bool:
    return get_lib() is not None
