"""Q31 fixed-point primitives, exact vs the reference's encoder/util.py:123-172.

Each takes int arrays of any shape, multiplies in int64 and narrows the result
to int32 with two's-complement wraparound, bit-identical to the reference's
numba kernels. Every function takes either torch tensors (on any device) or
NumPy arrays and returns the same kind; the NumPy form is the host twin.

int32 addition is associative and commutative mod 2^32, so a reduction of
``mul`` products may run in any order: sum the int32 products with
``dtype=torch.int32`` (or sum in int64 and narrow with ``.to(torch.int32)``)
and the wrapped result is the reference's sequential one.
"""

import numpy as np
import torch


def _wide(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        dev = a.device if isinstance(a, torch.Tensor) else b.device
        return (torch.as_tensor(a, device=dev).to(torch.int64),
                torch.as_tensor(b, device=dev).to(torch.int64))
    return np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)


def _narrow(v):
    """int64 -> int32, keeping the low 32 bits (modular)."""
    return v.to(torch.int32) if isinstance(v, torch.Tensor) \
        else v.astype(np.int32)


def mul(a, b):
    """(a*b) >> 32, truncated to int32."""
    a, b = _wide(a, b)
    return _narrow((a * b) >> 32)


def mulr(a, b):
    """Rounded: (a*b + 2^31) >> 32, to int32."""
    a, b = _wide(a, b)
    return _narrow((a * b + 2147483648) >> 32)


def mulsr(a, b):
    """Rounded Q31: (a*b + 2^30) >> 31, to int32."""
    a, b = _wide(a, b)
    return _narrow((a * b + 1073741824) >> 31)


def cmuls(are, aim, bre, bim):
    """Complex butterfly: ((are*bre - aim*bim)>>31, (are*bim + aim*bre)>>31).

    Each product is at most 2^62 in magnitude; where a sum of two reaches
    2^63 it wraps in int64, which changes bits 33 and up of the shifted
    value and so never the int32 result."""
    are, aim = _wide(are, aim)
    bre, bim = _wide(bre, bim)
    return (_narrow((are * bre - aim * bim) >> 31),
            _narrow((are * bim + aim * bre) >> 31))
