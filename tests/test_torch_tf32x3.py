"""The 3xTF32 arithmetic of K1 and K6, emulated on the CPU.

On the card K1 (``csrc/streaming_conv.cu``) and K6 (``csrc/statistics.cu``)
run their products on the tensor cores through ``csrc/tf32x3.cuh``: each
float32 operand is split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
(``cvt.rna.tf32.f32``), each 8-deep k-step adds ``a_lo b_hi``, ``a_hi b_lo``
and ``a_hi b_hi`` into a float32 partial sum, and every 32-deep stretch's
partial sum is added to a float32 total. This file emulates that arithmetic in torch and
applies it to K1's function, at segments (2, 600) and kernels (2, 37, 160),
hop 64, and to K6's Gram, at buffers (4, 3, 4, 200), J = 12 (the kernel's
depth order: mic by mic, each mic's time padded to whole stretches). Against
a float64 oracle, the 3xTF32 error must be at most twice that of the plain
float32 version (the bar the card holds the kernels to), and one TF32 pass
alone must be at least 50 times worse (why single-pass TF32 stays refused).
"""

import numpy as np
import pytest
import torch

from apvast_torch.ops import kernels as K
from apvast_torch.ops.framing import window_rows

# Depth between the kernels' adds into the fp32 total: 32 in both (K1's
# kPromote of 4 k-steps of 8, K6's kPromote of 32 samples).
PROMOTE = 32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 bits: add half a TF32 ulp (0x1000) to
    the magnitude bits, then clear the 13 bits below the 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mma_emulated(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``a @ b`` (float32, depth a multiple of PROMOTE) as the kernels take it:
    per 8-deep k-step the TF32 products (exact in float32) into a float32
    partial sum, the cross terms first; every PROMOTE-deep stretch's partial
    sum added to a float32 total. ``passes`` 3: 3xTF32; 1: a_hi b_hi alone."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    total = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for c0 in range(0, a.shape[-1], PROMOTE):
        part = torch.zeros_like(total)
        for k0 in range(c0, c0 + PROMOTE, 8):
            ks = slice(k0, k0 + 8)
            if passes == 3:
                part = part + a_lo[..., ks] @ b_hi[..., ks, :]
                part = part + a_hi[..., ks] @ b_lo[..., ks, :]
            part = part + a_hi[..., ks] @ b_hi[..., ks, :]
        total = total + part
    return total


def _pad_depth(x: torch.Tensor, axis: int) -> torch.Tensor:
    pad = -x.shape[axis] % PROMOTE
    widths = [0, 0] * (x.dim() - 1 - axis % x.dim()) + [0, pad]
    return torch.nn.functional.pad(x, widths)


def _streaming_conv(rng):
    """K1's function: (float32 plain, float64 oracle, emulation(passes))."""
    seg = torch.from_numpy(rng.standard_normal((2, 600)).astype(np.float32))
    kern = torch.from_numpy(rng.standard_normal((2, 37, 160)).astype(np.float32))
    hop, taps = 64, kern.shape[-1]
    hist = seg.shape[-1] - hop
    windows = seg.unfold(-1, hop, 1)[:, hist - taps + 1 : hist + 1].flip(1)  # (2, taps, hop)
    plain = K.streaming_conv_plain(seg, kern, hop)
    oracle = K.streaming_conv_plain(seg.double(), kern.double(), hop)
    a, b = _pad_depth(kern, -1), _pad_depth(windows.contiguous(), -2)
    return plain, oracle, lambda passes: mma_emulated(a, b, passes)


def _covariance(rng):
    """K6's Gram R: (float32 plain, float64 oracle, emulation(passes))."""
    p, m, s, n, j = 4, 3, 4, 200, 12
    buf = torch.from_numpy(rng.standard_normal((p, m, s, n)).astype(np.float32))
    tgt = torch.from_numpy(rng.standard_normal((2, m, n - j + 1)).astype(np.float32))
    y = _pad_depth(window_rows(buf, j), -1)  # (p, m, s*j, k padded)
    y = y.permute(0, 2, 1, 3).reshape(p, s * j, -1)  # depth: mic by mic
    plain = K.covariance_plain(buf, tgt, j)[0]
    oracle = K.covariance_plain(buf.double(), tgt.double(), j)[0]
    return plain, oracle, lambda passes: mma_emulated(y, y.transpose(1, 2).contiguous(), passes)


FUNCTIONS = {"streaming_conv": _streaming_conv, "covariance": _covariance}


def _err(x, oracle) -> float:
    return float((x.double() - oracle).abs().max() / oracle.abs().max())


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0**-23, -(one + ulp / 2),
                      one + 3 * ulp / 2, 2.0 - ulp / 4, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp, 2.0, 3.0])
    assert torch.equal(tf32(x), want)


def test_tf32_split_holds_float32_to_2_pow_minus_22():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(100_000, generator=g) * torch.exp(4 * torch.randn(100_000, generator=g))
    hi = tf32(x)
    lo = tf32(x - hi)
    assert torch.equal(hi, tf32(hi)) and torch.equal(lo, tf32(lo))
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0**-11
    assert float(((x.double() - hi.double() - lo.double()).abs() / x.abs().double()).max()) <= 2.0**-22


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_3xtf32_within_twice_the_plain_float32_error(name):
    plain, oracle, emulated = FUNCTIONS[name](np.random.default_rng(8))
    e_plain, e3 = _err(plain, oracle), _err(emulated(3), oracle)
    assert 0 < e_plain
    assert e3 <= 2 * e_plain, (e3, e_plain)


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_one_tf32_pass_is_at_least_50x_worse(name):
    plain, oracle, emulated = FUNCTIONS[name](np.random.default_rng(8))
    e_plain, e1 = _err(plain, oracle), _err(emulated(1), oracle)
    assert e1 >= 50 * e_plain, (e1, e_plain)
