"""K4's TF32 split on the CPU: ``kernels.tf32_split_plain`` held to the
rounding of ``cvt.rna.tf32.f32`` (to nearest, ties away from zero, 10
mantissa bits kept) on crafted bit patterns and, through hypothesis, on
random finite f32 bit patterns against an oracle that rounds by comparing
values, not bits.  The prep kernel itself runs only on the card, where
``tests/test_torch_cuda.py`` holds it bit for bit to this plain version."""

import struct
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from groomed_nms_torch.ops import kernels

LOW13 = 0x1FFF
INF_BITS = 0x7F800000
# TF32's smallest subnormal, 2^-126 * 2^-10: below 2^-126 hi and lo are
# multiples of it, so a subnormal x can be off by half of it
TF32_TINY = 2.0 ** -136


def _f32(bits):
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _bits(x):
    return struct.unpack("<I", struct.pack("<f", x))[0]


def _rna_oracle(bits):
    """cvt.rna.tf32.f32 by values: the nearer of the two TF32 magnitudes
    around |x|, the larger on a tie; a result of 2^128 overflows to
    infinity.  Sign kept."""
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    down = mag & ~LOW13
    up = down + 0x2000
    v = Fraction(_f32(mag))
    a = Fraction(_f32(down))
    b = Fraction(2 ** 128) if up >= INF_BITS else Fraction(_f32(up))
    pick = down if v - a < b - v else up
    return sign | min(pick, INF_BITS)


def _split_bits(bits):
    """(hi, lo) bits of kernels.tf32_split_plain on one f32 bit pattern."""
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)
    hi, lo = kernels.tf32_split_plain(x)
    return (hi.view(torch.int32).item() & 0xFFFFFFFF,
            lo.view(torch.int32).item() & 0xFFFFFFFF)


def _check_split(bits):
    """The split of one finite f32 below TF32's overflow: hi and lo in
    TF32, hi as the oracle rounds x, lo as it rounds x - hi, x - hi exact
    in f32, and x - hi - lo within 2^-22 |x| (+ TF32's smallest
    subnormal)."""
    hi, lo = _split_bits(bits)
    assert hi & LOW13 == 0 and lo & LOW13 == 0
    assert hi == _rna_oracle(bits)
    x, h = _f32(bits), _f32(hi)
    rest = x - h                              # exact in f64
    assert float(np.float32(rest)) == rest    # ... and in f32
    assert lo == _rna_oracle(_bits(rest))
    assert abs(rest - _f32(lo)) <= 2.0 ** -22 * abs(x) + TF32_TINY


@pytest.mark.parametrize("bits,hi", [
    (0x3F800000, 0x3F800000),      # 1.0, already TF32
    (0x3F801000, 0x3F802000),      # an exact tie at bit 12: away from zero
    (0x3F805000, 0x3F806000),      # a tie from an even kept bit: away too
    (0x3F800FFF, 0x3F800000),      # just below a tie
    (0x3F801001, 0x3F802000),      # just above
    (0xBF801000, 0xBF802000),      # the same patterns negative
    (0xBF805000, 0xBF806000),
    (0xBF800FFF, 0xBF800000),
    (0x3FFFF000, 0x40000000),      # a carry into the exponent
    (0xBFFFF000, 0xC0000000),
    (0x00000000, 0x00000000),      # +0 and -0
    (0x80000000, 0x80000000),
    (0x00000001, 0x00000000),      # subnormals
    (0x00000FFF, 0x00000000),
    (0x00001000, 0x00002000),
    (0x80001000, 0x80002000),
    (0x007FF000, 0x00800000),      # the largest subnormals carry into
    (0x807FF000, 0x80800000),      # the smallest normal
    (0x00800000, 0x00800000),
    (0x7F7FE000, 0x7F7FE000),      # the largest TF32
    (0x7F7FEFFF, 0x7F7FE000),      # just below its tie
])
def test_tf32_split_crafted_patterns(bits, hi):
    """hi as cvt.rna.tf32.f32 rounds each pattern, and the whole split's
    properties (``_check_split``)."""
    assert _rna_oracle(bits) == hi
    assert _split_bits(bits)[0] == hi
    _check_split(bits)


@pytest.mark.parametrize("bits", [0x7F7FF000, 0xFF7FFFFF])
def test_tf32_split_overflows_as_rounding_does(bits):
    """At or past the largest TF32's tie, rounding to nearest (away) gives
    2^128, which overflows: hi is infinity of x's sign."""
    hi, _ = _split_bits(bits)
    assert hi == (bits & 0x80000000) | INF_BITS == _rna_oracle(bits)


def test_tf32_split_seeded_tensor():
    """A seeded [12, 128, 512] tensor over exponents from 2^-140 to 2^100,
    signs mixed: hi and lo in TF32, x - hi exact in f32, the error bound,
    and hi + lo as close to x as the bound says, elementwise."""
    rs = np.random.default_rng(18)
    x = (rs.standard_normal((12, 128, 512)) *
         2.0 ** rs.integers(-140, 100, (12, 128, 512))).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = kernels.tf32_split_plain(xt)
    assert hi.shape == lo.shape == xt.shape
    for part in (hi, lo):
        assert not (part.view(torch.int32) & LOW13).any()
    x64, hi64, lo64 = (t.double() for t in (xt, hi, lo))
    rest = x64 - hi64
    assert torch.equal((xt - hi).double(), rest)
    assert ((rest - lo64).abs() <= 2.0 ** -22 * x64.abs() +
            TF32_TINY).all()
    assert torch.equal(kernels.tf32_split(xt)[0], hi)   # the CPU wrapper


def test_tf32_split_refuses_other_dtypes():
    with pytest.raises(ValueError, match="f32"):
        kernels.tf32_split_plain(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="f32"):
        kernels.tf32_split(torch.zeros(4, dtype=torch.bfloat16))


@settings(max_examples=2000, deadline=None)
@given(st.integers(0, 0xFFFFFFFF).filter(
    lambda b: b & INF_BITS != INF_BITS))
def test_tf32_split_random_finite_patterns(bits):
    """Any finite f32: below the overflow the whole split holds
    (``_check_split``); above it hi is infinity as the oracle says."""
    if bits & 0x7FFFFFFF < 0x7F7FF000:
        _check_split(bits)
    else:
        assert _split_bits(bits)[0] == _rna_oracle(bits)
