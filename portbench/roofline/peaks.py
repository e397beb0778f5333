"""Published peaks of one NVIDIA H100 SXM5 (NVIDIA's data sheet, dense
rates, at its 700 W power limit), and the benchmark's count of the
operations of one kernel pair.

A pair's float32 operations are the least a direct evaluation does:
the three coordinate differences, |r|^2 (three products, two sums),
then per output value and density value the product and the sum.  The
reciprocal square root is counted apart, at the SFU rate: 16 a clock
on each of the 132 SMs at the card's 1,980 MHz boost clock.
"""

F32_FLOPS = 67e12            # FP32 outside the tensor cores
F64_FLOPS = 34e12            # FP64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
SMS = 132
BOOST_HZ = 1.98e9
RSQRT_PER_S = 16 * SMS * BOOST_HZ
POWER_LIMIT_W = 700.0

# kernel -> float32 operations a (target, source) pair, besides its
# one reciprocal square root
PAIR_FLOPS = {
    "Laplace3D-FxU": 3 + 5 + 2,
    "Laplace3D-DxU": 3 + 5 + 5 + 2 + 2,
    "Stokes3D-FxU": 3 + 5 + 5 + 3 * 6,
    "Stokes3D-DxU": 3 + 5 + 5 + 5 + 3 * 4,
}
