"""The bound model of the kernel table (``chip_smoke.py``) and of the probes
(:mod:`.probes`): an H100 SXM's peak rates from NVIDIA's data sheet and the
CUDA programming guide's throughput table for compute capability 9.0, and
the 32-bit multiplies a field product costs in it.  A kernel's bound is the
least time its bytes or operations take at these rates; the card may run
below them when its power limit is under 700 W.
"""

HBM_BYTES_PER_S = 3.35e12
BOOST_HZ = 1.98e9

# lanes per SM per clock
IMAD_PER_SM_CLK = 64  # 32-bit integer multiply(-add), the FMA pipe
ALU_PER_SM_CLK = 64  # LOP3, LEA.HI, IADD3, the integer ALU pipe
FFMA_PER_SM_CLK = 128  # FP32 fused multiply-add

# 32-bit multiplies a product mod 2^255 - 19 (64 32x32->64 limb products,
# low and high halves each) and a Montgomery product (the limb products,
# the 64 quotient-times-p products likewise, and 8 low products for the
# quotient words; chip_smoke.py's BN_M counts fp254.cuh's product so)
MULS_PER_FIELD_MUL = 2 * 64
MULS_PER_MONT_MUL = 2 * 64 + 2 * 64 + 8


def ops_ms(sms: int, count: float, per_sm_clk: float = IMAD_PER_SM_CLK):
    """Milliseconds for ``count`` operations at ``per_sm_clk`` lanes per SM
    per clock on ``sms`` SMs at the boost clock."""
    return count / (sms * per_sm_clk * BOOST_HZ) * 1e3


def products_ms(products: float, per_s: float) -> float:
    """Milliseconds for ``products`` field products at ``per_s`` products
    a second: the corrected bound, with the rate a field product measured
    at full occupancy (probe P2, ``probes.probe_vpu``), which the carries
    hold to about half of the multiply-only rate."""
    return products / per_s * 1e3
