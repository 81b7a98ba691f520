"""The yardstick of the kernels: the least time the card could take.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the peak rate of the units it runs on, counted from the
shapes and live counts of its inputs: each input byte read once, each
output byte written once, whatever the kernel reads again, and the
operations that these inputs need.  The peaks are the published ones of
one NVIDIA H100 SXM (dense, 700 W).  These functions are frozen here: a
change to the program changes the time, never the yardstick.
"""

from __future__ import annotations

from ..reference.akaze import AkazeConfig, build_plan

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
INT8_TC_OPS_PER_S = 1979e12    # int8 tensor cores
BF16_TC_OPS_PER_S = 989e12     # bf16 tensor cores

DESCRIPTOR_BITS = 486
WORD_BYTES = 64                # 16 int32 words per descriptor row
# K2's taps per live slot: 109 orientation taps of Lx and Ly, 441 MLDB
# taps of L, Lx and Ly
K2_TAPS = 109 * 2 + 441 * 3
K2_SLOT_IN = 8 * 4 + 2 * 4     # int32 [8] and float32 [2] slot parameters
K2_SLOT_OUT = 4 + 87 * 4       # angle and 87 float32 cell sums


def bound_s(nbytes: float, ops: float, op_rate: float) -> float:
    """The least seconds: bytes over the memory rate or operations over
    ``op_rate``, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / op_rate)


def plan_for(akaze: dict, height: int, width: int):
    return build_plan(height, width, AkazeConfig(**akaze))


def k1_octave_work(oct_plan, batch: int, given_smooth: bool):
    """(bytes, operations) of K1 over one octave of ``batch`` images: the
    source (and the decimation's smooth, from the second octave on) read
    once, the four planes of every sublevel written once; every stencil
    operation of the plain version counted once per pixel."""
    px = batch * oct_plan.height * oct_plan.width
    S = len(oct_plan.scales)
    ops = 0
    for s, sp in enumerate(oct_plan.scales):
        if not (s == 0 and given_smooth):
            r = 4 if (s == 0 and oct_plan.octave == 0) else 2
            ops += 2 * (1 + 3 * r)                       # Gaussian, 2 passes
        if sp.taus:
            ops += 20 + 17 * len(sp.taus)                # flow, FED steps
        ops += 14 + 24                                   # Lx, Ly; det
    return 4 * px * (1 + given_smooth + 4 * S), ops * px


def k1_work(plan, batch: int):
    """(bytes, operations) of K1 over a whole scale space."""
    nbytes = ops = 0
    for o in plan.octaves:
        b, n = k1_octave_work(o, batch, o.octave > 0)
        nbytes, ops = nbytes + b, ops + n
    return nbytes, ops


def k1_bound_s(plan, batch: int) -> float:
    return bound_s(*k1_work(plan, batch), F32_OPS_PER_S)


def k2_work(n_live: int, slots: int, plane_bytes: int):
    """(bytes, operations) of K2 over ``slots`` keypoint slots of which
    ``n_live`` are live: the live slots' taps of planes of ``plane_bytes``
    per value, each slot's parameters read and its outputs written."""
    return (n_live * K2_TAPS * plane_bytes
            + slots * (K2_SLOT_IN + K2_SLOT_OUT)), 0


def k2_bound_s(n_live: int, slots: int, plane_bytes: int) -> float:
    return bound_s(*k2_work(n_live, slots, plane_bytes), F32_OPS_PER_S)


def k4_work(n1: int, n2: int, slots1: int):
    """(bytes, operations) of K4 on n1 live queries against n2 live train
    rows: both sets' words and the train validity read, three int32
    outputs per query slot written; 2 x 486 operations per live pair, the
    +-1 int8 tensor-core form of the distance."""
    return ((n1 + n2) * WORD_BYTES + n2 + 3 * 4 * slots1,
            2 * DESCRIPTOR_BITS * n1 * n2)


def k4_bound_s(n1: int, n2: int, slots1: int) -> float:
    return bound_s(*k4_work(n1, n2, slots1), INT8_TC_OPS_PER_S)
