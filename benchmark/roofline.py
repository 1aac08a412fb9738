"""Peaks of the chip and the work of a render, counted from the inputs and
the reference algorithm, never from the program's source.

A kernel's roofline share is the least time the chip could take for the
work, the larger of operations over the peak operation rate and bytes
over the peak bandwidth, as a share of the kernel's measured time.

Peaks: one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet):
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.

OPS_PER_RECT_TEST: the operations of one ray against one rect in the
reference's nearest hit (reference/geometry.py `nearest`), each counted
once:
  t = (plane - o_k) / d_k                   2 (subtract, divide)
  xa = o_a + t * d_a; xb = o_b + t * d_b    4 (multiply, add, twice)
  sign * d_k < 0                            2 (multiply, compare)
  t >= 0                                    1
  lo_a <= xa <= hi_a; lo_b <= xb <= hi_b    4
  the six tests and-ed                      5
  where(valid, t, inf)                      1
  the running minimum                       1
  ---------------------------------------- 20
Counting a compare or a select as one operation at a peak that counts a
fused multiply-add as two keeps the least time a lower bound. Every traced
bounce tests every rect, as the upstream engine does: a change of
algorithm (an acceleration structure that skips rects) needs a benchmark
change to recount.
"""
from __future__ import annotations

PEAK_OPS = 67e12      # float32 operations a second
PEAK_BYTES = 3.35e12  # bytes a second
OPS_PER_RECT_TEST = 20
FLOAT = 4


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)


def share_pct(ops: float, nbytes: float, seconds: float):
    """The roofline share in %, or None where no time was measured."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_s(ops, nbytes) / seconds


def photon_trace_work(work: dict) -> tuple:
    """(operations, bytes) of a render's photon trace: every bounce of
    every photon tests every wall; the wall table (15 values a rect) read
    once, the [texels, 3] float32 arena written once."""
    ops = (work["photons"] * work["bounces_per_photon"] * work["rects"]
           * OPS_PER_RECT_TEST)
    nbytes = FLOAT * (15 * work["rects"] + 3 * work["texels"])
    return ops, nbytes


def nearest_work(work: dict) -> tuple:
    """(operations, bytes) of a render's form-factor rays: every ray tests
    every rect; the table read once, an int32 texel id a ray written
    once."""
    ops = work["rays"] * work["rects"] * OPS_PER_RECT_TEST
    nbytes = FLOAT * (15 * work["rects"] + work["rays"])
    return ops, nbytes
