"""The yardstick's peaks and the trace kernels' operation and byte counts.

Peaks: one H100 SXM, NVIDIA's data sheet (dense, at the 700 W limit):
3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor cores.

A trace kernel launch reads its rays (8 float32 rows) and its tables once
and writes the output rows a consumer reads: rows 0-33 of the nearest hit
(K1; 34-36 are diagnostics), row 0 of the any hit (K2). Its operations are
its triangle tests, each one Moller-Trumbore test of 45 float32 operations
(2 cross products of 9, 4 dot products of 5, 3 subtractions, 1 division, 3
scalings); the tests are read from the kernel's own diagnostic row (K1 row
36, K2 row 3). The bound of a launch is the larger of its bytes over the
bandwidth and its operations over the float32 peak.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
MT_FLOPS = 2 * 9 + 4 * 5 + 3 + 1 + 3

IO_ROWS = {"K1": 8 + 34, "K2": 8 + 1}
TEST_ROW = {"K1": 36, "K2": 3}


def launch_bound_s(kernel: str, n_rays: int, tests: float, table_bytes: int):
    """(seconds, "bytes" or "operations") of one launch's bound."""
    t_bytes = (IO_ROWS[kernel] * 4 * n_rays + table_bytes) / PEAK_BYTES_PER_S
    t_ops = tests * MT_FLOPS / PEAK_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
