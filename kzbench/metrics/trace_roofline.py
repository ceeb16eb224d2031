"""The trace kernels' share of their roofline: the sum over the window's
K1 and K2 launches of each launch's bound (kzbench/roofline.py: the larger
of its bytes over 3.35 TB/s and its triangle tests x 45 over 67 TFLOP/s),
over the summed device time of those kernels, in percent."""
NAME = "trace_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "trace kernels"
MOVES = "pixel_samples_per_s"


def read(rec):
    names = rec.extra.get("trace_kernel_names", {})
    bound_s = sum(x["bound_s"] for tag in names for x in rec.launches.get(tag, []))
    kernel_ns = sum(a.dur_ns for a in rec.activities
                    if any(k in a.name for k in names.values()))
    if not bound_s or not kernel_ns:
        return None
    return 100.0 * bound_s / (kernel_ns / 1e9)
