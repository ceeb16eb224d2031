"""The shade kernel's share of its roofline: the sum over the traced
passes' K7 launches of each launch's bytes bound (kzbench/shade_roofline.py:
each lane's bytes read and written once, the tables and texel pool once a
launch, over 3.35 TB/s), over the summed device time of those launches, in
percent. Nothing to read (None) where no bounce took the kernel."""
NAME = "shade_kernel_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "shading"
MOVES = "pixel_samples_per_s"


def read(rec):
    name = rec.extra.get("shade_kernel_name")
    bound_s = sum(x["bound_s"] for x in rec.launches.get("K7", []))
    kernel_ns = sum(a.dur_ns for a in rec.activities if name and name in a.name)
    if not bound_s or not kernel_ns:
        return None
    return 100.0 * bound_s / (kernel_ns / 1e9)
