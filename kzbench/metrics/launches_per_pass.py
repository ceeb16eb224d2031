"""Device activities (kernels, copies, fills) a render pass launches, every
layer together: what CUDA graphs or fused glue would cut."""
NAME = "launches_per_pass"
UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "wavefront glue"
MOVES = "pixel_samples_per_s"


def read(rec):
    if not rec.units or not rec.activities:
        return None
    return len(rec.activities) / rec.units
