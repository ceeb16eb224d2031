"""Device milliseconds a render pass spends in what shading launches: the
bounce's shading glue in integrate/path_mis.py and the shade/ modules it
calls (BSDFs, textures, lights), less the sampler draws, the trace
kernels and the permute inside the bounce."""
NAME = "shade_device_ms_per_pass"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "shading"
MOVES = "pixel_samples_per_s"
STAGE = "shading"


def read(rec):
    ns = sum(a.dur_ns for a in rec.activities if a.stage == STAGE)
    if not rec.units or not ns:
        return None
    return ns / 1e6 / rec.units
