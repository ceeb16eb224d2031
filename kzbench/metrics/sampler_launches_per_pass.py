"""Device activities a render pass launches inside the sampler's draws
(the stream init and every next_1d / next_2d / next_pixel_2d call, with
core/rng.py's permute inside them)."""
NAME = "sampler_launches_per_pass"
UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "sampler"
MOVES = "pixel_samples_per_s"
STAGE = "sampler draws"


def read(rec):
    n = sum(1 for a in rec.activities if a.stage == STAGE)
    if not rec.units or not n:
        return None
    return n / rec.units
