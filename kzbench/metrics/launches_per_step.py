"""Device activities (kernels, copies, fills) a fit step launches: the
forward, the backward and the optimizer together."""
NAME = "launches_per_step"
UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "gradient path"
MOVES = "inverse_step_ms"


def read(rec):
    if not rec.units or not rec.activities:
        return None
    return len(rec.activities) / rec.units
