"""The share of the bounces whose NEE samples the importance-sampled
environment that the shade kernel (K7) shaded: the program's ``env_nee``
counter by route (``utils/metrics.py``), read from one 1-pass render()
call under the program's tracer after the traced window, ``kernel`` over
all routes, in percent. Nothing to read (None) where the program has no
such counter or no bounce sampled the environment."""
NAME = "env_nee_kernel_share"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "shading"
MOVES = "pixel_samples_per_s"


def read(rec):
    by_route = (rec.extra.get("counters") or {}).get("env_nee") or {}
    total = sum(by_route.values())
    if not total:
        return None
    return 100.0 * by_route.get("kernel", 0) / total
