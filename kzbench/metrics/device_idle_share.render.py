"""The share of the traced window in which no device activity ran:
1 - busy / window, in percent."""
NAME = "device_idle_share.render"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "pixel_samples_per_s"


def read(rec):
    if not rec.window_s or not rec.activities:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
