"""Device milliseconds a fit step spends in the kernels launched while
loss.backward() runs (torch.autograd's backward of the wavefront and
the film; the trace kernels have none)."""
NAME = "backward_device_ms_per_step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "gradient path"
MOVES = "inverse_step_ms"
STAGE = "backward"


def read(rec):
    ns = sum(a.dur_ns for a in rec.activities if a.stage == STAGE)
    if not rec.units or not ns:
        return None
    return ns / 1e6 / rec.units
