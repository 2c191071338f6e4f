"""The 95th percentile over every solve of the window, each timed by CUDA
events on the device from its call to the end of its last operation."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.call_ms, 95)) if ctx.call_ms else None
