"""95th percentile (linear interpolation) over all windows of the measured
window of the host clock around each `spin_once` that processed a window;
that call ends in the program's synchronising telemetry read."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.step_s, 95)) * 1e3 if ctx.step_s else None
