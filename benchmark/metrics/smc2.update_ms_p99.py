"""99th percentile of the host-clock wall of one observation's update
(callback to callback, a device sync in each) over every update of the
traced fits: the rejuvenating updates an online user waits for."""

import numpy as np


def read(run):
    seconds = run.timings.get("update")
    return float(np.percentile(np.asarray(seconds) * 1e3, 99)) if seconds else None
