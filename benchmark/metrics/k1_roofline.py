"""K1's share of its roofline in the window: the least time for the bytes
of every launch the window made, counted from the shapes each launch had,
over the device time of K1's kernels in the trace."""

from benchmark import peaks


def read(run):
    shapes = run.launch_shapes.get("k1", [])
    secs, _ = run.trace.kernel_seconds(peaks.K1_KERNELS)
    if not shapes or secs <= 0.0:
        return None
    least = sum(peaks.least_seconds(peaks.k1_bytes(n, d)) for n, d in shapes)
    return 100.0 * least / secs
