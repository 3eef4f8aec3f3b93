"""Device ms per model call of every device op not counted as a 3x3
conv: halo strips, pooling, gates, insolation, copies, reductions."""


def read(run):
    tr = run.trace
    if tr is None or tr["device_ops"] == 0 or not run.calls:
        return None
    return 1e3 * tr["other_s"] / run.calls
