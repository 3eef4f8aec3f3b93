"""The window's 3x3 convs against their roofline: the sum over the convs
of max(FLOPs / peak, bytes / bandwidth), computed from their shapes, over
the device time of the kernels that ``kernels/*.json`` name, in %."""


def read(run):
    tr = run.trace
    if tr is None or tr["conv_s"] <= 0 or not run.conv_bound_s:
        return None
    return 100.0 * run.conv_bound_s / tr["conv_s"]
