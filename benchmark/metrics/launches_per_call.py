"""Device kernels per model call in the trace."""


def read(run):
    tr = run.trace
    if tr is None or tr["kernels"] == 0 or not run.calls:
        return None
    return tr["kernels"] / run.calls
