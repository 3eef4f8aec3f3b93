"""Model FLOP utilisation: the benchmark's FLOP count of the window's
model calls or steps, over the window's wall time, against the card's
published dense peak for the configuration's dtype, in %."""


def read(run):
    peak = (run.peaks or {}).get(run.dtype)
    if not peak or run.window_s <= 0 or not run.model_flops:
        return None
    return 100.0 * run.model_flops / run.window_s / peak
