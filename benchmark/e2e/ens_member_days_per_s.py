"""Member-days forecast per second: members x forecast days x ensembles
finished, over the window from its start to the end of its last
ensemble."""


def read(run):
    return run.member_days / run.window_s if run.window_s > 0 and run.member_days else None
