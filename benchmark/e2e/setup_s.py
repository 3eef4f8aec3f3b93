"""Set-up: seconds from the process's start to the first measured
request or step (imports, kernel libraries, weights and inputs made on
the card, warm-up)."""


def read(run):
    return run.setup_s
