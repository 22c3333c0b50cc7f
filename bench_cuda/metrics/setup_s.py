"""Process start to the window's start: imports, kernel builds, the
data instances, the program's set-up and the warm-up queries."""


def read(run):
    return run.setup_s
