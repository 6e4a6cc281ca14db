"""Tokens of every step run in the window over the window's time, from
the first step's start to the end of the last (the loss read, which waits
for the step): all the work over all the time."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 and run.tokens else None
