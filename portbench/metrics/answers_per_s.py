"""Answers on the host inside the window, per second of the window: the
rate a backlog's user sees, on the host's clock."""


def read(run):
    return run.answered_in_window / run.seconds
