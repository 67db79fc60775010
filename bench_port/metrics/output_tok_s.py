"""Every output token the engine returned in the window, over the
window's length (host clock)."""


def read(run):
    return len(run.window.token_times()) / run.window.seconds
