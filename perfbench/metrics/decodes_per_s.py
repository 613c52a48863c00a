"""Decoded requests per second: every request the harness saw retire inside
the window, over the window's seconds (host clock)."""


def read(r):
    return r.window.completed / r.window.seconds
