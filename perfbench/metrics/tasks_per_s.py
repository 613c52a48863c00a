"""RPM tasks answered per second: every task the harness saw answered inside
the window, over the window's seconds (host clock)."""


def read(r):
    return r.window.completed / r.window.seconds
