"""render_s: the window's seconds over the requests it held (the
publisher's wait for a layout, the operator's card time per layout)."""


def read(run):
    return run["window_s"] / run["requests"] if run["requests"] else None
