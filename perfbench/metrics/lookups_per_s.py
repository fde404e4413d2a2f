"""Table lookups completed in the window, over the window's time (host
clock, from the first request's start to the last one's return)."""


def read(records):
    w = records["window"]
    return w["lookups"] / w["window_s"] if w["window_s"] > 0 else None
