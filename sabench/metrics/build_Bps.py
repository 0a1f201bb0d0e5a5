"""Input bytes built in the window over the window's seconds (build traffic)."""


def read(window):
    if window.kind != "build":
        return None
    return window.work / window.seconds
