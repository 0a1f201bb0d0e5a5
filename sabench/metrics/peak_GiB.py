"""The device allocator's peak over the window (reset after set-up), in GiB."""


def read(window):
    return window.peak_bytes / 2**30
