"""Seconds from the start of the process to the start of the window:
loading, the text, the kernels' build where it happens, warm-up."""


def read(window):
    return window.setup_s
