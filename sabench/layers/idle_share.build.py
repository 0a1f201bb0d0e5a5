"""The device's idle share over the traced builds, in %: 1 - (union of
its busy intervals) / window."""


def read(trace):
    if trace.kind != "build" or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
