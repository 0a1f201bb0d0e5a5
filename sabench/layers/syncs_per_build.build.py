"""Host waits for the device in one build, counted by
`torch.cuda.set_sync_debug_mode` (one a round's tied count)."""


def read(trace):
    if trace.kind != "build" or not trace.syncs:
        return None
    return sum(trace.syncs) / len(trace.syncs)
