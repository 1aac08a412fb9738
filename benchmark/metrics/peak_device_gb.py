"""peak_device_gb: torch.cuda.max_memory_allocated over the window, on
the fullest card, in GB (1e9 bytes)."""


def read(run):
    return run["peak_window_bytes"] / 1e9 if run["peak_window_bytes"] else None
