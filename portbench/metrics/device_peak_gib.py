"""Peak device memory over set-up and window (``torch.cuda.max_memory_allocated``), GiB."""


def read(run):
    return None if not run.memory_peak_bytes else run.memory_peak_bytes / 2**30
