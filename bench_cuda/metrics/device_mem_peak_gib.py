"""``torch.cuda.max_memory_allocated`` over the window (reset as it
opens, the resident instances included), the highest over ranks, GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes > 0 else None
