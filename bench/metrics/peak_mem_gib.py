"""``torch.cuda.max_memory_allocated()`` over the window (reset at the end of
set-up), in GiB."""


def read(run):
    return run.peak_bytes / float(1 << 30) if run.peak_bytes else None
