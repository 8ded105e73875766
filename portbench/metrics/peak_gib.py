"""The device memory the allocator held at most over the window
(``torch.cuda.max_memory_allocated`` after a reset past the warm-up),
GiB."""


def compute(record):
    return record["peak_bytes"] / 2**30 if record["peak_bytes"] else None
