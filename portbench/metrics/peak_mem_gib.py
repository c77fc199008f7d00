"""torch.cuda.max_memory_allocated over the program's set-up work and the
window (after the benchmark's own set-up allocations were freed), in
GiB."""


def read(record):
    return record["peak_bytes"] / 2**30
