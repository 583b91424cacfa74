"""Peak of the card's memory allocated by the process (torch's allocator
counter) up to the window's close, in GiB."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None
