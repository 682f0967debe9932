"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and window, GiB."""


def read(run):
    peak = run.get("memory_peak_bytes")
    return None if not peak else peak / 2**30
