"""peak_mem_gib: ``torch.cuda.max_memory_reserved`` over the window,
after the allocator's cache is emptied and its peak reset at the
window's start: the CUDA graphs' private pools and what the window's
rounds allocate (``max_memory_allocated`` does not count a captured
graph's pool between its replays), and not what set-up left cached."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
