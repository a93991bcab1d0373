"""peak_mem_gib: the caching allocator's peak,
``torch.cuda.max_memory_allocated()``, from process start to the window's
end, read by the harness before any correctness work, in GiB."""


def read(ctx):
    return ctx.memory_peak / 2 ** 30
