"""peak_gib.train, peak_gib.serve: `torch.cuda.max_memory_allocated` over the
window, reset at its start, in GiB."""


def read(ctx):
    if not ctx.get("peak_bytes"):
        return None
    return ctx["peak_bytes"] / 2 ** 30
