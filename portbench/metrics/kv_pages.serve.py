"""kv_pages.serve: the KV pages (of the mix's ``block_size`` tokens) that
the scheduler's allocator holds, averaged over the window's engine steps;
the pool is the mix's ``num_blocks`` less the null page."""


def read(run):
    return run.window.get("kv_pages")
