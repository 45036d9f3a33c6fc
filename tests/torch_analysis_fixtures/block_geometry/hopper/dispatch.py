# Fixture dispatch: two ops in the block table, so the single-path half of
# block-geometry-registry-only has something to demand of ops.py.
_BLOCK_DEFAULTS: dict = {
    "gemm": {"bm": 256, "bk": 256, "bn": 256},
    "spmm": {"bm": 128},
}


def resolve_blocks(op, **explicit):
    return dict(_BLOCK_DEFAULTS[op], **explicit)
