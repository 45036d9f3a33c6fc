# SEEDED VIOLATIONS (block-geometry-registry-only): a block-size integer
# literal in a call, and private block_defaults plumbing.


def _inner(x, bk=None):
    return x


def flashy(x):
    y = _inner(x, bk=512)
    table = {"flashy": {"bk": 512}}

    def block_defaults(op):
        return table[op]

    return y, block_defaults("flashy")
