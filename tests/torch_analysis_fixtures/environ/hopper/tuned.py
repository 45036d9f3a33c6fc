# SEEDED VIOLATIONS (no-environ-in-kernels): a kernel module reading the
# process environment, both spellings.
import os


def tuned_block(x):
    bm = int(os.environ.get("SECRET_BM", "128"))
    bn = int(os.getenv("SECRET_BN", "128"))
    return x, bm, bn
