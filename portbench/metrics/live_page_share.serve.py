"""live_page_share.serve: the KV pages the traced slice's decodes needed
(each active slot's pages up to the position it writes) over the pages
they walked (every slot, every table column), all layers, from the
program's counters on its ``engine.decode`` spans, in percent."""
from portbench.lib import program_spans as ps


def read(run):
    steps = ps.named(run, "engine.decode")
    walked = sum(r.attrs.get("pages_walked", 0) for r in steps)
    if not walked:
        return None
    return 100.0 * sum(r.attrs["pages_live"] for r in steps) / walked
