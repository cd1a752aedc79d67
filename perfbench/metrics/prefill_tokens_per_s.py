"""prefill_tokens_per_s: the real prompt tokens (pads left out) of every
request whose first token reached the host inside the window, and of the
group that the close found running its share of the window, over the
window's whole length. So the rate moves with the speed, not in whole
groups."""


def read(ctx):
    rec = ctx.record
    return (sum(n for _, n in rec["done"]) + rec["in_flight"]) / rec["seconds"]
