"""train_tokens_per_s: the tokens of every train step completed inside the
window (loss and parameters updated, synchronised), and of the step that the
close found running its share of the window, over the window's whole
length. So the rate moves with the speed, not in whole steps."""
import statistics
import sys


def read(ctx):
    rec = ctx.record
    if rec["steps"]:
        print(f"train_tokens_per_s: {len(rec['steps'])} steps, median step "
              f"{1e3 * statistics.median(t for t, _ in rec['steps'])!r} ms", file=sys.stderr)
    return (sum(n for _, n in rec["steps"]) + rec["in_flight"]) / rec["seconds"]
