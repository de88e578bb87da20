"""entries_dropped_pct: entries dropped for want of capacity over the entries
asked for (kept + dropped), summed over the window's steps from the
trainer's `last_stats` (each step's figures are the largest over its
cameras)."""


def read(ctx):
    w = ctx.window
    if "n_dropped" not in w:
        return None
    total = w["n_entries"] + w["n_dropped"]
    return 100.0 * w["n_dropped"] / total if total else None
