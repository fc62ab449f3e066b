"""The card's peak allocated memory over the window, in GiB
(`max_memory_allocated` after `reset_peak_memory_stats` at its start)."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec.get("peak_bytes") else None
