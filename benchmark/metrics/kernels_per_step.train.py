"""Device kernels (and copies and sets) a step in the traced window: the
host-pacing count of the train step (train/step.py)."""


def read(rec):
    if not rec.get("steps") or not rec.get("kernel_count"):
        return None
    return sum(rec["kernel_count"].values()) / rec["steps"]
