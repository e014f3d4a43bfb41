"""cold_extra_s: the cold capture's wall minus the mean warm capture wall of
the same run: what the first capture in a process pays for lazy start-up."""


def read(rec):
    if rec["cold_capture_s"] is None or not rec["walls"]:
        return None
    return rec["cold_capture_s"] - sum(rec["walls"]) / len(rec["walls"])
