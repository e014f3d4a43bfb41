"""capture_s: the measured window over the captures completed in it."""


def read(rec):
    return rec["capture_s"]
