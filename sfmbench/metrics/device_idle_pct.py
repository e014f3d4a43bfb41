"""device_idle_pct: 100 minus the device's busy share of the profiled
capture (kernels, copies and sets over the traced span), in %."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
