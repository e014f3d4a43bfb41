"""What the metric readers share: means of stage seconds over a run's
window captures, and the profiled capture's spans."""

from __future__ import annotations


def stage_mean(rec: dict, *stages: str):
    """Seconds of `stages` summed within each window capture, then the mean
    over the captures; None where no capture ran any of them."""
    per = [sum(s[n] for n in stages if n in s) for s in rec["stages"]
           if any(n in s for n in stages)]
    return sum(per) / len(per) if per else None


def span(rec: dict, name: str):
    """The profiled capture's span `name` ({seconds, busy_s, kernels,
    count}), or None in an untraced run or where it never opened."""
    prof = rec.get("profile")
    return (prof or {}).get("spans", {}).get(name)
