"""The readers of the program's own spans (`ransac_round_ms`,
`ransac_rounds_per_chunk`, `ransac_polish_s`, `ba_iteration_ms`): their
value on a synthetic traced record, and None where the run was not traced
or the program opened no such span (a parent without the spans)."""

import pytest

from sfmbench import spec

READERS = ("ransac_round_ms", "ransac_rounds_per_chunk", "ransac_polish_s", "ba_iteration_ms")


def _span(seconds, count):
    return dict(seconds=seconds, busy_s=seconds / 5, kernels=10 * count, count=count)


def _record(spans):
    profile = None if spans is None else dict(busy_s=1.0, window_s=5.0, spans=spans)
    return dict(setup_s=1.0, cold_capture_s=2.0, capture_s=0.5, captures=2, walls=[0.5, 0.5],
                stages=[{"estimate_pairwise": 0.3}], problem=None, profile=profile)


TRACED = _record({
    "call:estimate_pairwise": _span(4.0, 1),
    "call:ransac.chunk": _span(3.5, 9),
    "call:ransac.round": _span(2.8, 360),
    "stage:ransac.refit": _span(0.25, 9),
    "stage:ransac.polish": _span(0.5, 9),
    "call:ba.iteration": _span(0.9, 120),
})


@pytest.mark.parametrize("name, value", [
    ("ransac_round_ms", 1000 * 2.8 / 360),
    ("ransac_rounds_per_chunk", 40.0),
    ("ransac_polish_s", 0.75),
    ("ba_iteration_ms", 7.5),
])
def test_span_readers_read_a_traced_record(name, value):
    assert spec.reader(name)(TRACED) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_span_readers_give_none_untraced_or_without_the_span(name):
    read = spec.reader(name)
    assert read(_record(None)) is None
    assert read(_record({"call:estimate_pairwise": _span(4.0, 1)})) is None


def test_polish_needs_both_of_its_spans():
    only_polish = _record({"stage:ransac.polish": _span(0.5, 9)})
    assert spec.reader("ransac_polish_s")(only_polish) is None
