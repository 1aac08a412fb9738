"""The readers of the program's spans (benchmark/spans.py and the metrics
that use it) on a canned trace of program spans and card operations, on
the canned trace of a program that records no span, and in a CPU run."""
from __future__ import annotations

import pytest

from benchmark import registry, spans, trace

from .conftest import cpu_run, small_config
from .test_bm_readers import _run as spanless_run

NEW = {"example_photon.render": {"schedule_idle_ms", "tonemap_ms",
                                 "encode_ms"},
       "example_radiosity.render": {"tonemap_ms.radiosity",
                                    "encode_ms.radiosity", "mipmap_plan_ms",
                                    "ff_idle_ms", "relax_idle_ms"}}


def _x(cat, name, ts, dur, device=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if device is not None:
        e["args"] = {"device": device}
    return e


def _span(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _kernel(ts, dur, device):
    return _x("kernel", "void k(int)", ts, dur, device)


# µs. The window 0-10,000 holds two requests on two cards. Card 0:
# 1,000-1,600 and 1,400-2,200 overlap (busy 1,000-2,200), 2,900-3,100
# crosses photon.schedule's end, 6,500-6,700 lies in the second
# request's schedule. Card 1: 1,500-2,500 and 5,900-6,000. A span outside
# the window is left out.
CANNED = [
    _span("bench.window", 0, 10000),
    _span("engine.run", 500, 3000),
    _span("photon.schedule", 800, 2200),          # 800-3,000
    _span("radiosity.form_factors", 800, 1000),   # 800-1,800
    _span("radiosity.relax", 2000, 1000),         # 2,000-3,000
    _span("radiosity.mipmap_plan", 1800, 200),
    _span("export.tonemap", 3600, 40),
    _span("export.encode", 3640, 60),
    _span("export.tonemap", 3700, 30),
    _span("export.encode", 3730, 70),
    _span("engine.run", 5500, 3000),
    _span("photon.schedule", 5800, 1000),         # 5,800-6,800
    _span("radiosity.form_factors", 5800, 500),   # 5,800-6,300
    _span("radiosity.relax", 6300, 700),          # 6,300-7,000
    _span("radiosity.mipmap_plan", 7000, 300),
    _span("export.tonemap", 9000, 50),
    _span("export.encode", 9050, 150),
    _span("export.tonemap", 20000, 999),
    _x("cpu_op", "aten::copy_", 1000, 10),
    _kernel(1000, 600, 0),
    _kernel(1400, 800, 0),
    _kernel(2900, 200, 0),
    _kernel(6500, 200, 0),
    _kernel(1500, 1000, 1),
    _kernel(5900, 100, 1),
]


def _canned_run():
    events = [dict(e) for e in CANNED]
    return dict(trace=dict(events=events, window=trace.window(events),
                           requests=2, devices=[0, 1]))


def _idle(span_us, busy_us):
    """Card idle ms a request: the instances' µs less each card's busy µs
    inside them, averaged over both cards, over two requests."""
    return (sum(span_us) * 2 - sum(busy_us)) / 2 / 2 / 1e3


@pytest.mark.parametrize("name, want", [
    # host ms: (40 + 30 + 50) and (60 + 70 + 150) over two requests
    ("tonemap_ms", 0.120 / 2),
    ("tonemap_ms.radiosity", 0.120 / 2),
    ("encode_ms", 0.280 / 2),
    ("encode_ms.radiosity", 0.280 / 2),
    ("mipmap_plan_ms", 0.500 / 2),
    # photon.schedule 800-3,000 and 5,800-6,800: card 0 busy 1,000-2,200
    # and 2,900-3,000 (its kernel crosses the span's end), then
    # 6,500-6,700; card 1 busy 1,500-2,500, then 5,900-6,000
    ("schedule_idle_ms", _idle([2200, 1000], [1200, 100, 200, 1000, 100])),
    # form factors 800-1,800 and 5,800-6,300: card 0 1,000-1,800; card 1
    # 1,500-1,800 and 5,900-6,000
    ("ff_idle_ms", _idle([1000, 500], [800, 300, 100])),
    # relax 2,000-3,000 and 6,300-7,000: card 0 2,000-2,200, 2,900-3,000
    # and 6,500-6,700; card 1 2,000-2,500
    ("relax_idle_ms", _idle([1000, 700], [200, 100, 200, 500])),
])
def test_reader_on_canned_spans(name, want):
    assert registry.metric(name).read(_canned_run()) == pytest.approx(want)


def test_instances_inside_the_window_only():
    run = _canned_run()
    assert spans.instances(run, "export.tonemap") == [
        (3600.0, 3640.0), (3700.0, 3730.0), (9000.0, 9050.0)]
    assert spans.instances(run, "mesh.combine") == []
    assert spans.instances(dict(trace=None), "export.tonemap") == []


@pytest.mark.parametrize("name", sorted(set().union(*NEW.values())))
def test_reader_without_program_spans_returns_nothing(name):
    """On the canned trace of a program that records no span (and on an
    untraced run) every new reader gives None."""
    reader = registry.metric(name)
    assert reader.read(spanless_run()) is None
    assert reader.read(spanless_run(traced=False)) is None


@pytest.mark.parametrize("workload, config", [
    ("example_photon.render", small_config("example_photon", 20000.0,
                                           1200000)),
    ("example_radiosity.render", small_config("example_radiosity", 64, 256)),
])
def test_traced_cpu_run_reports_the_span_metrics(capsys, workload, config):
    """A --trace 1 run of each cell on the CPU reports its new metrics
    (card idle there is the whole span: the CPU run traces no card)."""
    res = cpu_run(capsys, workload, config, trace=1)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert NEW[workload] <= set(got)
    assert all(got[k] > 0 for k in NEW[workload])
