"""The metric readers, the trace arithmetic and the roofline on fixed
inputs: a canned profiler trace of two cards, and a run record."""
from __future__ import annotations

import json

import pytest

from benchmark import registry, roofline, trace

from .conftest import ROOT

# kernel names as the card's trace gives them (radiosity of the product's
# layout on an H100): the program's nearest hit and threefry, PyTorch's
# gathers, elementwise ops, reductions and cub sort
CARD_NAMES = [
    ("void (anonymous namespace)::nearest_kernel<true, true>(float const*, "
     "int const*, float const*, float const*, int, float*, int*)", False),
    ("void (anonymous namespace)::uniform_kernel(unsigned int, unsigned "
     "int, unsigned int, unsigned int, unsigned int, long, float*)", False),
    ("void (anonymous namespace)::trace_splat_kernel<true, true>(float "
     "const*, (anonymous namespace)::Params)", False),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::"
     "gpu_index_kernel<...>(...)::{lambda(int)#1}>(long, ...)", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<int>, std::array<char*, 1ul> >(int, ...)", True),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<...> > >(...)", True),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_"
     "contig<...>(...)", True),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>(...)",
     True),
]

# µs: the window 1000-2000; card 0 runs the trace kernel twice (overlapping
# 1100-1400 and 1300-1500) and a copy; card 1 one nearest kernel and one
# PyTorch kernel; the host spans name the gaps
CANNED = [
    {"ph": "X", "cat": "user_annotation", "name": "bench.window",
     "ts": 1000, "dur": 1000},
    {"ph": "X", "cat": "user_annotation", "name": "request.engine",
     "ts": 1000, "dur": 700},
    {"ph": "X", "cat": "user_annotation", "name": "request.export",
     "ts": 1700, "dur": 300},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
     "ts": 1550, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "trace_splat_kernel(float const*, "
     "float const*, Params)", "ts": 1100, "dur": 300,
     "args": {"device": 0}},
    {"ph": "X", "cat": "kernel", "name": "void trace_splat_kernel<true>(int)",
     "ts": 1300, "dur": 200, "args": {"device": 0}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
     "ts": 1600, "dur": 50, "args": {"device": 0}},
    {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::nearest_"
     "kernel<true, true>(float const*, (anonymous namespace)::Params)",
     "ts": 1200, "dur": 400, "args": {"device": 1}},
    {"ph": "X", "cat": "kernel", "name": "void at::native::index_kernel(int)",
     "ts": 1700, "dur": 100, "args": {"device": 1}},
    {"ph": "X", "cat": "kernel", "name": "general_nearest_kernel(int)",
     "ts": 1900, "dur": 10, "args": {"device": 1}},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1, "args": {}},
]


def _run(traced=True, work=None):
    events = [e for e in CANNED if e["ph"] == "X"]
    return dict(
        window_s=10.0, requests=4, setup_s=7.5, peak_window_bytes=3.9e9,
        spans=[dict(scene=0.001, engine=2.0, export=0.2),
               dict(scene=0.003, engine=2.2, export=0.2)],
        trace=dict(events=events, window=trace.window(events), requests=2,
                   devices=[0, 1]) if traced else None,
        work=work)


def _read(name, run):
    return registry.metric(name).read(run)


def test_trace_file_roundtrip(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": CANNED}))
    events = trace.load(path)
    assert len(events) == len(CANNED) - 1
    assert trace.window(events) == (1000.0, 2000.0)


def test_identifier():
    assert trace.identifier("void trace_splat_kernel<true>(int)") == \
        "trace_splat_kernel"
    assert trace.identifier("nearest_kernel(float const*)") == \
        "nearest_kernel"
    assert trace.identifier("void at::native::index_kernel(int)") == \
        "at::native::index_kernel"
    assert trace.identifier(
        "(anonymous namespace)::trace_splat_kernel<true>(float const*, "
        "(anonymous namespace)::Params, int*)") == "trace_splat_kernel"


@pytest.mark.parametrize("name, torch_own", CARD_NAMES)
def test_pytorch_kernel_by_namespace(name, torch_own):
    assert trace.pytorch_kernel(trace.identifier(name)) is torch_own


def test_no_kernel_of_the_program_counts_as_pytorch():
    """Every __global__ function of the program's csrc, declared as
    `__global__ void __launch_bounds__(...)` and the name on the next
    line, is outside PyTorch's namespaces."""
    import re

    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                      r"\([^)]*\)\s*)?(\w+)\s*\(")
    names = set()
    for src in (ROOT / "flatmatch_tpu_torch" / "csrc").glob("*.cu*"):
        names.update(decl.findall(src.read_text()))
    assert {"nearest_kernel", "uniform_kernel", "trace_splat_kernel",
            "general_nearest_kernel"} <= names
    assert "__launch_bounds__" not in names
    assert not any(trace.pytorch_kernel(n) for n in names)


def test_torch_kernel_ms_leaves_the_program_kernels_out():
    """Radiosity's kernels as the card names them: torch_kernel_ms counts
    only PyTorch's (index, elementwise, reduce, cat, cub), not the
    program's nearest hit or threefry."""
    events, ts = [], 0
    for i, (name, _) in enumerate(CARD_NAMES):
        dur = 1000 * (i + 1)
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                       "dur": dur, "args": {"device": 0}})
        ts += dur
    own = sum(1000 * (i + 1) for i, (_, t) in enumerate(CARD_NAMES) if t)
    run = dict(trace=dict(events=events, window=(0, ts), requests=2,
                          devices=[0]))
    assert _read("torch_kernel_ms", run) == pytest.approx(own / 2 / 1e3)
    assert _read("nearest_kernel_ms", run) == pytest.approx(1000 / 2 / 1e3)


def test_busy_union_counts_overlap_once():
    run = _run()
    events, (lo, hi) = run["trace"]["events"], run["trace"]["window"]
    assert trace.busy_s(events, lo, hi, 0) == pytest.approx(450e-6)
    assert trace.busy_s(events, lo, hi, 1) == pytest.approx(510e-6)
    assert trace.busy_s(events, 1450, 1460, 0) == pytest.approx(10e-6)


@pytest.mark.parametrize("name, want", [
    ("trace_kernel_ms", 0.25),
    ("nearest_kernel_ms", 0.2),
    ("torch_kernel_ms", 0.05),
    ("device_idle_pct", 100 * (1 - (450 + 510) / 2 / 1000)),
    ("render_s", 2.5),
    ("setup_s", 7.5),
    ("peak_device_gb", 3.9),
    ("scene_s", 0.002),
    ("engine_s", 2.1),
    ("export_s", 0.2),
])
def test_reader_on_canned_trace(name, want):
    assert _read(name, _run()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["trace_kernel_ms", "nearest_kernel_ms",
                                  "torch_kernel_ms", "device_idle_pct",
                                  "trace_roofline_pct",
                                  "nearest_roofline_pct"])
def test_reader_without_trace_returns_nothing(name):
    assert _read(name, _run(traced=False)) is None


def test_roofline_readers():
    work = dict(photons=1000, bounces_per_photon=5.0, rects=10, texels=100,
                rays=2000)
    run = _run(work=work)
    ops = 1000 * 5.0 * 10 * roofline.OPS_PER_RECT_TEST
    assert _read("trace_roofline_pct", run) == pytest.approx(
        100 * (ops / roofline.PEAK_OPS) / 250e-6)
    ops = 2000 * 10 * roofline.OPS_PER_RECT_TEST
    assert _read("nearest_roofline_pct", run) == pytest.approx(
        100 * (ops / roofline.PEAK_OPS) / 200e-6)


def test_roofline_arithmetic():
    assert roofline.least_s(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_s(67e12, 6.7e12) == pytest.approx(2.0)
    assert roofline.share_pct(67e12, 0, 4.0) == pytest.approx(25.0)
    assert roofline.share_pct(1, 1, 0) is None
    ops, nbytes = roofline.photon_trace_work(dict(
        photons=2, bounces_per_photon=3.0, rects=4, texels=5))
    assert ops == 2 * 3 * 4 * 20 and nbytes == 4 * (15 * 4 + 3 * 5)
    ops, nbytes = roofline.nearest_work(dict(rays=7, rects=3))
    assert ops == 7 * 3 * 20 and nbytes == 4 * (15 * 3 + 7)


def test_ops_per_rect_test_counts_the_reference():
    """The constant is the count of the reference's per-rect operations in
    reference/geometry.py `nearest` (its docstring names 20)."""
    src = (ROOT / "benchmark" / "reference" / "geometry.py").read_text()
    assert "per rect 20 operations" in src
    assert roofline.OPS_PER_RECT_TEST == 20


def test_breakdown():
    run = _run()
    events, (lo, hi) = run["trace"]["events"], run["trace"]["window"]
    ops = dict(trace.top_ops(events))
    assert ops["trace_splat_kernel"] == pytest.approx(500e-6)
    assert list(ops)[0] == "trace_splat_kernel"
    gaps = trace.idle_gaps(events, lo, hi, 0)
    assert gaps[0] == ["request.export", pytest.approx(350e-6)]
    assert ["aten::copy_", pytest.approx(100e-6)] in gaps
    assert ["request.engine", pytest.approx(100e-6)] in gaps
    assert len(trace.top_ops(events, 2)) == 2
