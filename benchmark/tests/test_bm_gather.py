"""gather_kernel_ms on a canned trace: it reads the relaxation's gather
kernel as the card names it, and torch_kernel_ms leaves that kernel out."""
from __future__ import annotations

import pytest

from benchmark import registry

GATHER = ("void (anonymous namespace)::relax_gather_kernel(float4 const*, "
          "int const*, float*, int, unsigned int)")
# the program's nearest hit, then two of PyTorch's kernels
OTHERS = [
    "void (anonymous namespace)::nearest_kernel<true, true>(float const*, "
    "int const*, float const*, float const*, int, float*, int*)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "FillFunctor<float>, std::array<char*, 1ul> >(int, ...)",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_"
    "contig<...>(...)",
]


def _run(names):
    events, ts = [], 0
    for i, name in enumerate(names):
        dur = 1000 * (i + 1)
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                       "dur": dur, "args": {"device": 0}})
        ts += dur
    return dict(trace=dict(events=events, window=(0, ts), requests=2,
                           devices=[0]))


def test_gather_kernel_ms_reads_the_gather_kernel_alone():
    names = [GATHER] + OTHERS + [GATHER]
    run = _run(names)
    gather = registry.metric("gather_kernel_ms").read(run)
    assert gather == pytest.approx((1000 + 5000) / 2 / 1e3)
    torch_ms = registry.metric("torch_kernel_ms").read(run)
    assert torch_ms == pytest.approx((3000 + 4000) / 2 / 1e3)


def test_gather_kernel_ms_reads_nothing_without_the_kernel():
    """The parent's program has no gather kernel: None, not 0."""
    assert registry.metric("gather_kernel_ms").read(
        _run(OTHERS)) is None
    assert registry.metric("gather_kernel_ms").read({"trace": None}) is None
