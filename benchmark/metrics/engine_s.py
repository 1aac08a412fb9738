"""engine_s: mean seconds of a request's engine span (benchmark/loop.py
`request`), over the window's requests that ran without the profiler."""


def read(run):
    spans = [s["engine"] for s in run["spans"]]
    return sum(spans) / len(spans) if spans else None
