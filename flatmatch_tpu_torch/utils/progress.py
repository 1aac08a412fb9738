"""Tagged log lines on stderr, in the reference's [INF]/[WARN] vocabulary
(main.c:55). Copy of `log`, `info` and `warn` from
flatmatch_tpu/utils/progress.py.
"""
from __future__ import annotations

import sys


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", file=sys.stderr, flush=True)


def info(msg: str) -> None:
    log("INF", msg)


def warn(msg: str) -> None:
    log("WARN", msg)
