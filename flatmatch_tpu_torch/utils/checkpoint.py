"""Checkpoint and resume of long photon renders.

Copy of flatmatch_tpu/utils/checkpoint.py (numpy only). The only state
between photon batches is the f32 lightmap and the (emitter, batch) cursor:
the draws depend only on (seed, global batch, photon), and the port adds
each batch into the lightmap in a fixed order with exact integer sums, so a
run resumed from a cursor adds the same floats in the same order as a
straight run and ends on the same bits.

A checkpoint is one .npz with a config fingerprint; `load` checks it, so a
checkpoint never resumes another render. The port's engines put "torch"
into the fingerprint (engines/schedule.py): the two packages' lightmaps
differ in their last bits, so each refuses the other's file.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
from typing import Optional, Tuple

import numpy as np

from ..config import PhotonConfig

# Bumped whenever the fingerprint payload schema (not the render config)
# changes. A checkpoint of another schema version cannot be validated, so
# load() restarts with a warning instead of claiming the config changed.
FINGERPRINT_VERSION = 2


def config_fingerprint(
    cfg: PhotonConfig, num_texels: int, counts, extra=()
) -> str:
    """`extra` captures anything else the draw schedule depends on: engine
    name, package, batch size, segment length."""
    payload = json.dumps(
        {
            "cfg": dataclasses.asdict(cfg),
            "num_texels": int(num_texels),
            "counts": [int(c) for c in np.asarray(counts)],
            "extra": [str(x) for x in extra],
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save(
    path: str,
    lightmap: np.ndarray,
    emitter_index: int,
    batch_index: int,
    fingerprint: str,
) -> None:
    """Atomic checkpoint write (tmp + rename)."""
    p = pathlib.Path(path)
    tmp = p.with_suffix(".tmp.npz")
    np.savez_compressed(
        tmp,
        lightmap=np.asarray(lightmap, np.float32),
        emitter_index=np.int64(emitter_index),
        batch_index=np.int64(batch_index),
        fingerprint=np.frombuffer(
            fingerprint.encode("ascii"), dtype=np.uint8
        ),
        fp_version=np.int64(FINGERPRINT_VERSION),
    )
    os.replace(tmp, p)


def load(
    path: str, fingerprint: str
) -> Optional[Tuple[np.ndarray, int, int]]:
    """Returns (lightmap, emitter_index, batch_index) or None if absent.

    Raises ValueError on a same-version fingerprint mismatch (another
    scene, config, seed or package). A checkpoint written under another
    fingerprint schema version cannot be validated: the run restarts from
    scratch with a warning."""
    p = pathlib.Path(path)
    if not p.exists():
        return None
    with np.load(p) as z:
        version = int(z["fp_version"]) if "fp_version" in z else 1
        if version != FINGERPRINT_VERSION:
            from .progress import warn

            warn(
                f"checkpoint {path} was written by an incompatible engine "
                f"version (fingerprint schema v{version}, this build is "
                f"v{FINGERPRINT_VERSION}); restarting from scratch"
            )
            return None
        found = z["fingerprint"].tobytes().decode("ascii")
        if found != fingerprint:
            raise ValueError(
                f"checkpoint {path} was written for config {found}, "
                f"expected {fingerprint}"
            )
        return (
            z["lightmap"].astype(np.float32),
            int(z["emitter_index"]),
            int(z["batch_index"]),
        )
