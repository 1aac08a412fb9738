"""The comparison that decides `correct`: what a request produced against
what the reference works out, as a list of (name, value, limit) checks.
Each value must not pass its limit.

- geometry_bytes: bytes of the written geometry.json that differ from the
  reference's (the scene layer); exact.
- tiles_gap: the largest gap, in 8-bit levels, between a written tile and
  the reference's tone mapping of the arena the request returned (the
  export); a missing or misshapen tile reads 256.
- outside_gap: the largest gap of the arena outside the walls' level-0
  texels from what level 0 makes of it (0 for a photon arena, the mipmap
  pyramid for radiosity), over the largest level-0 value.
- energy_gap: |program - reference| / reference of the summed level-0
  arena (the engine).
- texel_chi2: the squared gap of the program's level-0 texels from the
  reference's, summed, over what the two estimates' noise makes it read:
  the reference is two independent halves A and B, its estimate their
  mean M, and with s the samples of a half over the program's,
      sum (P - M)^2 / sum (A - B)^2 (1/4 + s/2)
  (channel sums), whose expectation is 1 where the program estimates the
  same arena, whatever the noise's correlation between texels; more
  where it does not.
- answers_differ: requests (the window's and the traced ones) whose arena
  differs from the last one's, and requests that failed (the program is
  deterministic for a seed).

Those are the checks of a kind without checks of its own (`judge`). A
kind with its own (reference/<kind>.py `checks`, see registry.py) may
reuse the functions here. A run whose checks cannot be made stops with a
CheckError, and prints no result.
"""
from __future__ import annotations

import pathlib
from collections.abc import Mapping

import numpy as np

from .layout import Layout, geometry_json, level0_mask, mipmap, tiles

LUMA = np.array([0.2126, 0.7152, 0.0722])


class CheckError(ValueError):
    """A run that cannot be judged: its checks and its configuration's
    limits disagree, or its reference gives no measure to judge by."""


def tone_map(texels: np.ndarray) -> np.ndarray:
    """uint8 [T, 3] of radiance [T, 3] (convert2 and the 8-bit conversion,
    rectangle.c): luminance L of the Rec. 709 weights, every channel scaled
    by (1 - exp(-2 L)) / L, in float32, then clamp(c * 255) truncated;
    black where L is 0."""
    t = texels.astype(np.float64)
    lum = t @ LUMA
    with np.errstate(invalid="ignore", divide="ignore"):
        k = np.where(lum > 0, (1.0 - np.exp(-2.0 * lum)) / lum, 0.0)
    mapped = (t * k[:, None]).astype(np.float32)
    return np.clip(mapped.astype(np.float64) * 255.0, 0, 255).astype(
        np.uint8)


def floor_tint(rgb: np.ndarray, extra: bool) -> np.ndarray:
    """The brown post-tint of a floor tile's uint8 pixels: green * 0.95,
    blue * 0.9, truncated; twice (float32 factors) with `extra`, as the
    upstream's AO and radiosity modes do (rectangle.c, main.c)."""
    out = rgb.astype(np.float64)
    out[:, 1] *= 0.95
    out[:, 2] *= 0.9
    out = out.astype(np.uint8)
    if extra:
        ext = out.astype(np.float64)
        ext[:, 1] *= np.float32(0.95)
        ext[:, 2] *= np.float32(0.9)
        out = ext.astype(np.uint8)
    return out


def tile(r, texels: np.ndarray, extra: bool) -> np.ndarray:
    """The uint8 [htiles, wtiles, 3] image of wall r."""
    rgb = tone_map(texels[r["base"]:r["base"] + tiles(r)])
    if (float(r["pos"][2]) == 0.0 and float(r["width"][2]) == 0.0
            and float(r["height"][2]) == 0.0):
        rgb = floor_tint(rgb, extra)
    return rgb.reshape(r["htiles"], r["wtiles"], 3)


def tiles_gap(layout: Layout, texels: np.ndarray, tile_dir, extra: bool
              ) -> int:
    from PIL import Image

    gap = 0
    for i, r in enumerate(layout.walls):
        path = pathlib.Path(tile_dir) / f"tile_{i}.png"
        if not path.exists():
            return 256
        with Image.open(path) as im:
            got = np.asarray(im.convert("RGB"), np.int32)
        want = tile(r, texels, extra).astype(np.int32)
        if got.shape != want.shape:
            return 256
        gap = max(gap, int(np.abs(got - want).max()))
    return gap


def bytes_gap(got: bytes, want: bytes) -> int:
    n = min(len(got), len(want))
    a = np.frombuffer(got[:n], np.uint8)
    b = np.frombuffer(want[:n], np.uint8)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def outside_gap(layout: Layout, texels: np.ndarray, mipmapped: bool
                ) -> float:
    want = np.zeros_like(texels, dtype=np.float64)
    l0 = np.zeros(len(texels), bool)
    for r in layout.walls:
        b, n = r["base"], tiles(r)
        l0[b:b + n] = True
        if mipmapped:
            pyr = mipmap(texels[b:b + n], r)
            want[b + n:b + n + len(pyr)] = pyr
    top = float(np.abs(texels[l0]).max()) or 1.0
    return float(np.abs(texels[~l0] - want[~l0]).max(initial=0.0)) / top


def engine_checks(layout: Layout, texels: np.ndarray, ref: dict):
    """(energy_gap, texel_chi2) of a returned arena's level-0 texels
    against the reference's two halves."""
    l0 = level0_mask(layout)
    a, b = (h.sum(1)[l0] for h in ref["halves"])
    got = texels.astype(np.float64).sum(1)[l0]
    want = 0.5 * (a + b)
    energy = abs(got.sum() - want.sum()) / want.sum()
    noise = np.sum((a - b) ** 2) * (0.25 + 0.5 * ref["share"])
    if not noise > 0:
        raise CheckError(
            "the reference's halves A and B are equal, so texel_chi2 has no "
            "noise to divide by: a deterministic reference needs checks of "
            "its own (reference/<kind>.py `checks`)")
    return float(energy), float(np.sum((got - want) ** 2) / noise)


def checks(layout: Layout, texels: np.ndarray, ref: dict, out_dir,
           extra: bool, answers_differ: int, limits: dict) -> list:
    """[(name, value, limit)] of one cell's run: the last request's
    arena `texels` and its files in `out_dir` against the reference's
    estimate `ref` (reference.<kind>.expected)."""
    out = pathlib.Path(out_dir)
    geo = out / "geometry.json"
    geo_gap = (bytes_gap(geo.read_bytes(), geometry_json(layout).encode())
               if geo.exists() else 1 << 30)
    energy, chi2 = engine_checks(layout, texels, ref)
    values = dict(
        geometry_bytes=geo_gap,
        tiles_gap=tiles_gap(layout, texels, out / "tiles", extra),
        outside_gap=outside_gap(layout, texels, ref.get("mipmapped", False)),
        energy_gap=energy,
        texel_chi2=chi2,
        answers_differ=answers_differ)
    return agree([(k, v, limits.get(k)) for k, v in values.items()], limits)


def agree(checks: list, limits: dict) -> list:
    """`checks` as they are, where their names and the configuration's
    `limits` agree one to one and each check's limit is the
    configuration's; else a CheckError naming what disagrees."""
    names = [n for n, _, _ in checks]
    faults = []
    if len(set(names)) < len(names):
        faults.append(f"checks given twice: "
                      f"{sorted({n for n in names if names.count(n) > 1})}")
    if set(names) - set(limits):
        faults.append(f"checks without a limit in the configuration: "
                      f"{sorted(set(names) - set(limits))}")
    if set(limits) - set(names):
        faults.append(f"limits that no check gives: "
                      f"{sorted(set(limits) - set(names))}")
    other = [n for n, _, lim in checks if n in limits and lim != limits[n]]
    if other:
        faults.append(f"checks whose limit is not the configuration's: "
                      f"{other}")
    if faults:
        raise CheckError("; ".join(faults))
    return checks


def expected(kind, layout: Layout, settings: dict, budget: dict, seed: int,
             device, inputs=None) -> dict:
    """Reference kind `kind`'s (a module, registry.reference) estimate of
    what the request returned, given the request's `inputs` where its mix
    returned any."""
    if inputs is None:
        return kind.expected(layout, settings, budget, seed, device)
    return kind.expected(layout, settings, budget, seed, device,
                         inputs=inputs)


def judge(kind, layout: Layout, outputs, ref: dict, out_dir, extra: bool,
          answers_differ: int, limits: dict, inputs=None) -> list:
    """[(name, value, limit)] of one cell's run: the kind's own checks
    where it has them, else `checks` of a bare arena; their names have to
    agree with `limits` (`agree`)."""
    own = getattr(kind, "checks", None)
    if own is not None:
        return agree(own(layout, outputs, ref, out_dir, extra,
                         answers_differ, limits, inputs=inputs), limits)
    if isinstance(outputs, Mapping):
        raise CheckError(
            f"the request returned named outputs {sorted(outputs)}, which "
            "only a kind's own checks (reference/<kind>.py `checks`) judge")
    return checks(layout, outputs, ref, out_dir, extra, answers_differ,
                  limits)
