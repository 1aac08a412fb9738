"""Inverse rendering: fit per-rect albedo and per-emitter power to a target
lightmap (counterpart of flatmatch_tpu/diff/fit.py).

The parameterization keeps the optimization unconstrained:

  albedo = sigmoid(a_logit)   in (0, 1)
  power  = exp(p_log)         in (0, inf)

The renderer's photon schedule is fixed by cfg.seed, so the loss is a
deterministic function of the parameters and, on the card, the fit is
exactly reproducible: the kernels sum without float atomics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import PhotonConfig
from ..ops.aa_scene import AARects
from ..ops.device_scene import Emitters, Rects
from .render import make_diff_renderer, make_diff_renderer_wide


@dataclasses.dataclass
class FitResult:
    albedo: np.ndarray        # [N_rects] fitted reflectances in (0, 1)
    power: np.ndarray         # [N_emitters] fitted emitter scales (> 0)
    losses: np.ndarray        # [steps] relative-MSE loss per step
    lightmap: np.ndarray      # [T, 3] render at the fitted parameters


def _logit(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 1e-6, 1.0 - 1e-6)
    return torch.log(x) - torch.log1p(-x)


def init_params(n_rects: int, n_em: int, cfg: PhotonConfig,
                init_albedo: Optional[float] = None,
                init_power: float = 1.0, device="cpu") -> dict:
    """The fit's starting parameters: {"a_logit": [N_rects], "p_log":
    [N_emitters]} f32 (fit.py:116-125)."""
    a0 = cfg.albedo if init_albedo is None else float(init_albedo)
    a = _logit(torch.tensor(a0, dtype=torch.float32))
    p = torch.log(torch.tensor(init_power, dtype=torch.float32))
    return {"a_logit": torch.full((n_rects,), float(a), dtype=torch.float32,
                                  device=device),
            "p_log": torch.full((n_em,), float(p), dtype=torch.float32,
                                device=device)}


def make_renderer(rects: Rects, emitters: Emitters, num_texels: int,
                  cfg: PhotonConfig, aa: Optional[AARects] = None):
    """The differentiable renderer for a scene (fit.py:48-81 as it chooses
    on a TPU, without the mesh): the wide kernels' renderer when the scene
    has an axis-aligned table `aa` (albedo [len(aa.perm)]), the general
    engine's (make_diff_renderer, albedo [N_pad] in pack_rects order)
    otherwise."""
    if aa is not None:
        return make_diff_renderer_wide(emitters, num_texels, cfg, aa)
    return make_diff_renderer(rects, emitters, num_texels, cfg)


def fit_materials(
    target,
    rects: Optional[Rects],
    emitters: Emitters,
    num_texels: int,
    cfg: PhotonConfig,
    *,
    aa: Optional[AARects] = None,
    steps: int = 100,
    learning_rate: float = 0.1,
    init_albedo: Optional[float] = None,
    init_power: float = 1.0,
    fit_albedo: bool = True,
    fit_power: bool = True,
    params: Optional[dict] = None,
) -> FitResult:
    """Adam fit of (albedo [N_rects], power [N_emitters]) to a target
    lightmap [num_texels, 3] (the pre-exposure texel arena the renderer
    returns) on the scene table's device, through `make_renderer`: with
    `aa` the wide renderer (N_rects = len(aa.perm); `rects` may be None),
    without it the general renderer on `rects` (N_rects its padded rows,
    in pack_rects order).

    Loss = mean squared error over the target's mean square. Parameters not
    being fit are held at their start (detached). `params`, if given,
    replaces the start built from init_albedo/init_power. The per-step
    losses stay on the device and are read back once at the end."""
    if aa is None and rects is None:
        raise ValueError("fit_materials needs the rect table or the "
                         "axis-aligned table")
    render = make_renderer(rects, emitters, num_texels, cfg, aa)
    dev = aa.fields.device if aa is not None else rects.n.device
    n_rects = len(aa.perm) if aa is not None else rects.n.shape[0]
    if params is None:
        params = init_params(n_rects, len(emitters.counts), cfg,
                             init_albedo, init_power, dev)
    a_logit = params["a_logit"].detach().clone().to(dev).requires_grad_()
    p_log = params["p_log"].detach().clone().to(dev).requires_grad_()

    target = torch.from_numpy(np.array(target, np.float32)).to(dev)
    norm = torch.clamp(torch.mean(target * target), min=1e-20)

    def constrain():
        albedo = torch.sigmoid(a_logit)
        power = torch.exp(p_log)
        if not fit_albedo:
            albedo = albedo.detach()
        if not fit_power:
            power = power.detach()
        return albedo, power

    opt = torch.optim.Adam([a_logit, p_log], lr=learning_rate)
    losses = []
    for _ in range(int(steps)):
        opt.zero_grad()
        albedo, power = constrain()
        loss = torch.mean((render(albedo, power) - target) ** 2) / norm
        if loss.requires_grad:      # false when neither is being fit
            loss.backward()
        opt.step()
        losses.append(loss.detach())

    with torch.no_grad():
        albedo, power = constrain()
        lightmap = render(albedo, power)
    return FitResult(
        albedo=albedo.cpu().numpy(),
        power=power.cpu().numpy(),
        losses=(torch.stack(losses).cpu().numpy().astype(np.float64)
                if losses else np.zeros(0, np.float64)),
        lightmap=lightmap.cpu().numpy(),
    )


def fit_layout(
    layout_png: str,
    target_dir: str,
    scale: float,
    cfg,
    *,
    steps: int = 100,
    learning_rate: float = 0.1,
    fit_albedo: bool = True,
    fit_power: bool = True,
    init_albedo: Optional[float] = None,
    init_power: float = 1.0,
    out_path: Optional[str] = None,
    render_out: Optional[str] = None,
    device="cuda",
) -> FitResult:
    """End-to-end inverse rendering from a rendered target on disk
    (fit.py:174-264).

    `target_dir` holds `tile_<i>.raw` float32 dumps, one per wall in wall
    order (the output of `render --dump-raw`, post-exposure radiance). They
    are assembled into a texel arena, un-exposed back to raw engine
    radiance and fit with fit_materials on `device` using the photon config
    of `cfg` (a RenderConfig). Writes a JSON report to `out_path` when
    given; `render_out` also exports tone-mapped tiles of the render at the
    fitted parameters."""
    import json
    import pathlib

    from ..io.tiles import load_tile_raw, save_tiles
    from ..ops.aa_scene import pack_aa
    from ..ops.device_scene import exposure_scale, pack_emitters, pack_rects
    from ..render import compile_scene
    from ..scene.rectangle import num_tiles

    scene, _ = compile_scene(layout_png, scale, cfg)
    tdir = pathlib.Path(target_dir)
    arena = np.zeros((scene.num_texels, 3), np.float32)
    for i, r in enumerate(scene.walls):
        meta, data = load_tile_raw(str(tdir / f"tile_{i}.raw"))
        if (meta["wtiles"], meta["htiles"]) != (r.wtiles, r.htiles):
            raise ValueError(
                f"tile_{i}.raw is {meta['wtiles']}x{meta['htiles']} but the "
                f"compiled scene's wall {i} is {r.wtiles}x{r.htiles} — was "
                f"the target rendered from this layout at this scale?"
            )
        arena[r.base : r.base + num_tiles(r)] = data.reshape(-1, 3)

    # undo the photon exposure normalization (main.c:68-79): the renderer
    # works on raw pre-exposure radiance
    es = exposure_scale(scene, cfg.photon.samples_per_area,
                        cfg.photon.exposure)
    lit = es > 0
    arena[lit] /= es[lit, None]

    emitters = pack_emitters(scene, cfg.photon.samples_per_area,
                             cfg.photon.window_color, cfg.photon.light_color,
                             device=device)
    # the wide renderer where the walls have an axis-aligned table, the
    # general one otherwise (non-axis-aligned rects, 2^24 texels or more)
    aa = pack_aa(scene.walls, device=device)
    res = fit_materials(
        arena, pack_rects(scene.walls, device=device), emitters,
        scene.num_texels, cfg.photon, aa=aa, steps=steps,
        learning_rate=learning_rate, fit_albedo=fit_albedo,
        fit_power=fit_power, init_albedo=init_albedo, init_power=init_power,
    )
    if render_out is not None:
        fitted = res.lightmap * np.asarray(es)[:, None]
        save_tiles(scene.walls, fitted, render_out, tint_extra=False)
    if out_path is not None:
        pathlib.Path(out_path).write_text(json.dumps(
            {
                "albedo": [round(float(a), 6) for a in res.albedo],
                "power": [round(float(p), 6) for p in res.power],
                "initial_loss": res.losses[0] if len(res.losses) else None,
                "final_loss": res.losses[-1] if len(res.losses) else None,
                "steps": int(steps),
            },
            indent=1,
        ))
    return res
