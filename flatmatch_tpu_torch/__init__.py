"""flatmatch_tpu_torch: the PyTorch and CUDA port of flatmatch_tpu.

It runs the photon render (`python -m flatmatch_tpu_torch.cli render
layout.png 30`, and `render` below with its library defaults, on scenes of
any orientation), the fit and the ambient-occlusion and radiosity engines
through hand-written CUDA kernels on an NVIDIA Hopper card, with a plain
PyTorch version of each kernel for CPU tensors. The JAX package stays
the reference; this package imports torch and never jax.

    from flatmatch_tpu_torch import render
    result = render("layout.png", out_dir="out", scale=30.0, device="cuda")
"""
from .config import DEFAULT_CONFIG, Engine, RenderConfig  # noqa: F401
from .render import RenderResult, compile_scene, render  # noqa: F401

__version__ = "0.1.0"
