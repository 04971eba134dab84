"""glome_tpu_torch: the glome-tpu differentiable ray tracer on PyTorch
and CUDA.

A port of glome_tpu (JAX + Pallas on a TPU) to PyTorch with kernels
written by hand for NVIDIA Hopper.  Module and public names follow
glome_tpu so each part has an obvious counterpart; the host side
(scene DAG, compiler, BVH builders, megakernel plan) is numpy, copied
because importing glome_tpu loads JAX.  The device is always explicit:
scene tensors come from `to_torch(compiled.arrays(), device)`, a CUDA
tensor goes through the CUDA kernel and a CPU tensor through its plain
torch version.  This package never imports jax or glome_tpu.
"""

from .config import RenderConfig, DELTA, INFINITY, deg, rot
from .materials import (AdditiveLayers, Blend, BlendFn, Light, Reflect,
                        Refract, Surface, Uniform, Warp, light, t_uniform)
from .solids import (bih, bound_object, box, cone, cylinder, difference,
                     difference_retexture, disc, group, intersection, mesh,
                     nothing, noshadow, onlyshadow, plane, plane_offset,
                     primcount, sphere, tag, tex, transform, triangle,
                     trianglenorm, triangles, trianglesnorms)
from . import xfm
from .xfm import compose, rotate, scale, translate, xyz_to_uvw
from .compile import compile_scene, CompiledScene, to_torch
from .trace import Tracer, TraceResult
from .trace_wavefront import WavefrontTracer
from .render import Camera, Renderer, camera
from .intersect import Hit, intersect, shadow_query
from .query import inside, metainfo
from .aa import AARenderer
from .soft import SoftTracer, soft_pixel_loss_fn
from .optimize import OptimizeResult, optimize

__version__ = "0.1.0"
