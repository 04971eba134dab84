"""Materials, textures and lights (host-side descriptors).

Mirrors the reference's material model (GlomeTrace/Data/Glome/Shader.hs:43-56)
and texture model (Solid.hs:94-97: a texture maps a hit to a material).

In the reference these are arbitrary closures dispatched per hit.  For a
TPU-native design, scene compilation interns every distinct material and
texture into small static tables; the shader then evaluates each table
entry once over the whole masked hit batch, so dispatch is data
(a gathered id), not control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

from .config import INFINITY


# --- materials ------------------------------------------------------------

class Material:
    """Base class for material descriptors."""


@dataclasses.dataclass(frozen=True)
class Surface(Material):
    """Whitted surface: color, alpha, ambient, diffuse, specular, shine,
    dielectric (reference Shader.hs:44)."""
    color: Tuple[float, float, float]
    alpha: float = 1.0
    ambient: float = 0.0
    kd: float = 1.0
    ks: float = 0.0
    shine: float = 1.0
    dielectric: bool = False


@dataclasses.dataclass(frozen=True)
class Reflect(Material):
    """Mirror reflection with amount (reference Shader.hs:45)."""
    amount: float = 1.0


@dataclasses.dataclass(frozen=True)
class Refract(Material):
    """Reflection + refraction with index of refraction
    (reference Shader.hs:46)."""
    refl: float
    refr: float
    ior: float


@dataclasses.dataclass(frozen=True)
class Warp(Material):
    """Re-cast the ray into another scene -- a portal
    (reference Shader.hs:47-50,157-175).

    frame: solid rendered in front of the portal, in portal-local
           coordinates (traced with the hit's object-space ray).
    scene: target solid to warp into; None means the enclosing root
           scene (the reference builds this with a lazy self-reference,
           TestScene.hs:179).
    lights: lights for the target scene trace.
    xfm:   an Xfm applied to Ray(hit_pos, normalize(dir)) to produce the
           warped ray (the reference takes an arbitrary closure; the
           TestScene portal uses exactly an xfm_ray, TestScene.hs:169-173).
    """
    frame: Any
    scene: Optional[Any]
    lights: Tuple["Light", ...]
    xfm: Any

    def __hash__(self):
        return hash((id(self.frame), id(self.scene), self.lights, id(self.xfm)))

    def __eq__(self, other):
        return self is other


@dataclasses.dataclass(frozen=True)
class AdditiveLayers(Material):
    """Sum of component materials (reference Shader.hs:51,177-179)."""
    layers: Tuple[Material, ...]


@dataclasses.dataclass(frozen=True)
class Blend(Material):
    """Static blend of two materials (reference Shader.hs:52,181-184)."""
    m1: Material
    m2: Material
    weight: float


# --- textures -------------------------------------------------------------

class Texture:
    """Base class for texture descriptors (hit -> material)."""


@dataclasses.dataclass(frozen=True)
class Uniform(Texture):
    """Same material everywhere (reference Shader.hs:55-56 t_uniform)."""
    material: Material


@dataclasses.dataclass(frozen=True)
class BlendFn(Texture):
    """Blend m1/m2 by a procedural scalar field of the hit position.

    field(pos: (...,3) tensor) -> weight in [0,1]; the result is
    Blend m1 m2 w per hit (this is how the reference's t_mottled and
    t_stripe closures work, TestScene.hs:214-231).
    """
    m1: Material
    m2: Material
    field: Callable  # (pos) -> weight array

    def __hash__(self):
        return hash((self.m1, self.m2, id(self.field)))

    def __eq__(self, other):
        return (isinstance(other, BlendFn) and self.m1 == other.m1
                and self.m2 == other.m2 and self.field is other.field)


def t_uniform(m: Material) -> Texture:
    return Uniform(m)


# --- lights ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Light:
    """Point light (reference Shader.hs:13-23).  `falloff` is an
    arbitrary distance -> intensity-scale function like the reference's
    litfalloff closure; None means the default 1/d^2 of the `light`
    constructor (Shader.hs:23).  It must accept (N,) distance
    tensors."""
    pos: Tuple[float, float, float]
    color: Tuple[float, float, float]
    radius: float = INFINITY
    shadow: bool = True
    falloff: object = None  # Optional[Callable[[dist], scale]]

    def falloff_at(self, llen):
        import torch
        if self.falloff is not None:
            return self.falloff(llen)
        return 1.0 / torch.clamp(llen * llen, min=1e-20)


def light(pos, color, falloff=None) -> Light:
    return Light(tuple(float(c) for c in pos),
                 tuple(float(c) for c in color), falloff=falloff)
