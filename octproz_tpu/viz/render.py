"""Offline volume raycaster: the 7 render modes of the reference's 3D viewer.

Capability-equivalent of GLWindow3D + RayCastVolume + the GLSL raycast
shaders (octproz_project/octproz/src/glwindow3d.cpp:266-272 mode list;
shaders/*.frag), re-expressed as a jit-compiled orthographic ray marcher:
instead of one GPU fragment thread per pixel, a `lax.scan` over ray steps
advances ALL pixels simultaneously, each step doing one trilinear volume
sample per pixel (`jax.scipy.ndimage.map_coordinates`) plus the mode's
compositing update -- fully vectorized on the VPU.

Mode semantics (matched to the shader integration loops, not transcribed):

* MIP      (maximum_intensity_projection.frag:141-199): running max of
           samples above threshold; transfer function on the max.
* DMIP     (depth_mip.frag): MIP + depth modulation
           ``colour * ((1-w) + 2 w (1-depth_at_max))``.
* ALPHA    (alpha_blending.frag): front-to-back "over" compositing with
           alpha = intensity^alpha_exponent and the reference's ray-length
           brightness term ``a * 2.25^(frac_remaining)/1.75``.
* MIDA     (mida.frag): maximum-intensity-difference accumulation --
           compositing weighted by ``1 - (intensity - running_max)`` only
           when a new maximum is reached (Bruckner & Groeller MIDA).
* XRAY     (xray.frag): sqrt of the mean of samples above threshold.
* ISOSURFACE (isosurface.frag): first sample above threshold with two
           bisection refinement steps, Blinn-Phong shaded
           (Ia=0.75, Id=0.5, Is with exponent 600, shader shading()).
* OCT_DEPTH (oct_depth.frag + compute_sample_depths.glsl): back-to-front
           compositing colored by distance below the first surface.

All modes finish with the shader's background blend and gamma correction
(``pow(colour, 1/gamma)``).  View = yaw/pitch rotation around the volume
center (the trackball analog, src/trackball.cpp), orthographic projection.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class RenderMode(enum.Enum):
    ISOSURFACE = "isosurface"
    ALPHA = "alpha_blending"
    MIP = "mip"
    DMIP = "depth_mip"
    MIDA = "mida"
    XRAY = "xray"
    OCT_DEPTH = "oct_depth"


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Display parameters (GLWindow3DParams, src/controlpanel.h:67-84)."""

    mode: RenderMode = RenderMode.MIP
    step_length: float = 0.01          # rayMarchStepLength
    threshold: float = 0.25
    gamma: float = 2.0
    alpha_exponent: float = 2.0
    depth_weight: float = 0.7          # DMIP depthWeight
    depth_threshold: float = 0.1       # compute_sample_depths depthIntensityThreshold
    shading: bool = False
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    material: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    light_position: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    stretch: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # stretch x/y/z


def _rotation(yaw: float, pitch: float) -> np.ndarray:
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return rx @ ry


def _sample(volume: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Trilinear sample at world pos in [-0.5, 0.5]^3; 0 outside.

    pos: (..., 3) -> intensity (...,).
    """
    from jax.scipy.ndimage import map_coordinates

    shape = jnp.asarray(volume.shape, jnp.float32)
    coords = (pos + 0.5) * (shape - 1.0)
    return map_coordinates(volume, [coords[..., 0], coords[..., 1], coords[..., 2]],
                           order=1, mode="constant", cval=0.0)


def _normal(volume: jnp.ndarray, pos: jnp.ndarray, eps: float = 0.01) -> jnp.ndarray:
    """Central-difference gradient normal (shader normal())."""
    grads = []
    for axis in range(3):
        off = jnp.zeros(3, jnp.float32).at[axis].set(eps)
        grads.append(_sample(volume, pos + off) - _sample(volume, pos - off))
    g = jnp.stack(grads, axis=-1)
    return g / (jnp.linalg.norm(g, axis=-1, keepdims=True) + 1e-8)


def _blinn_phong(colour, pos, ray_dir, normal, light_position):
    """Ia=0.75, Id=0.5 max(0, N.L), Is=pow(max(0, N.H), 600) (shader shading())."""
    light = jnp.asarray(light_position, jnp.float32)
    l = light - pos
    l = l / (jnp.linalg.norm(l, axis=-1, keepdims=True) + 1e-8)
    v = -ray_dir / (jnp.linalg.norm(ray_dir) + 1e-8)
    h = l + v
    h = h / (jnp.linalg.norm(h, axis=-1, keepdims=True) + 1e-8)
    ia = 0.75
    idiff = 0.5 * jnp.maximum(0.0, jnp.sum(normal * l, axis=-1))
    ispec = jnp.power(jnp.maximum(0.0, jnp.sum(normal * h, axis=-1)), 600.0)
    return (ia + idiff)[..., None] * colour + ispec[..., None]


def compute_sample_depths(volume: jnp.ndarray, threshold: float = 0.1) -> jnp.ndarray:
    """Per-voxel depth-below-surface texture (compute_sample_depths.glsl:28-62).

    Scans each A-scan column from the surface side (high depth index toward 0,
    matching the shader's z loop): voxels before the first sample above
    ``threshold`` get 0; from the surface on, depth starts at 1.0 and
    decreases by 1/n per voxel.
    """
    n = volume.shape[-1]
    rev = volume[..., ::-1]  # scan order: surface first
    seen = jnp.cumsum((rev > threshold).astype(jnp.float32), axis=-1)
    started = seen > 0
    # voxels since the surface voxel (0 at the surface itself)
    since = jnp.where(started, jnp.cumsum(started.astype(jnp.float32), axis=-1) - 1.0, 0.0)
    depth = jnp.where(started, jnp.maximum(1.0 - since / n, 0.0), 0.0)
    return depth[..., ::-1]


def _transfer(intensity, alpha_exponent, lut: Optional[jnp.ndarray]):
    """colour_transfer / LUT lookup (shader colour_transfer + lut branch)."""
    a = jnp.power(jnp.clip(intensity, 0.0, 1.0), alpha_exponent)
    if lut is None:
        rgb = jnp.stack([intensity] * 3, axis=-1)
    else:
        idx = jnp.clip(intensity, 0.0, 1.0) * (lut.shape[0] - 1)
        rgb = lut[jnp.round(idx).astype(jnp.int32)]
    return rgb, a


@functools.partial(jax.jit, static_argnames=("params", "out_shape"))
def _render(volume, depth_tex, rot, lut, params: RenderParams,
            out_shape: Tuple[int, int]):
    h, w = out_shape
    stretch = jnp.asarray(params.stretch, jnp.float32)

    # Orthographic pixel grid on the view plane, covering the unit cube's
    # rotated extent (sqrt(3) diagonal margin).
    extent = 0.5 * math.sqrt(3.0)
    us = jnp.linspace(-extent, extent, w)
    vs = jnp.linspace(-extent, extent, h)
    uu, vv = jnp.meshgrid(us, vs)
    # view axes in world space (rows of rot)
    right, up, fwd = rot[0], rot[1], rot[2]
    n_steps = max(int(2.0 * extent / params.step_length), 2)
    t0 = -extent
    dt = 2.0 * extent / n_steps
    origin = uu[..., None] * right + vv[..., None] * up + t0 * fwd  # (h, w, 3)
    step_vec = dt * fwd

    def pos_at(i):
        p = origin + i.astype(jnp.float32) * step_vec
        return p / stretch  # stretch scales the volume

    thr = params.threshold

    def march(carry_init, body):
        def step(carry, i):
            return body(carry, i), None
        out, _ = jax.lax.scan(step, carry_init, jnp.arange(n_steps))
        return out

    if params.mode in (RenderMode.MIP, RenderMode.DMIP):
        def body(carry, i):
            max_i, i_at_max = carry
            s = _sample(volume, pos_at(i))
            better = (s > max_i) & (s > thr)
            return (jnp.where(better, s, max_i),
                    jnp.where(better, i.astype(jnp.float32), i_at_max))
        max_i, i_at_max = march((jnp.zeros((h, w)), jnp.zeros((h, w))), body)
        rgb, a = _transfer(max_i, params.alpha_exponent, lut)
        if params.mode == RenderMode.DMIP:
            depth = i_at_max / n_steps
            wgt = (1.0 - params.depth_weight) + 2.0 * params.depth_weight * (1.0 - depth)
            rgb = rgb * wgt[..., None]
            a = a * wgt
        colour, alpha = rgb, a

    elif params.mode == RenderMode.XRAY:
        def body(carry, i):
            total, count = carry
            s = _sample(volume, pos_at(i))
            use = s > thr
            return (total + jnp.where(use, s, 0.0), count + use.astype(jnp.float32))
        total, count = march((jnp.zeros((h, w)), jnp.zeros((h, w))), body)
        avg = jnp.where(count > 0, jnp.sqrt(total / jnp.maximum(count, 1.0)), 0.0)
        colour, alpha = _transfer(avg, params.alpha_exponent, lut)

    elif params.mode == RenderMode.ALPHA:
        def body(carry, i):
            rgb, a = carry
            p = pos_at(i)
            s = _sample(volume, p)
            c_rgb, c_a = _transfer(s, params.alpha_exponent, lut)
            new_rgb = c_a[..., None] * c_rgb + (1.0 - c_a)[..., None] * a[..., None] * rgb
            new_a = c_a + (1.0 - c_a) * a
            # reference ray-length brightness term (alpha_blending.frag)
            frac_remaining = 1.0 - i.astype(jnp.float32) / n_steps
            boost = new_a * jnp.power(2.25, frac_remaining) / 1.75
            new_rgb = new_rgb * boost[..., None]
            if params.shading:
                new_rgb = _blinn_phong(new_rgb, p, step_vec, _normal(volume, p),
                                       params.light_position)
            # reference loop terminates at colour.a >= 0.9
            # (alpha_blending.frag): freeze saturated pixels
            use = (s > thr) & (a < 0.9)
            return (jnp.where(use[..., None], new_rgb, rgb), jnp.where(use, new_a, a))
        colour, alpha = march((jnp.zeros((h, w, 3)), jnp.zeros((h, w))), body)

    elif params.mode == RenderMode.MIDA:
        def body(carry, i):
            rgb, a, max_i = carry
            s = _sample(volume, pos_at(i))
            c_rgb, c_a = _transfer(s, params.alpha_exponent, lut)
            weighting = 1.0 - (s - max_i)
            tmp = (1.0 - weighting * a) * c_a
            new_rgb = weighting[..., None] * rgb + tmp[..., None] * c_rgb
            new_a = weighting * a + tmp
            # mida.frag also terminates at colour.a >= 0.9
            use = (s > thr) & (s > max_i) & (a < 0.9)
            return (jnp.where(use[..., None], new_rgb, rgb),
                    jnp.where(use, new_a, a),
                    jnp.where(use, s, max_i))
        colour, alpha, _ = march(
            (jnp.zeros((h, w, 3)), jnp.zeros((h, w)), jnp.zeros((h, w))), body)

    elif params.mode == RenderMode.ISOSURFACE:
        def body(carry, i):
            found, hit_pos = carry
            p = pos_at(i)
            s = _sample(volume, p)
            new_hit = (s > thr) & jnp.logical_not(found)
            hit_pos = jnp.where(new_hit[..., None], p, hit_pos)
            return (found | (s > thr), hit_pos)
        found, hit_pos = march(
            (jnp.zeros((h, w), bool), jnp.zeros((h, w, 3))), body)
        # two bisection refinements (isosurface.frag)
        p1 = hit_pos - 0.5 * step_vec / stretch
        s1 = _sample(volume, p1)
        p2 = p1 - jnp.where((s1 > thr)[..., None], 0.25, -0.25) * step_vec / stretch
        shaded = _blinn_phong(jnp.asarray(params.material, jnp.float32), p2,
                              step_vec, _normal(volume, p2), params.light_position)
        bg = jnp.power(jnp.asarray(params.background, jnp.float32), params.gamma)
        colour = jnp.where(found[..., None], shaded, bg)
        alpha = jnp.ones((h, w))

    elif params.mode == RenderMode.OCT_DEPTH:
        def body(carry, i):
            rgb, a, d_old = carry
            j = n_steps - 1 - i  # back-to-front (oct_depth.frag marches ray_stop->start)
            p = pos_at(j)
            s = _sample(volume, p)
            d = _sample(depth_tex, p)
            d_delta = jnp.abs(d - d_old)
            use = (s > thr) & (s < 0.9) & (d > 0.1) & (d_delta < 1.01 * params.step_length)
            c_rgb, _ = _transfer(jnp.clip(d - 0.05, 0.0, 1.0), params.alpha_exponent, lut)
            c_a = jnp.power(jnp.clip(s, 0.0, 1.0), params.alpha_exponent)
            new_rgb = c_a[..., None] * c_rgb + (1.0 - c_a)[..., None] * a[..., None] * rgb
            new_a = c_a + (1.0 - c_a) * a
            new_rgb = new_rgb / jnp.maximum(new_a, 1e-6)[..., None]
            return (jnp.where(use[..., None], new_rgb, rgb),
                    jnp.where(use, new_a, a), d)
        colour, alpha, _ = march(
            (jnp.zeros((h, w, 3)), jnp.zeros((h, w)), jnp.ones((h, w))), body)

    else:
        raise ValueError(f"unknown render mode {params.mode}")

    # background blend + gamma correction (every shader's tail)
    bg = jnp.power(jnp.asarray(params.background, jnp.float32), params.gamma)
    if params.mode != RenderMode.ISOSURFACE:
        colour = alpha[..., None] * colour + (1.0 - alpha)[..., None] * bg
    return jnp.power(jnp.clip(colour, 0.0, 1.0), 1.0 / params.gamma)


def cpu_device():
    """The CPU jax device (or None if that backend is unavailable).

    Any render issued from the serving/streaming path must pass this as
    ``render_volume(device=...)``: the display path must not contend with
    the processing stream on the card, and the reference's display path
    never stalls processing either (glwindow3d.cpp:316-323).
    """
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None


def cpu_pinned():
    """Context manager scoping jax dispatch to the CPU backend (a no-op
    when that backend is unavailable) — the shared form of the
    serving-path pin rule above for code that runs whole jnp blocks, not
    just render_volume."""
    import contextlib

    dev = cpu_device()
    return (jax.default_device(dev) if dev is not None
            else contextlib.nullcontext())


def render_volume(
    volume,
    params: RenderParams = RenderParams(),
    yaw: float = 0.0,
    pitch: float = 0.0,
    out_shape: Tuple[int, int] = (512, 512),
    lut: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """Render a processed volume (bscans, ascans, depth; float 0..1) to an
    (H, W, 3) float RGB image.  yaw/pitch in radians (trackball analog).

    ``device``: an explicit ``jax.Device`` to run the raycast on.  A live
    viewer passes a CPU device so rendering never contends with the
    processing stream on the card (the reference's display path never
    stalls processing either, glwindow3d.cpp:316-323); viz/live.py does
    this.
    """

    def go():
        vol = jnp.clip(jnp.asarray(volume, jnp.float32), 0.0, 1.0)
        rot = jnp.asarray(_rotation(yaw, pitch))
        if params.mode == RenderMode.OCT_DEPTH:
            depth_tex = compute_sample_depths(vol, params.depth_threshold)
        else:
            depth_tex = jnp.zeros((1, 1, 1), jnp.float32)
        lut_arr = None if lut is None else jnp.asarray(lut, jnp.float32)
        return np.asarray(_render(vol, depth_tex, rot, lut_arr, params,
                                  out_shape))

    if device is not None:
        # default_device scopes placement of the (host numpy) inputs; the
        # jitted raycast then compiles and runs on that device
        with jax.default_device(device):
            return go()
    return go()
