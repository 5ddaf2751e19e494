"""Tungsten JSON scene -> Scene (the subset of tungsten_tpu/scene/parse.py
that BASELINE config 1, `scenes/gpis-sphere-box.json`, config 2,
`scenes/gpis-ensemble.json`, config 4a, `scenes/gpis-weight-space.json`,
configs 3 and 3b, `scenes/gpis-mirror-1d{,-corrxy}.json`, config 4b,
`scenes/gpis-function-space.json` and its CSG union `scenes/gpis-csg.json`,
and config 5, the hero `scenes/gpis-hero.json`, use, with every
covariance, mean, field, normal method, sampling space and correlation
context of the JAX package's GP layer, mesh conditioning
(`conditioning_data`), the function-space skip (`skip_space`), the
surface/volume phase id and mirror surfaces and phases).

Host-side numpy, computed as the JAX package computes it, then moved to
`device` (the card unless the caller asks for the CPU; asking for `cuda`
without one raises).  Any type or option the port does not implement yet
raises NotImplementedError naming it: nothing is silently ignored.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch

from ..models import bsdfs as bs
from ..models import media as md
from ..kernels import psd
from ..models import primitives as pr
from ..models.camera import Camera
from ..models.integrator import Scene
from ..io import meshio
from ..ops import covariance as cv
from ..ops import gp as gpmod
from ..ops import means as mn
from ..ops import nonstationary as ns
from ..ops import sdf
from ..ops import sparse_conv as sc
from ..ops.fields import Field, parse_field
from ..ops.mesh_sdf import bake_mesh_sdf

DEFAULT_SEED = 0xBA5EBA11


def _unsupported(what):
    return NotImplementedError(f"{what} is not ported to tungsten_tpu_torch")


def check_device(device):
    """torch.device for `device`; raises if it is CUDA and none is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but no CUDA device "
                           "is available")
    return device


def _f32(x, device):
    return torch.tensor(np.float32(x), device=device)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def _gram_schmidt(a, b, c):
    a = a / max(np.linalg.norm(a), 1e-20)
    b = b - a * a.dot(b)
    if np.linalg.norm(b) < 1e-5:
        b = np.cross(c, a)
    else:
        b = b / np.linalg.norm(b)
    c = c - a * a.dot(c)
    c = c - b * b.dot(c)
    if np.linalg.norm(c) < 1e-5:
        c = np.cross(a, b)
    else:
        c = c / np.linalg.norm(c)
    return a, b, c


def _rot_yxz(rot):
    r = np.asarray(rot, np.float64) * math.pi / 180.0
    c = np.cos(r)
    s = np.sin(r)
    return np.array([
        [c[1] * c[2] - s[1] * s[0] * s[2],
         -c[1] * s[2] - s[1] * s[0] * c[2], -s[1] * c[0]],
        [c[0] * s[2], c[0] * c[2], -s[0]],
        [s[1] * c[2] + c[1] * s[0] * s[2],
         -s[1] * s[2] + c[1] * s[0] * c[2], c[1] * c[0]],
    ], np.float32)


def parse_transform(v) -> np.ndarray:
    """JSON transform -> 4x4 float32 matrix (Tungsten's JsonPtr rules)."""
    if v is None:
        return np.eye(4, dtype=np.float32)
    if isinstance(v, list):
        return np.asarray(v, np.float32).reshape(4, 4)
    x = np.array([1.0, 0, 0])
    y = np.array([0, 1.0, 0])
    z = np.array([0, 0, 1.0])
    pos = np.asarray(v.get("position", (0, 0, 0)), np.float64)
    ex = ey = ez = False
    if "look_at" in v:
        z, ez = np.asarray(v["look_at"], np.float64) - pos, True
    if "up" in v:
        y, ey = np.asarray(v["up"], np.float64), True
    if "x_axis" in v:
        x, ex = np.asarray(v["x_axis"], np.float64), True
    if "y_axis" in v:
        y, ey = np.asarray(v["y_axis"], np.float64), True
    if "z_axis" in v:
        z, ez = np.asarray(v["z_axis"], np.float64), True
    case = (4 if ez else 0) + (2 if ey else 0) + (1 if ex else 0)
    if case == 0 or case >= 4 and case != 5:
        z, y, x = _gram_schmidt(z, y, x)
    elif case == 1:
        x, z, y = _gram_schmidt(x, z, y)
    elif case == 2:
        y, z, x = _gram_schmidt(y, z, x)
    elif case == 3:
        y, x, z = _gram_schmidt(y, x, z)
    elif case == 5:
        z, x, y = _gram_schmidt(z, x, y)
    if np.cross(x, y).dot(z) < 0:
        if not ex:
            x = -x
        elif not ey:
            y = -y
        else:
            z = -z
    scale = v.get("scale")
    if scale is not None:
        s = np.asarray(scale, np.float64)
        if s.ndim == 0:
            s = np.array([s, s, s])
        x, y, z = x * s[0], y * s[1], z * s[2]
    rot = v.get("rotation")
    if rot is not None:
        m = _rot_yxz(rot)
        x, y, z = m @ x, m @ y, m @ z
    tf = np.eye(4, dtype=np.float32)
    tf[:3, 0], tf[:3, 1], tf[:3, 2], tf[:3, 3] = x, y, z, pos
    return tf


def _rgb(v, default=(1.0, 1.0, 1.0)):
    if v is None:
        return np.asarray(default, np.float32)
    a = np.asarray(v, np.float32)
    if a.ndim == 0:
        return np.array([a, a, a], np.float32)
    return a


# ---------------------------------------------------------------------------
# BSDFs, GP, media
# ---------------------------------------------------------------------------

_BSDF_KINDS = {"null": bs.NULL, "lambert": bs.LAMBERT, "mirror": bs.MIRROR,
               "forward": bs.FORWARD}


def parse_bsdf(b: dict) -> dict:
    t = b.get("type", "lambert")
    if t not in _BSDF_KINDS:
        raise _unsupported(f"bsdf type {t!r}")
    return {"kind": _BSDF_KINDS[t],
            "albedo": _rgb(b.get("albedo"), (0.8, 0.8, 0.8))}


def _t32(x, device):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def parse_mean(m: dict, device, base_dir="."):
    t = m.get("type", "homogeneous")
    if t == "homogeneous":
        return mn.HomogeneousMean(offset=_f32(m.get("offset", 0.0), device))
    if t == "spherical":
        return mn.SphericalMean(center=_t32(m.get("center", (0, 0, 0)),
                                            device),
                                radius=_f32(m.get("radius", 1.0), device))
    if t == "linear":
        d = np.asarray(m.get("direction", (1, 0, 0)), np.float32)
        return mn.LinearMean(ref=_t32(m.get("reference_point", (0, 0, 0)),
                                      device),
                             dir=_t32(d / np.linalg.norm(d), device),
                             scale=_f32(m.get("scale", 1.0), device),
                             min=_f32(m.get("min", -3.0e38), device))
    if t == "procedural":
        fn = m.get("func", m.get("function", "knob"))
        if fn not in sdf.FUNCTIONS:
            raise KeyError(fn)
        inv = np.linalg.inv(parse_transform(m.get("transform")))
        return mn.ProceduralMean(transform=_t32(inv, device),
                                 offset=_f32(m.get("offset", 0.0), device),
                                 scale=_f32(m.get("scale", 1.0), device),
                                 min=_f32(m.get("min", -3.0e38), device),
                                 fn_name=fn)
    if t == "mesh":
        # the mesh's SDF baked to a grid at load, served as a TabulatedMean
        mesh = meshio.load_mesh(os.path.join(base_dir, m["file"]))
        tf = parse_transform(m.get("transform"))
        pos = (np.asarray(mesh["pos"], np.float32) @ tf[:3, :3].T
               + tf[:3, 3][None, :])
        grid, bmin, bmax = bake_mesh_sdf(
            pos, mesh["tris"], res=int(m.get("grid_res", 64)),
            signed=bool(m.get("signed", True)), device=device)
        return _tabulated(grid, bmin, bmax, m, device)
    if t in ("tabulated", "grid"):
        g = m.get("grid", {})
        return _tabulated(np.asarray(g.get("data"), np.float32),
                          g.get("bounds_min", (0, 0, 0)),
                          g.get("bounds_max", (1, 1, 1)), m, device)
    raise _unsupported(f"mean type {t!r}")


def _tabulated(values, bmin, bmax, m, device):
    return mn.TabulatedMean(values=_t32(values, device),
                            bounds_min=_t32(bmin, device),
                            bounds_max=_t32(bmax, device),
                            offset=_f32(m.get("offset", 0.0), device),
                            scale=_f32(m.get("scale", 1.0), device))


def _grid_variance(c, device):
    """The variance field of the `nonstationary` type: a dense grid inline
    or from a .npy / .npz file, times `scale` plus `offset`."""
    gdoc = c.get("grid", c.get("variance"))
    offset = float(c.get("offset", 0.0))
    scale = float(c.get("scale", 1.0))
    if isinstance(gdoc, dict) and "data" in gdoc:
        data = np.asarray(gdoc["data"], np.float32) * scale + offset
        return Field.regular_grid(data, gdoc.get("bounds_min", (0, 0, 0)),
                                  gdoc.get("bounds_max", (1, 1, 1)),
                                  device)
    if isinstance(gdoc, str):
        if gdoc.endswith(".vdb"):
            raise ValueError(f"{gdoc}: a raw .vdb grid must be densified "
                             "to .npz first")
        arr = np.load(gdoc if os.path.isabs(gdoc)
                      else os.path.join(c.get("__dir__", "."), gdoc))
        if hasattr(arr, "files"):
            data = arr["data"] * scale + offset
            bmin = (arr["bounds_min"] if "bounds_min" in arr.files
                    else np.zeros(3))
            bmax = (arr["bounds_max"] if "bounds_max" in arr.files
                    else np.ones(3))
        else:
            data = arr * scale + offset
            bmin, bmax = np.zeros(3), np.ones(3)
        return Field.regular_grid(data, bmin, bmax, device)
    return None


def parse_cov(c: dict, device, base_dir="."):
    t = c.get("type", "squared_exponential")
    aniso = _t32(c.get("aniso", (1.0, 1.0, 1.0)), device)
    ks = float(c.get("localScale", 3.0))
    sigma = _f32(c.get("sigma", 1.0), device)
    length = _f32(c.get("lengthScale", 1.0), device)

    def base():
        return parse_cov(c.get("cov", {"type": "squared_exponential"}),
                         device, base_dir)
    if t == "squared_exponential":
        mtx = c.get("anisoMtx")
        return cv.SquaredExponentialCov(
            sigma=sigma, l=length, aniso=aniso, kernel_scale=ks,
            aniso_mtx=None if mtx is None else _t32(mtx, device))
    if t == "rational_quadratic":
        return cv.RationalQuadraticCov(sigma=sigma, l=length,
                                       a=_f32(c.get("a", 1.0), device),
                                       aniso=aniso, kernel_scale=ks)
    if t == "matern":
        return cv.MaternCov(sigma=sigma, l=length,
                            nu=_f32(c.get("v", 1.5), device), aniso=aniso,
                            kernel_scale=ks)
    if t in ("proc_nonstationary", "nonstationary"):
        b = base()
        if not hasattr(b, "kernel_scale"):
            raise _jax_fails(f"a {t} covariance over a {type(b).__name__} "
                             "(no kernel_scale)")
        var = (parse_field(c.get("var"), device) if t == "proc_nonstationary"
               else _grid_variance(c, device))
        return ns.ProceduralNonstationaryCov.create(
            b, device, var_field=var, ls_field=parse_field(c.get("ls"), device),
            use_multi_res_grid=bool(c.get("multiResolutionGrid", False)))
    if t == "mg_nonstationary":
        return ns.MeanGradNonstationaryCov(
            base=base(), mean=parse_mean(c.get("mean", {}), device, base_dir),
            aniso=_t32(c.get("aniso", (1.0, 1.0, 1.0)), device))
    if t == "neural_nonstationary":
        layers = c.get("network", {}).get("layers", [])
        return ns.NeuralNonstationaryCov(
            base=base(), weights=tuple((_t32(L["w"], device),
                                        _t32(L["b"], device))
                                       for L in layers),
            transform=torch.eye(4, dtype=torch.float32, device=device))
    if t == "gabor_aniso":
        om = np.asarray(c.get("omega", (1, 0, 0)), np.float32)
        om = om / max(np.linalg.norm(om), 1e-9)
        return cv.GaborAnisoCov(
            sigma=sigma, a=_f32(1.0 / c.get("a_inv", 1.0), device),
            f=_f32(1.0 / c.get("f_inv", 1.0), device),
            omega=_t32(om, device), kernel_scale=ks)
    if t == "gabor_iso":
        return cv.GaborIsoCov(
            sigma=sigma, a=_f32(1.0 / c.get("a_inv", 1.0), device),
            f=_f32(1.0 / c.get("f_inv", 1.0), device), kernel_scale=ks)
    if t == "periodic":
        return cv.PeriodicCov(sigma=sigma, l=length,
                              period=_f32(c.get("period", 1.0), device))
    if t == "thin_plate":
        return cv.ThinPlateCov(sigma=sigma, R=_f32(c.get("R", 1.0), device))
    if t == "dot_product":
        return cv.DotProductCov(sigma=sigma, c=_f32(c.get("c", 1.0), device))
    raise _unsupported(f"covariance type {t!r}")


def parse_gp(g: dict, device, base_dir=".") -> sc.GP:
    t = g.get("type", "standard")
    if t == "csg":
        # the union of two GPs: the left child's, holding the right one
        # (function space marches both) and its mean as the additional
        # min-mean (sparse-conv and weight space)
        left = parse_gp(g["left"], device, base_dir)
        right = parse_gp(g["right"], device, base_dir)
        if left.csg_right is not None or right.csg_right is not None:
            raise _unsupported("a nested CSG union")
        return dataclasses.replace(left, mean_additional=right.mean,
                                   csg_right=right)
    if t != "standard":
        raise _unsupported(f"gaussian_process type {t!r}")
    mdoc = g.get("mean", {})
    gp = sc.GP(mean=parse_mean(mdoc, device, base_dir),
               cov=parse_cov(g.get("covariance", {}), device, base_dir),
               color_field=parse_field(mdoc.get("color"), device,
                                       is_vector=True),
               emission_field=parse_field(mdoc.get("emission"), device,
                                          is_vector=True))
    if "conditioning_data" in g:
        gp = dataclasses.replace(gp, global_cond=_global_cond(
            gp, g, device, base_dir))
    return gp


def _global_cond(gp, g, device, base_dir):
    """The GP's conditioning on the unique vertices (rounded to 1e-6) of
    the mesh `conditioning_data` (relative to the scene's directory), at
    most `conditioning_max_points` of them (1024; a seeded choice beyond),
    with their unit normals: solved once here (ops/gp.py)."""
    mesh = meshio.load_mesh(os.path.join(base_dir, g["conditioning_data"]))
    pos = np.asarray(mesh["pos"], np.float32)
    nrm = np.asarray(mesh["normal"], np.float32)
    pos_u, idx = np.unique(pos.round(6), axis=0, return_index=True)
    nrm_u = nrm[idx]
    cap = int(g.get("conditioning_max_points", 1024))
    if len(pos_u) > cap:
        sel = np.random.default_rng(0).choice(len(pos_u), cap, replace=False)
        pos_u, nrm_u = pos_u[sel], nrm_u[sel]
    nrm_u = nrm_u / np.maximum(
        np.linalg.norm(nrm_u, axis=-1, keepdims=True), 1e-9)
    return gpmod.build_global_cond(gp, _t32(pos_u, device),
                                   _t32(nrm_u, device))


_CTXT = {"global": sc.CTXT_GLOBAL, "renewal+": sc.CTXT_RENEWAL_PLUS,
         "renewal": sc.CTXT_RENEWAL, "none": sc.CTXT_NONE,
         "goldfish": sc.CTXT_RENEWAL_PLUS}
_SCHEME = {"uni": sc.SCHEME_UNI, "nee": sc.SCHEME_NEE, "mis": sc.SCHEME_MIS,
           "UNI": sc.SCHEME_UNI, "NEE": sc.SCHEME_NEE, "MIS": sc.SCHEME_MIS}


_MEDIUM_KINDS = {"sparse_conv_noise": md.GPIS_SPARSE_CONV,
                 "weight_space_gaussian_process": md.GPIS_WEIGHT_SPACE,
                 "weight_space": md.GPIS_WEIGHT_SPACE,
                 "function_space_gaussian_process": md.GPIS_FUNCTION_SPACE,
                 "function_space": md.GPIS_FUNCTION_SPACE,
                 "gaussian_process": md.GPIS_FUNCTION_SPACE}


def _check_function_space(gp, ctxt, m):
    """Refuse what the function-space medium does not run."""
    if ctxt == sc.CTXT_GLOBAL and gp.csg_right is not None:
        raise _jax_fails("a CSG union under the Global context of a "
                         "function-space medium")
    n = int(m.get("sample_points", 32))
    if not 2 <= n <= psd.MAX_N - 2:
        raise _unsupported(f"sample_points {n} (K8 solves at most "
                           f"{psd.MAX_N}-square systems: 2 to "
                           f"{psd.MAX_N - 2} points)")


def _jax_fails(what):
    """A combination the JAX package itself cannot render: refused by
    name (ROADMAP queue 3 lists each with the test that shows it)."""
    return NotImplementedError(f"{what}: the JAX package cannot render it "
                               "either, so it is not ported")


_CLOSED_FORM = (cv.SquaredExponentialCov, cv.RationalQuadraticCov,
                cv.MaternCov)
_WRAPPERS = (ns.ProceduralNonstationaryCov, ns.MeanGradNonstationaryCov,
             ns.NeuralNonstationaryCov)


def check_cov(cov, kind, normal):
    """Refuse the covariances the JAX package fails on in medium `kind`
    with normal method `normal`."""
    name = type(cov).__name__
    covs = (cov, cov.base) if isinstance(cov, _WRAPPERS) else (cov,)
    if isinstance(cov, _WRAPPERS):
        name = f"{name} over a {type(cov.base).__name__}"
    for c in covs:
        if isinstance(c, cv.MaternCov):
            nu = np.float32(float(c.nu))
            w = sum(np.exp(-np.float32((nu - k) * (nu - k)) * 1e6,
                           dtype=np.float32) for k in (0.5, 1.5, 2.5))
            if w == 0:
                raise _jax_fails(f"Matern nu = {nu} (its covariance is "
                                 "0/0 = NaN outside nu 0.5, 1.5, 2.5)")
    if isinstance(cov, _WRAPPERS) and not isinstance(cov.base, _CLOSED_FORM):
        raise _jax_fails(f"a {name} (no cov_r2)")
    if kind == md.GPIS_FUNCTION_SPACE:
        return  # function space reads cov() alone; its normal is its own
    if kind == md.GPIS_SPARSE_CONV and not (
            isinstance(cov, cv.SquaredExponentialCov)
            or (isinstance(cov, ns.ProceduralNonstationaryCov)
                and isinstance(cov.base, cv.SquaredExponentialCov))):
        raise _jax_fails(f"a {name} on a sparse-conv medium (its fast "
                         "path has no quadratic splat form for it)")
    if isinstance(cov, (cv.PeriodicCov, cv.ThinPlateCov, cv.DotProductCov)):
        raise _jax_fails(f"a {name} on a {kind} medium (it has no "
                         "amplitude, which the sampling scheme reads)")
    if kind == md.GPIS_WEIGHT_SPACE:
        for c in covs:
            if isinstance(c, cv.RationalQuadraticCov) and not (
                    np.float32(float(c.a)) - np.float32(1.0 / 3.0) > 0):
                raise _jax_fails(f"rational_quadratic a = {float(c.a)} "
                                 "in weight space (its Gamma draw needs a "
                                 "> 1/3: NaN)")
    if normal in (md.NORMAL_BECKMANN, md.NORMAL_GGX) and any(
            isinstance(c, cv.MaternCov) for c in covs):
        raise _jax_fails(f"the {normal!r} normal over a Matern covariance "
                         "(it has no compute_beckmann_roughness)")


def parse_medium(m: dict, phase_bsdf: int, device, base_dir=".") -> md.Medium:
    t = m.get("type", "sparse_conv_noise")
    if t not in _MEDIUM_KINDS:
        raise _unsupported(f"medium type {t!r}")
    kind = _MEDIUM_KINDS[t]
    one_d = bool(m.get("1D_sampling", False))
    if one_d and kind != md.GPIS_SPARSE_CONV:
        raise _unsupported(f"1D sampling of a {kind} medium")
    scheme = m.get("1D_sampling_scheme", "uni")
    if scheme not in _SCHEME:
        raise _unsupported(f"1D_sampling_scheme {scheme!r}")
    if m.get("transmittance") is not None:
        raise _unsupported("medium option 'transmittance'")
    normal = m.get("normal_method", md.NORMAL_CONDITIONED)
    if normal not in md.NORMAL_METHODS:
        raise _unsupported(f"normal_method {normal!r}")
    ctxt = m.get("correlation_context", "renewal+")
    if ctxt not in _CTXT:
        raise _unsupported(f"correlation_context {ctxt!r}")
    cfg = sc.SparseConvConfig.create(
        global_seed=m.get("seed", 0),
        impulse_density=float(m.get("impulse_density", 3.0)), device=device,
        ctxt=_CTXT[ctxt],
        use_single_realization=bool(m.get("single_realization", False)),
        one_d=one_d, scheme=_SCHEME[scheme],
        correlation_xy=bool(m.get("1D_gradient_correlationXY", False)),
        isotropic_3d=bool(m.get("isotropic_3D_sampling", False)),
        surf_vol_phase_separate=bool(m.get("surf_vol_phase_separate",
                                           False)),
        surf_vol_phase_amp_thresh=float(m.get("surf_vol_phase_amp_thresh",
                                              0.0)))
    gp = parse_gp(m.get("gaussian_process", {}), device, base_dir)
    for child in (gp, gp.csg_right):
        if child is not None:
            check_cov(child.cov, kind, normal)
    if kind == md.GPIS_FUNCTION_SPACE:
        _check_function_space(gp, cfg.ctxt, m)
    step_size = float(m.get("step_size", 0.01))
    return md.Medium(
        sigma_a=torch.tensor(_rgb(m.get("sigma_a"), (0, 0, 0)), device=device),
        sigma_s=torch.tensor(_rgb(m.get("sigma_s"), (1, 1, 1)), device=device),
        density=_f32(m.get("density", 1.0), device),
        step_size=_f32(step_size, device),
        cfg=cfg, gp=gp, bounds=None, phase_bsdf=phase_bsdf,
        min_step=int(m.get("min_step", 8)), kind=kind,
        basis_functions=int(m.get("basis_functions", 300)),
        ws_sphere_trace=kind == md.GPIS_WEIGHT_SPACE and step_size == 0.0,
        sample_points=int(m.get("sample_points", 32)),
        skip_space=float(m.get("skip_space", 0.0)), normal_method=normal)


# ---------------------------------------------------------------------------
# Scene assembly
# ---------------------------------------------------------------------------

_PRIM_KINDS = {"quad": pr.PRIM_QUAD, "cube": pr.PRIM_CUBE}


def _prim_aabb(p):
    tf = np.asarray(p["transform"], np.float32)
    pos, lin = tf[:3, 3], tf[:3, :3]
    if p["kind"] == pr.PRIM_QUAD:
        e0 = lin @ np.array([1.0, 0, 0], np.float32)
        e1 = lin @ np.array([0, 0, 1.0], np.float32)
        base = pos - 0.5 * e0 - 0.5 * e1
        cs = np.stack([base, base + e0, base + e1, base + e0 + e1])
        return cs.min(0), cs.max(0)
    h = 0.5 * np.abs(lin).sum(axis=1)
    return pos - h, pos + h


def scene_from_dict(doc: dict, seed=DEFAULT_SEED, device="cuda"):
    """Returns (Scene, renderer settings dict)."""
    device = check_device(device)
    base_dir = doc.get("__dir__", ".")  # mesh files are read relative to it
    bsdf_list, bsdf_names = [], {}
    for b in doc.get("bsdfs", []):
        bsdf_names[b.get("name", f"bsdf{len(bsdf_names)}")] = len(bsdf_list)
        bsdf_list.append(parse_bsdf(b))

    def bsdf_index(ref):
        if isinstance(ref, str):
            return bsdf_names[ref]
        if isinstance(ref, dict):
            bsdf_list.append(parse_bsdf(ref))
            return len(bsdf_list) - 1
        return 0

    media, medium_names = [], {}
    for m in doc.get("media", []):
        pf = m.get("phase_function")
        if not isinstance(pf, dict) or pf.get("type") != "brdf":
            raise _unsupported(f"phase function {pf!r}")
        phase_bsdf = bsdf_index(pf.get("bsdf"))
        kind = bsdf_list[phase_bsdf]["kind"]
        if kind not in (bs.LAMBERT, bs.MIRROR):
            raise _unsupported("a BRDF phase function over a bsdf other "
                               "than lambert or mirror")
        medium_names[m.get("name", f"medium{len(media)}")] = len(media)
        media.append(parse_medium(m, phase_bsdf, device, base_dir))

    def medium_index(ref):
        if ref is None:
            return -1
        if not isinstance(ref, str):
            raise _unsupported("an inline medium")
        return medium_names[ref]

    prims = []
    for p in doc.get("primitives", []):
        t = p.get("type", "quad")
        if t not in _PRIM_KINDS:
            raise _unsupported(f"primitive type {t!r}")
        entry = {
            "kind": _PRIM_KINDS[t],
            "transform": parse_transform(p.get("transform")),
            "emission": _rgb(p.get("emission"), (0, 0, 0)),
            "bsdf": bsdf_index(p.get("bsdf", 0)),
            "int_medium": medium_index(p.get("int_medium")),
            "ext_medium": medium_index(p.get("ext_medium")),
        }
        if np.any(entry["emission"] > 0) and entry["kind"] != pr.PRIM_QUAD:
            raise _unsupported(f"an emissive {t!r}")
        prims.append(entry)

    cam_doc = doc.get("camera", {})
    if cam_doc.get("type", "pinhole") != "pinhole":
        raise _unsupported(f"camera type {cam_doc['type']!r}")
    filt = cam_doc.get("reconstruction_filter", "box")
    if filt != "box":
        raise _unsupported(f"reconstruction_filter {filt!r}")
    res = cam_doc.get("resolution", [512, 512])
    if isinstance(res, (int, float)):
        res = [int(res), int(res)]
    cam_tf = parse_transform(cam_doc.get("transform")).copy()
    # Tungsten's Camera::fromJson negates the right axis
    cam_tf[:3, 0] = -cam_tf[:3, 0]
    camera = Camera.create(cam_tf, cam_doc.get("fov", 60.0), res, device)
    cam_medium = medium_index(cam_doc.get("medium"))

    soa = pr.build_soa(prims, device)
    lights = np.nonzero(np.asarray([np.any(p["emission"] > 0.0)
                                    for p in prims], bool))[0]

    # each medium's march is clamped to the AABB of the prims that declare
    # it interior
    for mi in range(len(media)):
        boxes = [_prim_aabb(p) for p in prims if p["int_medium"] == mi]
        if boxes and mi != cam_medium:
            lo = np.min(np.stack([b[0] for b in boxes]), axis=0) - 1e-3
            hi = np.max(np.stack([b[1] for b in boxes]), axis=0) + 1e-3
            media[mi] = dataclasses.replace(
                media[mi], bounds=torch.tensor(np.stack([lo, hi]),
                                               device=device))

    integ = doc.get("integrator", {})
    itype = integ.get("type", "path_tracer")
    if itype != "path_tracer":
        raise _unsupported(f"integrator type {itype!r}")
    for key in ("low_order_scattering", "include_surfaces"):
        if not integ.get(key, True):
            raise _unsupported(f"integrator option {key!r} = false")
    scene = Scene(
        prims=soa, bsdfs=bs.build_table(bsdf_list, device),
        media=tuple(media), camera=camera,
        lights=torch.tensor(lights, dtype=torch.int64, device=device),
        scene_seed=int(seed) & 0xFFFFFFFF,
        max_bounces=int(integ.get("max_bounces", 64)),
        min_bounces=int(integ.get("min_bounces", 0)),
        enable_light_sampling=bool(integ.get("enable_light_sampling", True)),
        enable_volume_light_sampling=bool(
            integ.get("enable_volume_light_sampling", True)),
        cam_medium=cam_medium,
        shadow_hops=int(integ.get("shadow_hops", 3)))
    return scene, dict(doc.get("renderer", {}))


def load_scene(path, seed=DEFAULT_SEED, res_override=None, device="cuda"):
    """Load a scene file onto `device`; returns (Scene, renderer settings)."""
    with open(path) as f:
        doc = json.load(f)
    doc.setdefault("__dir__", os.path.dirname(os.path.abspath(path)))
    if res_override is not None:
        doc.setdefault("camera", {})["resolution"] = list(res_override)
    return scene_from_dict(doc, seed=seed, device=device)
