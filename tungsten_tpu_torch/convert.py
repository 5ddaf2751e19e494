"""Carry a scene across from the JAX package.

`flatten(obj)` turns a tree of frozen dataclasses (the JAX package's Scene,
or this package's) into a flat dict keyed by dataclass field path, e.g.
"media.0.gp.cov.sigma": every array leaf becomes a numpy array (through
`np.asarray`, so JAX arrays convert without importing JAX), Python values
stay as they are, and each dataclass adds a "<path>__type__" entry with its
class name.  `scene_from_numpy(tree)` builds this package's Scene from such
a dict, so both renderers compute from the same parameters; every tensor
of it is a leaf of its own, which a caller may mark `requires_grad`.
`set_params(scene, sigma, l)` puts other GP hyperparameters into a scene,
as the JAX package's gradient checks do; `coeffs_from_numpy` carries
conditioning coefficients across.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import bsdfs as bs
from .models import media as md
from .models import primitives as pr
from .models.camera import Camera
from .models.integrator import Scene
from .ops import sparse_conv as sc
from .ops.covariance import SquaredExponentialCov
from .ops.fields import RAMPS, Field
from .ops.means import HomogeneousMean, SphericalMean
from .ops.nonstationary import ProceduralNonstationaryCov
from .scene.parse import check_device


def flatten(obj, prefix=""):
    out = {}
    if dataclasses.is_dataclass(obj):
        out[prefix + "__type__"] = type(obj).__name__
        for f in dataclasses.fields(obj):
            out.update(flatten(getattr(obj, f.name), f"{prefix}{f.name}."))
    elif isinstance(obj, (tuple, list)):
        out[prefix + "__len__"] = len(obj)
        for i, v in enumerate(obj):
            out.update(flatten(v, f"{prefix}{i}."))
    elif obj is None or isinstance(obj, (str, bool, int, float)):
        out[prefix[:-1]] = obj
    elif isinstance(obj, torch.Tensor):
        out[prefix[:-1]] = obj.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(obj)
    return out


def _require(cond, what):
    if not cond:
        raise NotImplementedError(f"{what} is not ported to "
                                  "tungsten_tpu_torch")


def _field(tree, f, t):
    """The Field at path prefix `f` (a constant or a log-space ramp)."""
    kind, noise = tree[f + "kind"], tree[f + "noise"]
    _require(not tree[f + "is_vector"]
             and (kind == "constant" or (kind == "noise" and noise in RAMPS)),
             f"a {'vector ' if tree[f + 'is_vector'] else ''}{kind} field"
             + (f" {noise!r}" if kind == "noise" else ""))
    return Field(**{k: t(f + k) for k in (
        "value", "mn", "mx", "start", "end", "mn2", "mx2", "start2",
        "end2")}, kind=kind, noise=noise)


def _cov(tree, c, t):
    """The covariance at path prefix `c`: squared-exponential, or procedural
    nonstationary over one in multi-resolution mode."""
    if tree[c + "__type__"] == "ProceduralNonstationaryCov":
        _require(tree[c + "use_multi_res_grid"],
                 "brute-force nonstationary sampling")
        return ProceduralNonstationaryCov(
            base=_cov(tree, c + "base.", t),
            var_field=_field(tree, c + "var_field.", t),
            ls_field=_field(tree, c + "ls_field.", t),
            max_ls=tree[c + "max_ls"])
    _require(tree[c + "__type__"] == "SquaredExponentialCov"
             and not tree[c + "use_aniso_mtx"], "this covariance")
    return SquaredExponentialCov(
        sigma=t(c + "sigma"), l=t(c + "l"), aniso=t(c + "aniso"),
        kernel_scale=tree[c + "kernel_scale"])


def _gp(tree, g, t):
    """The GP (mean and covariance) at path prefix `g`; a CSG union's
    additional min-mean, which only its function-space children leave
    unread, is dropped."""
    mean_type = tree[g + "mean.__type__"]
    if mean_type == "SphericalMean":
        mean = SphericalMean(center=t(g + "mean.center"),
                             radius=t(g + "mean.radius"))
    else:
        _require(mean_type == "HomogeneousMean", f"a {mean_type}")
        mean = HomogeneousMean(offset=t(g + "mean.offset"))
    return sc.GP(mean=mean, cov=_cov(tree, g + "cov.", t))


def scene_from_numpy(tree, device="cuda"):
    """This package's Scene from a flattened JAX Scene (see `flatten`)."""
    device = check_device(device)

    def t(key, dtype=torch.float32):
        return torch.as_tensor(np.array(tree[key]), dtype=dtype,
                               device=device)

    _require(tree["env.kind"] == 0, "an environment light")
    _require(not tree["prims.mesh.has"], "a triangle mesh")
    _require(tree["low_order_scattering"] and tree["include_surfaces"],
             "low_order_scattering / include_surfaces = false")
    kinds = np.asarray(tree["prims.kind"])
    _require(np.isin(kinds, (pr.PRIM_QUAD, pr.PRIM_CUBE)).all(),
             f"primitive kinds {sorted(set(kinds.tolist()))}")
    bsdf_kinds = np.asarray(tree["bsdfs.kind"])
    _require(np.isin(bsdf_kinds, bs.KINDS).all(),
             f"bsdf kinds {sorted(set(bsdf_kinds.tolist()))}")
    # a mirror is ported as the phase function of a medium only
    mirrors = set(np.nonzero(bsdf_kinds == bs.MIRROR)[0].tolist())
    _require(not (mirrors - {tree[f"media.{i}.phase_bsdf"]
                             for i in range(tree["media.__len__"])}
                  or mirrors & set(np.asarray(tree["prims.bsdf"]).tolist())),
             "a mirror bsdf outside a BRDF phase function")
    _require(tree["camera.kind"] == "pinhole"
             and tree["camera.filter_kind"] == "box",
             "a non-pinhole camera or non-box filter")

    prims = pr.PrimitiveSoA(**{
        f.name: t(f"prims.{f.name}",
                  torch.int64 if f.name in ("kind", "bsdf", "int_medium",
                                            "ext_medium") else torch.float32)
        for f in dataclasses.fields(pr.PrimitiveSoA)})
    bsdfs = bs.BsdfTable(kind=t("bsdfs.kind", torch.int64),
                         albedo=t("bsdfs.albedo"),
                         kinds=tuple(int(k) for k in bsdf_kinds))

    media = []
    for i in range(tree["media.__len__"]):
        m = f"media.{i}."
        kind = tree[m + "kind"]
        _require(kind in (md.GPIS_SPARSE_CONV, md.GPIS_WEIGHT_SPACE,
                          md.GPIS_FUNCTION_SPACE)
                 and tree[m + "phase_kind"] == "brdf"
                 and tree[m + "normal_method"] == "conditioned_gaussian"
                 and tree[m + "law"] is None, "this medium configuration")
        c = m + "cfg."
        _require(not (tree[c + "surf_vol_phase_separate"] or (
            tree[c + "isotropic_3d"] and not tree[c + "isotropic_ray_3d"])),
            "plain isotropic or phase-separated sampling")
        cfg = sc.SparseConvConfig(
            global_seed=int(tree[c + "global_seed"]),
            impulse_density=t(c + "impulse_density"), ctxt=tree[c + "ctxt"],
            use_single_realization=tree[c + "use_single_realization"],
            impulse_count=tree[c + "impulse_count"],
            one_d=tree[c + "one_d"], scheme=tree[c + "scheme"],
            correlation_xy=tree[c + "correlation_xy"],
            isotropic_3d=tree[c + "isotropic_3d"])
        _require(not (cfg.one_d and kind == md.GPIS_WEIGHT_SPACE),
                 "1D sampling of a weight-space medium")
        _require(cfg.one_d or bsdf_kinds[tree[m + "phase_bsdf"]] != bs.MIRROR,
                 "a mirror phase function without 1D sampling")
        _require(kind == md.GPIS_WEIGHT_SPACE or not cfg.activate_conditioning
                 or not cfg.one_d or cfg.ctxt == sc.CTXT_RENEWAL_PLUS,
                 "renewal conditioning of 1D realizations")
        g = m + "gp."
        fs_kind = kind == md.GPIS_FUNCTION_SPACE
        csg = tree[g + "csg_right.__type__"] if (
            g + "csg_right.__type__") in tree else None
        _require(fs_kind or csg is None, "a CSG union outside function "
                 "space")
        _require(csg is not None
                 or g + "mean_additional.__type__" not in tree,
                 "an additional mean outside a CSG union")
        _require(all(tree[g + k] is None for k in (
            "global_cond", "color_field", "emission_field")),
            "a conditioned or colored GP")
        gp = _gp(tree, g, t)
        if csg is not None:
            gp = dataclasses.replace(gp, csg_right=_gp(tree, g + "csg_right.",
                                                       t))
        cov = gp.cov
        _require(csg is None or gp.csg_right.cov.is_stationary,
                 "a nonstationary covariance in a CSG union")
        _require(cov.is_stationary or (
            kind == md.GPIS_SPARSE_CONV
            and not (cfg.one_d or cfg.activate_conditioning
                     or cfg.isotropic_3d)),
            "a nonstationary covariance in weight or function space, with "
            "1D or isotropic sampling or with conditioning")
        _require(float(tree[c + "base"]) == sc.MULTI_RES_BASE,
                 "another multi-resolution base")
        _require(not fs_kind or (
            cfg.ctxt in (sc.CTXT_RENEWAL, sc.CTXT_RENEWAL_PLUS)
            and tree[m + "skip_space"] == 0.0),
            "a function-space medium under the Global or None context or "
            "with skip_space")
        bounds = (None if tree[m + "bounds"] is None
                  else t(m + "bounds"))
        media.append(md.Medium(
            sigma_a=t(m + "sigma_a"), sigma_s=t(m + "sigma_s"),
            density=t(m + "density"), step_size=t(m + "step_size"),
            cfg=cfg, gp=gp, bounds=bounds,
            phase_bsdf=tree[m + "phase_bsdf"], min_step=tree[m + "min_step"],
            max_march_steps=tree[m + "max_march_steps"], kind=kind,
            basis_functions=tree[m + "basis_functions"],
            ws_sphere_trace=tree[m + "ws_sphere_trace"],
            sample_points=tree[m + "sample_points"]))

    camera = Camera(transform=t("camera.transform"),
                    fov_deg=t("camera.fov_deg"), res_x=tree["camera.res_x"],
                    res_y=tree["camera.res_y"])
    return Scene(
        prims=prims, bsdfs=bsdfs, media=tuple(media), camera=camera,
        lights=t("lights", torch.int64),
        scene_seed=int(tree["scene_seed"]),
        max_bounces=tree["max_bounces"], min_bounces=tree["min_bounces"],
        enable_light_sampling=tree["enable_light_sampling"],
        enable_volume_light_sampling=tree["enable_volume_light_sampling"],
        cam_medium=tree["cam_medium"], shadow_hops=tree["shadow_hops"])


def coeffs_from_numpy(c, device="cuda"):
    """This package's sc.Coeffs from conditioning coefficients with the
    fields value_scale [R], gradient_scale [R, 3] and ray_origin [R, 3] (the
    JAX package's batched Coeffs, or any tree of arrays with those
    fields)."""
    device = check_device(device)
    return sc.Coeffs(**{
        k: torch.as_tensor(np.array(getattr(c, k)), dtype=torch.float32,
                           device=device)
        for k in ("value_scale", "gradient_scale", "ray_origin")})


def set_params(scene, sigma, l):
    """The scene with medium 0's covariance amplitude sigma and length
    scale l replaced (scalar tensors, e.g. leaves that require grad): the
    counterpart of the JAX package's `set_params` in gradcheck.py.  A
    procedural nonstationary covariance (config 5) takes them on its
    stationary base, whose fields scale them."""
    med = scene.media[0]
    cov = med.gp.cov
    if cov.is_stationary:
        cov = dataclasses.replace(cov, sigma=sigma, l=l)
    else:
        cov = dataclasses.replace(cov, base=dataclasses.replace(
            cov.base, sigma=sigma, l=l))
    med = dataclasses.replace(med, gp=dataclasses.replace(med.gp, cov=cov))
    return dataclasses.replace(scene, media=(med,) + tuple(scene.media[1:]))
