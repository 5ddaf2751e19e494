"""Carry a scene across from the JAX package.

`flatten(obj)` turns a tree of frozen dataclasses (the JAX package's Scene,
or this package's) into a flat dict keyed by dataclass field path, e.g.
"media.0.gp.cov.sigma": every array leaf becomes a numpy array (through
`np.asarray`, so JAX arrays convert without importing JAX), Python values
stay as they are, and each dataclass adds a "<path>__type__" entry with its
class name.  `scene_from_numpy(tree)` builds this package's Scene from such
a dict, so both renderers compute from the same parameters; every tensor
of it is a leaf of its own, which a caller may mark `requires_grad`.
`gp_from_numpy` does the same for one object of the GP layer (a GP with
its mesh conditioning, a covariance, a mean or a field).
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
from .ops import covariance as cv
from .ops import gp as gpmod
from .ops import means as mn
from .ops import nonstationary as ns
from .ops import sparse_conv as sc
from .ops.fields import Field
from .scene.parse import check_cov, check_device


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


# the port's class of each GP-layer class of the JAX package, by name;
# their fields have the JAX package's names
_GP_CLASSES = {c.__name__: c for c in (
    cv.SquaredExponentialCov, cv.RationalQuadraticCov, cv.MaternCov,
    cv.GaborAnisoCov, cv.GaborIsoCov, cv.PeriodicCov, cv.ThinPlateCov,
    cv.DotProductCov, ns.ProceduralNonstationaryCov,
    ns.MeanGradNonstationaryCov, ns.NeuralNonstationaryCov,
    mn.HomogeneousMean, mn.SphericalMean, mn.LinearMean, mn.ProceduralMean,
    mn.TabulatedMean, mn.NeuralMean, Field, sc.GP, gpmod.GlobalCond)}
# Field leaves that only their kind reads (None otherwise, as parsed)
_FIELD_LEAVES = {"grid": ("grid", "bounds_min", "bounds_max"),
                 "sdf": ("offset", "scale")}


def _leaf(tree, key, t):
    """The leaf at `key`: a nested GP-layer object, a tuple, a tensor (an
    array) or a Python value."""
    if key + ".__type__" in tree:
        return _gp_obj(tree, key + ".", t)
    if key + ".__len__" in tree:
        return tuple(_leaf(tree, f"{key}.{i}", t)
                     for i in range(tree[key + ".__len__"]))
    v = tree[key]
    return t(key) if isinstance(v, np.ndarray) else v


def _gp_obj(tree, prefix, t):
    """The GP, covariance, mean or field at path prefix `prefix`."""
    name = tree[prefix + "__type__"]
    _require(name in _GP_CLASSES, f"a {name}")
    cls = _GP_CLASSES[name]
    skip = set()
    if cls is Field:
        kind = tree[prefix + "kind"]
        skip = {k for kk, ks in _FIELD_LEAVES.items() if kk != kind
                for k in ks}
    elif cls is cv.SquaredExponentialCov and not tree[prefix
                                                      + "use_aniso_mtx"]:
        skip = {"aniso_mtx"}
    obj = cls(**{f.name: (None if f.name in skip
                          else _leaf(tree, prefix + f.name, t))
                 for f in dataclasses.fields(cls)})
    if cls is gpmod.GlobalCond:
        # the row kinds are integers
        obj = dataclasses.replace(obj, dts=obj.dts.to(torch.int64))
    return obj


def gp_from_numpy(tree, device="cuda"):
    """This package's GP, covariance, mean or field from the flattened
    (`flatten`) object of the JAX package's GP layer."""
    device = check_device(device)
    return _gp_obj(tree, "", lambda key: torch.as_tensor(
        np.array(tree[key]), dtype=torch.float32, device=device))


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
                 and tree[m + "normal_method"] in md.NORMAL_METHODS
                 and tree[m + "law"] is None, "this medium configuration")
        c = m + "cfg."
        cfg = sc.SparseConvConfig(
            global_seed=int(tree[c + "global_seed"]),
            impulse_density=t(c + "impulse_density"), ctxt=tree[c + "ctxt"],
            use_single_realization=tree[c + "use_single_realization"],
            impulse_count=tree[c + "impulse_count"],
            one_d=tree[c + "one_d"], scheme=tree[c + "scheme"],
            correlation_xy=tree[c + "correlation_xy"],
            isotropic_3d=tree[c + "isotropic_3d"],
            isotropic_ray_3d=tree[c + "isotropic_ray_3d"],
            surf_vol_phase_separate=tree[c + "surf_vol_phase_separate"],
            surf_vol_phase_amp_thresh=float(
                tree[c + "surf_vol_phase_amp_thresh"]))
        _require(not (cfg.one_d and kind == md.GPIS_WEIGHT_SPACE),
                 "1D sampling of a weight-space medium")
        fs_kind = kind == md.GPIS_FUNCTION_SPACE
        gp = _gp_obj(tree, m + "gp.", t)
        _require(gp.csg_right is None or gp.csg_right.csg_right is None,
                 "a nested CSG union")
        for child in (gp, gp.csg_right):
            if child is not None:
                check_cov(child.cov, kind, tree[m + "normal_method"])
        _require(float(tree[c + "base"]) == sc.MULTI_RES_BASE,
                 "another multi-resolution base")
        _require(not (fs_kind and cfg.ctxt == sc.CTXT_GLOBAL
                      and gp.csg_right is not None),
                 "a CSG union under the Global context")
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
            sample_points=tree[m + "sample_points"],
            skip_space=float(tree[m + "skip_space"]),
            normal_method=tree[m + "normal_method"]))

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
