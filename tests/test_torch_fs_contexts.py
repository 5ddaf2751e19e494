"""The port's function-space Global and None contexts, its free-flight skip
and its mesh conditioning (tungsten_tpu_torch/ops/gp.py,
models/fs_medium.py) against tungsten_tpu/ops/gp.py and
tungsten_tpu/models/fs_medium.py on the CPU.

Ops, on seeded numpy inputs with the JAX package's mesh conditioning
carried across (`convert.gp_from_numpy`, so that both solve with the same
alpha and K11^+): the mesh-conditioned mean and covariance within 1e-4
(1 + |x|); through a further conditioning on two well-separated rows
the mean and the covariance (B B^T of each side's root) within 1e-3 of
the prior's scale (1), the cdf of the conditioned GP within 1e-3: the
conditioned covariance is the small difference of two terms of the
prior's size, which the JAX package sums over the mesh rows in float32
and the port in float64 (measured: up to 2.6e-4, 4.2e-4 and 8.0e-4); the
unconditioned cdf within 1e-5; the constrained sampler's pick equal and
its values within rtol 1e-5, atol 1e-6 on the same mean and root (the z
streams are the same hashes).  The port's own scene-load solve (float64) reproduces the
observations (value 0 at the vertices within 2e-2, normal derivative 1
within 5e-2) and shrinks the variance near them, as
tests/test_global_cond.py asks of the JAX package's.

Media: 48 rays per scene (config 4b under Global, None, skip_space 0.01,
and Global conditioned on a sphere mesh) over two segments, the second
going on from the first's end with the state (and the Global ring) the
first left.  JAX runs with its `gp._sqrt_psd` replaced, inside the test,
by the symmetric root the port takes (tests/test_torch_fs.py); the JAX
package is not edited.  Gates (the spread measured on these rays in
brackets): hit flags agree on 95% of rays (all), t within 2e-3 on 95%
of the rays where both hit (2.3e-5 to 6.5e-4) and within 1e-2 on all
(2.3e-3, one ray of fs-skip's second segment), the ring's row counts
equal on 95% (all) and its values within 5e-2 sigma (2.4e-2); the
normals' dot at least 0.99 where both hit (0.9994) but on the
mesh-conditioned scene, whose normal solves are ill-posed in float32
near the mesh (the covariance there is the cancellation above; JAX's
float32 sum and the port's float64 one leave the pseudo-inverse
different noise at its cut, and the tangential components drawn from
it differ run to run with the CPU's thread count): there the along-ray
component, pinned to the crossing's slope, within 1e-2 (1 + |x|) on 95%
of the rays (1.5e-3), and the ring values within 0.25 sigma (0.12).
The ring's size (FS_RING 4, 16, 32) as tests/test_global_cond.py checks
it: 16 and 32 agree (median |dt| < 0.05), 4 differs (see
`test_ring_size_converged`).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tungsten_tpu.io.meshio import make_sphere
from tungsten_tpu.models import media as jmd
from tungsten_tpu.ops import gp as jgp
from tungsten_tpu.ops import sparse_conv as jsc
from tungsten_tpu.ops.covariance import SquaredExponentialCov as JSE
from tungsten_tpu.ops.means import HomogeneousMean as JHom
from tungsten_tpu.scene.parse import load_scene as jload_scene
from tungsten_tpu_torch import convert, entry
from tungsten_tpu_torch.models import fs_medium as tfs
from tungsten_tpu_torch.models import media as tmd
from tungsten_tpu_torch.ops import gp as tgp
from tungsten_tpu_torch.scene.parse import scene_from_dict
from tungsten_tpu_torch.tools.gp_variants import variant_docs

VARIANTS = ("fs-global", "fs-none", "fs-skip", "fs-conditioned")
VALUE_RTOL = 5e-2


def sym_root(a, jitter=1e-5):
    w, v = jnp.linalg.eigh(a)
    return (v * jnp.sqrt(jnp.maximum(w, 1e-12))[None, :]) @ v.T


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _mesh(n_pts=24):
    m = make_sphere(radius=0.8, subdiv=6)
    pos = np.asarray(m["pos"], np.float32)
    nrm = np.asarray(m["normal"], np.float32)
    pos_u, idx = np.unique(pos.round(5), axis=0, return_index=True)
    sel = np.random.default_rng(0).choice(len(pos_u), n_pts, replace=False)
    nrm_u = nrm[idx][sel]
    nrm_u /= np.maximum(np.linalg.norm(nrm_u, axis=-1, keepdims=True), 1e-9)
    return pos_u[sel], nrm_u


@pytest.fixture(scope="module")
def gps():
    """(JAX GP with its mesh conditioning, the port's carried across, the
    vertices, normals)."""
    pos, nrm = _mesh()
    jg0 = jsc.GP(mean=JHom.create(offset=0.5),
                 cov=JSE.create(sigma=1.0, l=0.5))
    gc = jgp.build_global_cond(jg0, jgp.make_cov_fn(jg0), jnp.asarray(pos),
                               jnp.asarray(nrm))
    jg = jsc.GP(mean=jg0.mean, cov=jg0.cov, global_cond=gc)
    tg = convert.gp_from_numpy(convert.flatten(jg), device="cpu")
    return jg, tg, pos, nrm


def _queries(R, N, seed):
    r = np.random.default_rng(seed)
    pts = r.uniform(-1.0, 1.0, (R, N, 3)).astype(np.float32)
    dts = (r.uniform(size=(R, N)) < 0.3).astype(np.int32)
    dirs = r.normal(size=(R, N, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, dts, dirs


def test_mean_cov_gc_matches_jax(gps):
    jg, tg, _, _ = gps
    pts, dts, dirs = _queries(6, 5, 1)
    cov_fn = jgp.make_cov_fn(jg)
    jm, jK = jax.vmap(lambda p, d, u: jgp.mean_cov_gc(jg, cov_fn, p, d, u)[
        :2])(pts, dts, dirs)
    tm, tK, _ = tgp.mean_cov_gc(tg, *_t(pts, dts.astype(np.int64), dirs))
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tK.numpy(), jK, rtol=1e-4, atol=1e-4)


def test_conditional_and_prior_mvn_through_the_mesh_match_jax(gps):
    jg, tg, _, _ = gps
    cov_fn = jgp.make_cov_fn(jg)
    qp, qd, qu = _queries(4, 3, 2)
    # two value rows well apart from each other and outside the mesh: a
    # well-conditioned solve
    cp, cd, cu = _queries(4, 2, 3)
    cp[:, 0] = cp[:, 0] * 0.2 + [1.2, 0.0, 0.0]
    cp[:, 1] = cp[:, 1] * 0.2 + [0.0, -1.2, 0.0]
    cd[:] = 0
    vals = np.random.default_rng(4).normal(size=(4, 2)).astype(np.float32)

    def cov_of(m, s):
        return m, s @ s.T
    jm, jC = jax.vmap(lambda *a: cov_of(*jgp.conditional_mvn(
        jg, cov_fn, *a)[:2]))(qp, qd, qu, cp, cd, cu, vals)
    tm, troot, _ = tgp.conditional_mvn(
        tg, *_t(qp, qd.astype(np.int64), qu, cp, cd.astype(np.int64), cu,
                vals))
    np.testing.assert_allclose(tm.numpy(), jm, rtol=0.0, atol=1e-3)
    np.testing.assert_allclose((troot @ troot.transpose(1, 2)).numpy(), jC,
                               rtol=0.0, atol=1e-3)
    jm, jC = jax.vmap(lambda *a: cov_of(*jgp.prior_mvn(jg, cov_fn, *a)[:2]))(
        qp, qd, qu)
    tm, troot, _ = tgp.prior_mvn(tg, *_t(qp, qd.astype(np.int64), qu))
    np.testing.assert_allclose(tm.numpy(), jm, rtol=0.0, atol=1e-3)
    np.testing.assert_allclose((troot @ troot.transpose(1, 2)).numpy(), jC,
                               rtol=0.0, atol=1e-3)


@pytest.mark.parametrize("conditioned", [False, True])
def test_gp_cdf_matches_jax(gps, conditioned):
    jg, tg, _, _ = gps
    if not conditioned:
        jg = dataclasses.replace(jg, global_cond=None)
        tg = dataclasses.replace(tg, global_cond=None)
    p = np.random.default_rng(5).uniform(-1, 1, (32, 3)).astype(np.float32)
    want = jax.vmap(lambda q: jgp.gp_cdf(jg, jgp.make_cov_fn(jg), q))(p)
    got = tgp.gp_cdf(tg, torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=0.0,
                               atol=1e-3 if conditioned else 1e-5)


def test_constrained_sampler_matches_jax():
    r = np.random.default_rng(6)
    R, n = 64, 8
    mean = r.normal(scale=0.5, size=(R, n)).astype(np.float32) - 0.3
    a = r.normal(size=(R, n, n)).astype(np.float32) * 0.3
    root = (a @ a.transpose(0, 2, 1) / n).astype(np.float32)
    key = r.integers(0, 2 ** 32, R, dtype=np.uint32)
    cmask = np.arange(n) == 0
    jv, jok = jax.vmap(lambda m, s, k: jgp.sample_mvn_constrained(
        m, s, k, jnp.uint32(11), 0.0, jnp.float32(3e38),
        jnp.asarray(cmask)))(mean, root, key)
    tv, tok = tgp.sample_mvn_constrained(
        *_t(mean, root), torch.from_numpy(key.astype(np.int64)), 11, 0.0,
        3e38, torch.from_numpy(cmask))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-6)
    assert 0 < tok.numpy().mean() < 1  # both outcomes occur
    assert (tv.numpy()[tok.numpy(), 0] >= 0).all()


def test_the_scene_load_solve_reproduces_the_observations():
    """The port's own GlobalCond (float64 solve) on a 24-vertex mesh."""
    pos, nrm = _mesh()
    from tungsten_tpu_torch.ops import sparse_conv as tsc
    from tungsten_tpu_torch.ops.covariance import SquaredExponentialCov
    from tungsten_tpu_torch.ops.means import HomogeneousMean
    cov = SquaredExponentialCov(sigma=torch.tensor(1.0), l=torch.tensor(0.5),
                                aniso=torch.ones(3))
    g0 = tsc.GP(mean=HomogeneousMean(offset=torch.tensor(0.5)), cov=cov)
    g = dataclasses.replace(g0, global_cond=tgp.build_global_cond(
        g0, *_t(pos, nrm)))
    p, n = _t(pos[None, :8], nrm[None, :8])
    m, K, _ = tgp.mean_cov_gc(g, p, torch.zeros(8, dtype=torch.int64), n)
    np.testing.assert_allclose(m.numpy(), 0.0, atol=2e-2)
    assert float(K[0].diagonal().max()) < 5e-2
    m1, _, _ = tgp.mean_cov_gc(g, p, torch.ones(8, dtype=torch.int64), n)
    np.testing.assert_allclose(m1.numpy(), 1.0, atol=5e-2)
    q = torch.from_numpy(pos[None, :1] * 1.02)
    z = torch.zeros(1, dtype=torch.int64)
    _, Kc, _ = tgp.mean_cov_gc(g, q, z, torch.zeros_like(q))
    _, Kf, _ = tgp.mean_cov_gc(g0, q, z, torch.zeros_like(q))
    assert float(Kc[0, 0, 0]) < 0.3 * float(Kf[0, 0, 0])


@pytest.fixture(scope="module")
def variant_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("fs_variants")
    out = {}
    for name, (_, doc, _) in variant_docs(str(d)).items():
        if name in VARIANTS:
            out[name] = str(d / f"{name}.json")
            with open(out[name], "w") as fh:
                json.dump(doc, fh)
    return out


def _rays(R, seed):
    r = np.random.default_rng(seed)
    origin = np.array([0.0, 0.9, 2.0], np.float32)
    tgt = np.stack([r.uniform(-0.6, 0.6, R), 0.9 + r.uniform(-0.45, 0.45, R),
                    np.zeros(R)], -1)
    rd = (tgt - origin) / np.linalg.norm(tgt - origin, axis=-1,
                                         keepdims=True)
    pss = np.stack([np.arange(R), np.arange(R) % 5, np.full(R, seed),
                    np.ones(R)], -1).astype(np.uint32)
    return (np.tile(origin, (R, 1)), rd.astype(np.float32),
            np.full(R, 1.2, np.float32), np.full(R, 3.2, np.float32), pss,
            r.uniform(size=R).astype(np.float32))


def _jax_walk(jscene, rays):
    """Two segments of JAX's sample_distance (the second from the first's
    end, 1e-3 on), with the state carried."""
    ro, rd, near, far, pss, uj = rays
    R = ro.shape[0]
    med = jscene.media[0]

    @jax.jit
    def run(ro, near, st, pss):
        return jmd.sample_distance(med, jscene.scene_seed, ro, rd, near, far,
                                   st, pss, uj, jnp.ones(R, bool))

    st = jmd.MediumState.make(R)
    out = []
    for seg in range(2):
        res, st = jax.device_get(run(ro, near, st, pss))
        out.append((~np.asarray(res["exited"]), np.asarray(res["t"]),
                    np.asarray(res["aniso"]), np.asarray(st.fs_n),
                    np.asarray(st.fs_vals)))
        ro = (ro + (np.asarray(res["t"])[:, None] + 1e-3) * rd).astype(
            np.float32)
        near = np.zeros(R, np.float32)
        pss = pss.copy()
        pss[:, 3] += 1
    return out


def _port_walk(tscene, rays):
    ro, rd, near, far, pss, uj = (torch.from_numpy(np.asarray(x))
                                  for x in rays)
    pss = pss.to(torch.int64)
    R = ro.shape[0]
    med = tscene.media[0]
    st = tmd.MediumState.make(R, "cpu")
    out = []
    for seg in range(2):
        res, st = tmd.sample_distance(med, tscene.scene_seed, ro, rd, near,
                                      far, st, pss, uj,
                                      torch.ones(R, dtype=torch.bool))
        out.append(((~res["exited"]).numpy(), res["t"].numpy(),
                    res["aniso"].numpy(), st.fs_n.numpy(),
                    st.fs_vals.numpy()))
        ro = ro + (res["t"][:, None] + 1e-3) * rd
        near = torch.zeros(R)
        pss = pss.clone()
        pss[:, 3] += 1
    return out


@pytest.mark.parametrize("name", VARIANTS)
def test_sample_distance_matches_jax_over_two_segments(variant_paths, name):
    jscene, _ = jload_scene(variant_paths[name])
    tscene = convert.scene_from_numpy(convert.flatten(jscene), device="cpu")
    rays = _rays(48, 7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgp, "_sqrt_psd", sym_root)
        j = _jax_walk(jscene, rays)
    p = _port_walk(tscene, rays)
    sigma = float(jscene.media[0].gp.cov.sigma)
    mesh = name == "fs-conditioned"
    hits = 0
    for (jh, jt, ja, jn, jv), (ph, pt, pa, pn, pv) in zip(j, p):
        assert (jh == ph).mean() >= 0.95
        both = jh & ph
        hits += both.sum()
        dt = np.abs(jt[both] - pt[both])
        assert (dt <= 2e-3).mean() >= 0.95 and dt.max(initial=0.0) <= 1e-2
        na = ja / np.linalg.norm(ja, axis=-1, keepdims=True)
        nb = pa / np.linalg.norm(pa, axis=-1, keepdims=True)
        dots = (na * nb).sum(-1)[both]
        if mesh:
            # the along-ray component is pinned to the crossing's slope
            ga, gb = ((g * rays[1]).sum(-1)[both] for g in (ja, pa))
            assert (np.abs(ga - gb) <= 1e-2 * (1 + np.abs(ga))).mean() \
                >= 0.95
        else:
            assert dots.min(initial=1.0) >= 0.99
        same = jn == pn
        assert same.mean() >= 0.95
        k = np.arange(jv.shape[1])[None] < jn[:, None]
        assert np.abs(jv - pv)[same[:, None] & k].max(initial=0.0) <= \
            (0.25 if mesh else VALUE_RTOL) * sigma
    assert hits >= 10
    if name in ("fs-global", "fs-conditioned"):
        assert p[1][3].max() >= 2  # the ring holds rows of both segments
    else:
        assert (p[1][3] == 0).all()


def test_skip_space_advances_near(variant_paths):
    """The skip moves each segment's start past the probes where the GP is
    surely positive, and never past far."""
    scene = scene_from_dict(json.load(open(variant_paths["fs-skip"])),
                            device="cpu")[0]
    med = scene.media[0]
    ro, rd, near, far, _, _ = (torch.from_numpy(np.asarray(x))
                               for x in _rays(16, 3))
    out = tfs.skip_space_advance(med.gp, med.skip_space, med.step_size, ro,
                                 rd, near, far)
    assert (out >= near).all() and (out <= far).all()
    assert float((out - near).max()) > 0.05
    p = ro + out[:, None] * rd
    assert (tgp.gp_cdf(med.gp, p - 0.01 * rd) < med.skip_space).all()


def _ring_walk(ring_k):
    """tests/test_global_cond.py's walk: 8 rays through four segments of a
    Global-context function-space medium with FS_RING = ring_k."""
    from tungsten_tpu_torch.ops import sparse_conv as tsc
    from tungsten_tpu_torch.ops.covariance import SquaredExponentialCov
    from tungsten_tpu_torch.ops.means import SphericalMean
    old = tmd.FS_RING
    tmd.FS_RING = ring_k
    try:
        gp = tsc.GP(mean=SphericalMean(center=torch.zeros(3),
                                       radius=torch.tensor(0.45)),
                    cov=SquaredExponentialCov(sigma=torch.tensor(0.08),
                                              l=torch.tensor(0.15),
                                              aniso=torch.ones(3)))
        med = tmd.Medium(
            sigma_a=torch.zeros(3), sigma_s=torch.ones(3),
            density=torch.tensor(1.0), step_size=torch.tensor(0.02),
            cfg=tsc.SparseConvConfig.create(0, 3.0, "cpu",
                                            ctxt=tsc.CTXT_GLOBAL),
            gp=gp, bounds=None, phase_bsdf=0,
            kind=tmd.GPIS_FUNCTION_SPACE)
        R = 8
        ths = torch.linspace(-0.05, 0.05, R)
        rd = torch.stack([torch.sin(ths), torch.zeros(R), -torch.cos(ths)],
                         -1)
        rd = rd / rd.norm(dim=-1, keepdim=True)
        ro = torch.tensor([[0.0, 0.1, 3.0]]).repeat(R, 1)
        state = tmd.MediumState.make(R, "cpu")
        pss = torch.stack([torch.arange(R)] + [torch.zeros(R, dtype=torch.int64)]
                          * 3, -1)
        ts = []
        for _ in range(4):
            res, state = tmd.sample_distance(
                med, 11, ro, rd, torch.zeros(R), torch.full((R,), 4.0),
                state, pss, torch.full((R,), 0.5),
                torch.ones(R, dtype=torch.bool))
            ts.append(res["t"].numpy())
            ro = ro + (res["t"][:, None] + 1e-3) * rd
        return np.stack(ts)
    finally:
        tmd.FS_RING = old


def test_ring_size_converged():
    """FS_RING and twice it agree on the walk's distances; a ring of 4
    changes them.  The rays start 3 units out, so that the first segment
    takes 4 chunks of 0.64 and its crossing chunk conditions on more
    rows than a ring of 4 keeps.  With the symmetric root the change is
    small, ~1e-4 (the evicted rows are over 0.64 back, past the
    covariance's reach of l = 0.15): held above 1e-6."""
    t_small, t_ref, t_big = (_ring_walk(k) for k in (4, tmd.FS_RING,
                                                       2 * tmd.FS_RING))
    assert np.median(np.abs(t_ref - t_big)) < 0.05
    assert np.abs(t_small - t_ref).max() > 1e-6


@pytest.mark.parametrize("name", VARIANTS)
def test_the_gradient_is_refused_by_name(variant_paths, name):
    scene = scene_from_dict(json.load(open(variant_paths[name])),
                            device="cpu")[0]
    with pytest.raises(NotImplementedError, match="function-space|mesh "
                       "conditioning"):
        entry.fwd_bwd(scene, 0)


def test_csg_under_global_fails_in_jax_and_is_refused_by_name():
    """The JAX package raises on a CSG union under the Global context
    (tungsten_tpu/models/media.py's function-space driver); the port's
    parser refuses it by name (ROADMAP queue 3)."""
    from tungsten_tpu.scene.parse import scene_from_dict as jscene_from_dict
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "gpis-csg.json")
    with open(path) as fh:
        doc = json.load(fh)
    doc["media"][0]["correlation_context"] = "global"
    jscene, _ = jscene_from_dict(doc)
    R = 4
    with pytest.raises(ValueError, match="Global"):
        jmd.sample_distance(
            jscene.media[0], jscene.scene_seed, jnp.zeros((R, 3)),
            jnp.tile(jnp.asarray([0.0, 0.0, -1.0]), (R, 1)), jnp.zeros(R),
            jnp.ones(R), jmd.MediumState.make(R),
            jnp.zeros((R, 4), jnp.uint32), jnp.full(R, 0.5),
            jnp.ones(R, bool))
    with pytest.raises(NotImplementedError, match="JAX package cannot"):
        scene_from_dict(doc, device="cpu")
