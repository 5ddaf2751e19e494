"""Triangle mesh loading: Tungsten WO3 binary and a minimal OBJ reader
(a numpy-only copy of tungsten_tpu/io/meshio.py: the same reads, the same
bytes written).

Format parity (data only) with the reference loader
(src/core/io/MeshIO.cpp:12-46): WO3 is
  u64 numVerts, numVerts x Vertex{pos 3f, normal 3f, uv 2f, color 3f},
  u64 numTris,  numTris  x TriangleI{v0,v1,v2 u32, material i32}
(Vertex layout: src/core/primitives/Vertex.hpp:10-15;
 TriangleI: src/core/primitives/Triangle.hpp:14-21).
"""
from __future__ import annotations

import os

import numpy as np

_VERT_F = 11  # pos3 + normal3 + uv2 + color3


def load_wo3(path: str):
    """Returns dict(pos[N,3], normal[N,3], uv[N,2], color[N,3], tris[T,3])."""
    with open(path, "rb") as f:
        raw = f.read()
    off = 0
    nv = int(np.frombuffer(raw, np.uint64, 1, off)[0]); off += 8
    verts = np.frombuffer(raw, np.float32, nv * _VERT_F, off).reshape(
        nv, _VERT_F)
    off += nv * _VERT_F * 4
    nt = int(np.frombuffer(raw, np.uint64, 1, off)[0]); off += 8
    tris = np.frombuffer(raw, np.uint32, nt * 4, off).reshape(nt, 4)
    return dict(pos=verts[:, 0:3].astype(np.float32),
                normal=verts[:, 3:6].astype(np.float32),
                uv=verts[:, 6:8].astype(np.float32),
                color=verts[:, 8:11].astype(np.float32),
                tris=tris[:, :3].astype(np.int32))


def save_wo3(path: str, pos, tris, normal=None, uv=None, color=None):
    pos = np.asarray(pos, np.float32)
    nv = pos.shape[0]
    verts = np.zeros((nv, _VERT_F), np.float32)
    verts[:, 0:3] = pos
    if normal is not None:
        verts[:, 3:6] = normal
    if uv is not None:
        verts[:, 6:8] = uv
    if color is not None:
        verts[:, 8:11] = color
    tris4 = np.full((len(tris), 4), 0, np.uint32)
    tris4[:, :3] = np.asarray(tris, np.uint32)
    tris4[:, 3] = np.uint32(0xFFFFFFFF)  # material -1
    with open(path, "wb") as f:
        f.write(np.uint64(nv).tobytes())
        f.write(verts.tobytes())
        f.write(np.uint64(len(tris)).tobytes())
        f.write(tris4.tobytes())


def load_obj(path: str):
    """Minimal OBJ: v/vt/vn + f (triangulates fans).  Per-corner attributes
    are deduplicated into unified vertices like the reference ObjLoader."""
    vs, vts, vns = [], [], []
    corner_map = {}
    out_pos, out_uv, out_nrm = [], [], []
    tris = []

    def corner(tok):
        if tok in corner_map:
            return corner_map[tok]
        parts = (tok.split("/") + ["", ""])[:3]
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(vs) + vi
        ti = int(parts[1]) - 1 if parts[1] else -1
        ni = int(parts[2]) - 1 if parts[2] else -1
        out_pos.append(vs[vi])
        out_uv.append(vts[ti] if ti >= 0 else (0.0, 0.0))
        out_nrm.append(vns[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        idx = len(out_pos) - 1
        corner_map[tok] = idx
        return idx

    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "vt":
                vts.append(tuple(float(x) for x in t[1:3]))
            elif t[0] == "vn":
                vns.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "f":
                ids = [corner(tok) for tok in t[1:]]
                for k in range(1, len(ids) - 1):
                    tris.append((ids[0], ids[k], ids[k + 1]))

    pos = np.asarray(out_pos, np.float32).reshape(-1, 3)
    uv = np.asarray(out_uv, np.float32).reshape(-1, 2)
    nrm = np.asarray(out_nrm, np.float32).reshape(-1, 3)
    tris = np.asarray(tris, np.int32).reshape(-1, 3)
    if not np.any(np.linalg.norm(nrm, axis=-1) > 0):
        nrm = smooth_normals(pos, tris)
    return dict(pos=pos, normal=nrm, uv=uv,
                color=np.zeros_like(pos), tris=tris)


def smooth_normals(pos, tris):
    """Area-weighted vertex normals (TriangleMesh::calcSmoothVertexNormals)."""
    n = np.zeros_like(pos)
    p0, p1, p2 = pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    for k in range(3):
        np.add.at(n, tris[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def load_mesh(path: str):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wo3":
        return load_wo3(path)
    if ext == ".obj":
        return load_obj(path)
    raise ValueError(f"unsupported mesh format: {path}")


# -- procedural meshes (TriangleMesh::makeSphere/makeCube analogs) ----------

def make_sphere(radius=1.0, subdiv=16):
    us = np.linspace(0, 2 * np.pi, 2 * subdiv + 1)
    vsub = np.linspace(0, np.pi, subdiv + 1)
    uu, vv = np.meshgrid(us, vsub)
    pos = np.stack([np.cos(uu) * np.sin(vv), np.cos(vv),
                    np.sin(uu) * np.sin(vv)], -1).reshape(-1, 3) * radius
    W = 2 * subdiv + 1
    tris = []
    for i in range(subdiv):
        for j in range(2 * subdiv):
            a, b = i * W + j, i * W + j + 1
            c, d = (i + 1) * W + j, (i + 1) * W + j + 1
            tris += [(a, b, c), (b, d, c)]
    tris = np.asarray(tris, np.int32)
    nrm = (pos / max(radius, 1e-20)).astype(np.float32)
    return dict(pos=pos.astype(np.float32), normal=nrm,
                uv=np.zeros((len(pos), 2), np.float32),
                color=np.zeros_like(pos, dtype=np.float32), tris=tris)
