"""Self-contained binary PLY codec for 3DGS point clouds.

Copy of `dimo_tpu/io/ply.py`'s numpy path (the port keeps its own copy and
imports nothing of the JAX package; the JAX package's optional native
codec is not carried over). The on-disk formats are the reference's, so
checkpoints interchange with `dimo_tpu` and standard 3DGS viewers:

  * gaussian cloud: x y z nx ny nz f_dc_* f_rest_* opacity scale_* rot_*
  * control-point cloud: c_x c_y c_z c_radius

No plyfile dependency — numpy structured arrays + a minimal header parser
(binary_little_endian 1.0, float32 properties; ascii also readable).
"""
from __future__ import annotations

import os

import numpy as np


def _write_ply(path: str, names: list[str], columns: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = columns.shape[0]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]
    dtype = np.dtype([(name, "<f4") for name in names])
    rec = np.zeros(n, dtype=dtype)
    for i, name in enumerate(names):
        rec[name] = columns[:, i].astype(np.float32)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def _read_ply(path: str) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:end].decode("ascii").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = "binary_little_endian"
    count = 0
    props: list[tuple[str, str]] = []
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            count = int(parts[2])
        elif parts[0] == "property" and parts[1] != "list":
            props.append((parts[2], parts[1]))

    typemap = {"float": "<f4", "float32": "<f4", "double": "<f8",
               "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4"}
    dtype = np.dtype([(name, typemap[t]) for name, t in props])
    if fmt == "ascii":
        rows = np.loadtxt(body.decode("ascii").splitlines(), dtype=np.float64,
                          max_rows=count)
        rows = rows.reshape(count, len(props))
        return {name: rows[:, i].astype(np.float32)
                for i, (name, _) in enumerate(props)}
    rec = np.frombuffer(body, dtype=dtype, count=count)
    return {name: np.asarray(rec[name], dtype=np.float32) for name, _ in props}


def save_gaussians(path: str, xyz, features_dc, features_rest, opacity,
                   scaling, rotation) -> None:
    """Write the reference gaussian PLY. features_dc (N,1,3),
    features_rest (N,K-1,3); scaling/rotation stored raw (log/unnormalized)."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    normals = np.zeros_like(xyz)
    # reference layout: transpose(1,2).flatten -> channel-major per point
    f_dc = np.asarray(features_dc, np.float32).transpose(0, 2, 1).reshape(n, -1)
    f_rest = np.asarray(features_rest, np.float32).transpose(0, 2, 1).reshape(n, -1)
    opacity = np.asarray(opacity, np.float32).reshape(n, -1)
    scaling = np.asarray(scaling, np.float32).reshape(n, -1)
    rotation = np.asarray(rotation, np.float32).reshape(n, -1)

    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(f_dc.shape[1])]
    names += [f"f_rest_{i}" for i in range(f_rest.shape[1])]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(scaling.shape[1])]
    names += [f"rot_{i}" for i in range(rotation.shape[1])]
    cols = np.concatenate([xyz, normals, f_dc, f_rest, opacity, scaling,
                           rotation], axis=1)
    _write_ply(path, names, cols)


def load_gaussians(path: str, sh_degree: int) -> dict[str, np.ndarray]:
    """Read a reference-format gaussian PLY -> dict of numpy arrays with
    shapes matching GaussianParams fields."""
    d = _read_ply(path)
    n = d["x"].shape[0]
    xyz = np.stack([d["x"], d["y"], d["z"]], axis=1)
    opacity = d["opacity"][:, None]

    f_dc = np.stack([d["f_dc_0"], d["f_dc_1"], d["f_dc_2"]], axis=1)[:, None, :]
    k = (sh_degree + 1) ** 2
    n_rest = 3 * (k - 1)
    rest_names = sorted([nm for nm in d if nm.startswith("f_rest_")],
                        key=lambda s: int(s.split("_")[-1]))
    assert len(rest_names) == n_rest, (len(rest_names), n_rest)
    if n_rest:
        rest = np.stack([d[nm] for nm in rest_names], axis=1)  # (N, 3*(K-1))
        rest = rest.reshape(n, 3, k - 1).transpose(0, 2, 1)    # (N, K-1, 3)
    else:
        rest = np.zeros((n, 0, 3), np.float32)

    scale_names = sorted([nm for nm in d if nm.startswith("scale_")],
                         key=lambda s: int(s.split("_")[-1]))
    scaling = np.stack([d[nm] for nm in scale_names], axis=1)
    rot_names = sorted([nm for nm in d if nm.startswith("rot")],
                       key=lambda s: int(s.split("_")[-1]))
    rotation = np.stack([d[nm] for nm in rot_names], axis=1)
    return {"xyz": xyz, "features_dc": f_dc, "features_rest": rest,
            "opacity": opacity, "scaling": scaling, "rotation": rotation}


def save_control_points(path: str, c_xyz, c_radius) -> None:
    c_xyz = np.asarray(c_xyz, np.float32)
    c_radius = np.asarray(c_radius, np.float32).reshape(-1, 1)
    _write_ply(path, ["c_x", "c_y", "c_z", "c_radius"],
               np.concatenate([c_xyz, c_radius], axis=1))


def load_control_points(path: str) -> dict[str, np.ndarray]:
    d = _read_ply(path)
    return {"c_xyz": np.stack([d["c_x"], d["c_y"], d["c_z"]], axis=1),
            "c_radius": d["c_radius"][:, None]}
