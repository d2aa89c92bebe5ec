"""Parity of the PyTorch port's math leaves, TimeNet, model store and
weight conversion with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance 1e-5: both sides run the same float32 formulas; only the
library routines (sin/cos/exp/matmul sums) round differently.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.models import gaussians as JG
from dimo_tpu.models import timenet as jtn
from dimo_tpu.ops import posenc as jpe
from dimo_tpu.ops import quat as jq
from dimo_tpu.ops import sh as jsh
from dimo_tpu.utils import cameras as jcam
from dimo_tpu.utils import general as jgen

from dimo_tpu_torch.io.convert import params_from_numpy, timenet_from_numpy
from dimo_tpu_torch.models import gaussians as TG
from dimo_tpu_torch.models import timenet as ttn
from dimo_tpu_torch.ops import posenc as tpe
from dimo_tpu_torch.ops import quat as tq
from dimo_tpu_torch.ops import sh as tsh
from dimo_tpu_torch.utils import cameras as tcam
from dimo_tpu_torch.utils import general as tgen
from torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(t_out, j_out, tol=TOL):
    np.testing.assert_allclose(t_out.detach().cpu().numpy(), np.asarray(j_out),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("fn", ["normalize", "to_matrix", "rotate", "multiply"])
def test_quat_matches_jax(fn):
    rng = np.random.RandomState(0)
    q1 = rng.randn(64, 4).astype(np.float32)
    q2 = rng.randn(64, 4).astype(np.float32)
    v = rng.randn(64, 3).astype(np.float32)
    args = {"normalize": (q1,), "to_matrix": (q1,), "rotate": (q1, v),
            "multiply": (q1, q2)}[fn]
    _close(getattr(tq, fn)(*map(_t, args)),
           getattr(jq, fn)(*map(jnp.asarray, args)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.RandomState(deg)
    sh = rng.randn(50, 3, 25).astype(np.float32)
    d = rng.randn(50, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(tsh.eval_sh(deg, _t(sh), _t(d)),
           jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))


@pytest.mark.parametrize("freqs,dims,incl", [(10, 3, False), (6, 1, False),
                                             (4, 2, True)])
def test_posenc_matches_jax(freqs, dims, incl):
    x = np.random.RandomState(1).uniform(-1, 1, (40, dims)).astype(np.float32)
    assert tpe.posenc_dim(freqs, dims, incl) == jpe.posenc_dim(freqs, dims, incl)
    _close(tpe.posenc(_t(x), freqs, incl), jpe.posenc(jnp.asarray(x), freqs, incl))


def test_inverse_sigmoid_and_sh_dc_match_jax():
    x = np.random.RandomState(2).uniform(0.01, 0.99, (100,)).astype(np.float32)
    _close(tgen.inverse_sigmoid(_t(x)), jgen.inverse_sigmoid(jnp.asarray(x)))
    _close(tsh.rgb_to_sh(_t(x)), jsh.rgb_to_sh(jnp.asarray(x)))
    _close(tsh.sh_to_rgb(_t(x)), jsh.sh_to_rgb(jnp.asarray(x)))


def test_cameras_are_the_reference_cameras():
    c2w = jcam.orbit_camera(20, 40, 2.5)
    np.testing.assert_array_equal(tcam.orbit_camera(20, 40, 2.5), c2w)
    a = jcam.Camera.from_c2w(c2w, 0.7, 0.6)
    b = tcam.Camera.from_c2w(c2w, 0.7, 0.6)
    for f in jcam.Camera._fields:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    np.testing.assert_array_equal(tcam.projection_matrix(0.01, 100, 0.7, 0.6),
                                  jcam.projection_matrix(0.01, 100, 0.7, 0.6))


def _timenet_leaves(latent_dim, seed):
    """JAX TimeNet leaves as numpy, with random (non-zero) head weights so
    both heads carry signal."""
    import jax
    leaves = {k: np.asarray(v) for k, v in
              jtn.init_timenet(jax.random.PRNGKey(seed), latent_dim).items()}
    rng = np.random.RandomState(seed)
    for k in ("pts_1_w", "rot_1_w"):
        leaves[k] = (rng.randn(*leaves[k].shape) * 0.05).astype(np.float32)
    leaves["pts_1_b"] = (rng.randn(3) * 0.01).astype(np.float32)
    return leaves


@pytest.mark.parametrize("latent_dim", [8, 32])
def test_timenet_matches_jax(latent_dim):
    leaves = _timenet_leaves(latent_dim, 3)
    net = timenet_from_numpy(leaves, device="cpu")
    rng = np.random.RandomState(4)
    pts = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    lat = rng.randn(latent_dim).astype(np.float32)
    dx_t, dq_t = net(_t(pts), 0.35, _t(lat))
    dx_j, dq_j = jtn.apply_timenet({k: jnp.asarray(v) for k, v in leaves.items()},
                                   jnp.asarray(pts), 0.35, jnp.asarray(lat))
    _close(dx_t, dx_j)
    _close(dq_t, dq_j)


def test_timenet_init_shapes_and_heads():
    net = ttn.TimeNet(8, generator=torch.Generator().manual_seed(0))
    leaves = jtn.init_timenet(__import__("jax").random.PRNGKey(0), 8)
    assert net.trunk[0].weight.shape == leaves["trunk_0_w"].shape[::-1]
    assert net.trunk[5].weight.shape == leaves["trunk_5_w"].shape[::-1]
    d_xyz, d_rot = net(torch.zeros(5, 3), 0.0, torch.zeros(8))
    assert torch.all(d_xyz == 0)
    assert torch.all(d_rot == torch.tensor([1.0, 0.0, 0.0, 0.0]))
    bound = 1.0 / np.sqrt(net.trunk[0].weight.shape[1])
    assert float(net.trunk[0].bias.detach().abs().max()) <= bound


def jax_to_numpy(params, aux) -> dict:
    """Flatten a dimo_tpu (GaussianParams, GaussianAux) to numpy leaves."""
    d = {f: np.asarray(getattr(params, f))
         for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                   "opacity", "c_xyz", "c_radius", "r")}
    d["latent"] = {k: np.asarray(v) for k, v in params.latent.items()}
    d["timenet"] = {k: np.asarray(v) for k, v in params.timenet.items()}
    for f in ("active", "c_active", "max_radii2d", "xyz_grad_accum", "denom"):
        d[f] = np.asarray(getattr(aux, f))
    return d


@pytest.mark.parametrize("vae", [False, True])
def test_params_from_numpy_and_activations_match_jax(vae):
    cfg_j = JG.ModelConfig(sh_degree=1, latent_dim=8, num_latents=3, vae=vae,
                           capacity=64, cpt_capacity=16)
    jp, ja = JG.init_model(cfg_j, seed=5, num_pts=40, num_cpts=12)
    tp, ta = params_from_numpy(jax_to_numpy(jp, ja), device="cpu")
    for stage in ("s1", "s2"):
        _close(TG.get_scaling(tp, stage), JG.get_scaling(jp, stage))
        _close(TG.get_c_radius(tp, stage), JG.get_c_radius(jp, stage))
    _close(TG.get_opacity(tp), JG.get_opacity(jp))
    _close(TG.get_features(tp), JG.get_features(jp))
    _close(TG.sample_latent(tp, 2), JG.sample_latent(jp, 2))
    assert torch.equal(ta.active, _t(np.asarray(ja.active)))
    assert torch.equal(ta.c_active, _t(np.asarray(ja.c_active)))
    if vae:
        z = TG.sample_latent(tp, 1, torch.Generator().manual_seed(0))
        assert z.shape == (8,) and not torch.equal(z, TG.sample_latent(tp, 1))


def test_init_model_matches_reference_points():
    cfg_t = TG.ModelConfig(latent_dim=8, num_latents=2, capacity=64,
                           cpt_capacity=16)
    cfg_j = JG.ModelConfig(latent_dim=8, num_latents=2, capacity=64,
                           cpt_capacity=16)
    tp, ta = TG.init_model(cfg_t, seed=7, num_pts=40, num_cpts=12, device="cpu")
    jp, ja = JG.init_model(cfg_j, seed=7, num_pts=40, num_cpts=12)
    # the numpy-drawn leaves agree; latents/TimeNet come from torch RNGs
    for f in ("xyz", "features_dc", "rotation", "opacity", "c_xyz"):
        _close(getattr(tp, f), getattr(jp, f))
    _close(tp.scaling, jp.scaling, 1e-4)
    _close(tp.c_radius, jp.c_radius, 1e-4)
    assert torch.equal(ta.active, _t(np.asarray(ja.active)))
    assert tp.latent["codes"].shape == (2, 8)


def test_cuda_device_without_card_raises(monkeypatch):
    from dimo_tpu_torch.scenes import flagship_scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship_scene(64, 8, 8, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG._blank(TG.ModelConfig(capacity=8, cpt_capacity=8))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _port_files():
    files = [os.path.join(REPO, f) for f in
             ("chip_smoke.py", "bench_torch.py", "bench_train_torch.py",
              "main_train_dimo_torch.py", "main_test_dimo_torch.py",
              "eval_quality_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dimo_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_dimo_tpu():
    files = _port_files()
    assert len(files) > 20
    # the scan reaches every module of the port, the newest included
    rel = {os.path.relpath(f, os.path.join(REPO, "dimo_tpu_torch"))
           for f in files}
    for name in ("train/loop.py", "train/step.py", "io/checkpoint.py",
                 "io/config.py", "io/ply.py", "io/synthetic.py", "presets.py",
                 "ops/rasterizer/windowdma.py", "ops/rasterizer/oracle.py",
                 "ops/neighbors.py", "models/gaussians.py",
                 "models/lpips.py", "utils/diagnostics.py", "cli.py",
                 "viz.py", "test_modes.py", "io/dataset.py", "io/colmap.py",
                 "models/text.py", "io/native.py", "parallel/mesh.py",
                 "parallel/check.py", "eval_quality.py"):
        assert name.replace("/", os.sep) in rel, name
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "dimo_tpu"), (path, mod)


def test_port_needs_no_optional_package_at_import():
    """PyYAML, OpenCV, tensorboardX, imageio, matplotlib, PIL and
    transformers may be missing on the machine with the card: no module of
    the port (nor `chip_smoke.py` or the CLIs) imports them at module
    level, so importing the trainer or the test modes never needs them."""
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in tree.body:
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for mod in mods:
                assert mod.split(".")[0] not in (
                    "yaml", "cv2", "tensorboardX", "triton", "imageio",
                    "matplotlib", "PIL", "transformers"), (path, mod)


def test_config_and_preset_are_the_reference_ones(tmp_path):
    """The port's copies of `io/config.py` and `presets.py`: the same keys
    and values, attribute access, dotlist overrides with YAML typing."""
    from dimo_tpu.io import config as jcfg
    from dimo_tpu.presets import tiny_synthetic_opt as j_tiny
    from dimo_tpu_torch.io import config as tcfg
    from dimo_tpu_torch.presets import tiny_synthetic_opt as t_tiny
    j, t = j_tiny(num_cpts=7), t_tiny(num_cpts=7)
    paths = ("save_path", "video_save_dir")       # under the temp directory
    assert {k: v for k, v in t.items() if k not in paths} == \
        {k: v for k, v in j.items() if k not in paths}
    assert t.num_cpts == 7 and t.get("missing", 3) == 3
    with pytest.raises(AttributeError):
        t.missing
    yaml_path = os.path.join(REPO, "configs", "train_config.yaml")
    dots = ["batch_size=2", "nested.key=[1, 2]", "--save_path=out", "flag="]
    a, b = tcfg.load_config(yaml_path, dots), jcfg.load_config(yaml_path, dots)
    assert dict(a) == dict(b) and a.nested.key == [1, 2] and a.flag is None
    tcfg.save_config(a, str(tmp_path / "c.yaml"))
    assert dict(tcfg.load_yaml(str(tmp_path / "c.yaml"))) == dict(a)
    with pytest.raises(ValueError, match="key=value"):
        tcfg.apply_dotlist(a, ["oops"])
