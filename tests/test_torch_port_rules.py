"""Rules of the PyTorch port: it loads no JAX and nothing of the JAX
package, its entry points default to the card, and its kernel wrappers
never launch on CPU tensors."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import collision as C
from repro_torch.core.engine import LBMConfig, SparseTiledLBM
from repro_torch.core.lattice import d2q9
from repro_torch.data.geometry import random_spheres
from repro_torch.kernels import build
from repro_torch.kernels.collide import collide_tiles
from repro_torch.kernels.stream_collide import stream_collide_tiles

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import repro_torch.launch.lbm
import repro_torch.launch.sim_serve
import repro_torch.dist.lbm, repro_torch.launch.mesh
import repro_torch.sim, repro_torch.obs, repro_torch.checkpoint
import repro_torch.optim.adamw, repro_torch.train.step, repro_torch.data.tokens
import repro_torch.dist.compress, repro_torch.dist.ft, repro_torch.launch.train
import repro_torch.dist.sharding, repro_torch.dist.comm, repro_torch.dist.zero
import repro_torch.dist.tp, repro_torch.hw, repro_torch.core.overhead
import chip_smoke
import tools.k3_sass, tools.train_ranks, tools.serve_ranks
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
print("BAD", bad)
"""


def test_port_and_chip_smoke_load_no_jax_or_reference():
    """Every module of the port (the sharding rules, the comms, tensor
    parallelism and the ranked LM among them), chip_smoke.py,
    tools/k3_sass.py, tools/train_ranks.py and tools/serve_ranks.py (which
    run on the card's machine, where there is no JAX) import neither jax
    nor the reference package."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED ")[1].split()[0]) >= 25


def test_example_twins_import_only_the_port():
    """Each ``examples/torch`` twin imports the standard library, numpy,
    torch and ``repro_torch`` modules only (whose imports the test above
    holds free of jax and the reference); ``tests/test_torch_examples.py``
    runs each twin and checks the modules loaded at its end."""
    import ast

    allowed = {"argparse", "sys", "time", "numpy", "torch", "repro_torch"}
    twins = sorted((ROOT / "examples" / "torch").glob("*.py"))
    assert [p.name for p in twins] == ["quickstart.py", "serve_lm.py", "sparse_flow.py",
                                       "train_lm.py"]
    for path in twins:
        tree = ast.parse(path.read_text())
        roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)}
        assert roots <= allowed and "repro_torch" in roots, (path.name, roots)


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = random_spheres(box=8, porosity=0.6, diameter=4, seed=0)
    for backend in ("gather", "fused"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SparseTiledLBM(g, LBMConfig(backend=backend))
    eng = SparseTiledLBM(g, LBMConfig(backend="fused"), device="cpu")
    assert eng.f.device.type == "cpu"


def test_serving_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.core.dense import DenseLBM
    from repro_torch.sim import EngineRegistry, SimService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = random_spheres(box=8, porosity=0.6, diameter=4, seed=0)
    for build in (lambda: DenseLBM(g, LBMConfig()), EngineRegistry, SimService):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert SimService(device="cpu").registry.device.type == "cpu"


def test_lm_mesh_defaults_to_cuda(monkeypatch):
    from repro_torch.launch.mesh import make_lm_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_lm_mesh(1, 1)


def test_sharded_engine_defaults_to_cuda(monkeypatch):
    from repro_torch.dist.lbm import ShardedLBM
    from repro_torch.launch.mesh import make_host_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = random_spheres(box=8, porosity=0.6, diameter=4, seed=0)
    for backend in ("gather", "fused"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardedLBM(g, LBMConfig(backend=backend), slabs=2, devices=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh(2)
    eng = ShardedLBM(g, LBMConfig(backend="fused"), slabs=1, devices="cpu")
    assert eng.f[0].device.type == "cpu" and make_host_mesh(2, "cpu") == \
        [torch.device("cpu")] * 2


def test_sim_serve_launcher_fails_loudly_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.sim_serve",
                          "--cases", "duct", "--sessions", "1", "--steps", "2"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "MFLUPS" not in out.stdout


def test_wrappers_on_cpu_tensors_launch_nothing():
    g = random_spheres(box=8, porosity=0.6, diameter=4, seed=0)
    stream_collide_tiles.launches = collide_tiles.launches = 0
    for backend, kw in (("fused", {}), ("gather", {"use_kernel": True})):
        eng = SparseTiledLBM(g, LBMConfig(backend=backend, dtype="float64",
                                          periodic=(True,) * 3, **kw),
                             device="cpu")
        eng.run(2)
        assert np.isfinite(eng.total_mass())
    assert stream_collide_tiles.launches == 0
    assert collide_tiles.launches == 0


@pytest.mark.parametrize("kw,exc", [
    (dict(backend="fused", layout_scheme="paper"), ValueError),
    (dict(backend="fused", periodic=(True, False, False)), ValueError),
    (dict(split_stream=True, backend="fused"), ValueError),
    (dict(backend="dense"), ValueError),
])
def test_engine_keeps_reference_errors(kw, exc):
    g = np.ones((18, 16, 16), np.uint8)       # 18 % 4 != 0
    with pytest.raises(exc):
        SparseTiledLBM(g, LBMConfig(**kw), device="cpu")


def test_mrt_needs_d3q19():
    with pytest.raises(NotImplementedError, match="D3Q19"):
        C.collision_matrix_np(d2q9(), 0.7)


def test_kernel_libraries_are_keyed_on_their_sources():
    """Each csrc/*.cu has its own library path under build/repro_torch,
    named by a hash of the source, the headers and the flags."""
    paths = {name: build.library_path(name) for name in build.SOURCES}
    for name, p in paths.items():
        assert p.parent == ROOT / "build" / "repro_torch"
        assert p.name.startswith(f"lib{name}-") and p.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").exists()
    assert len(set(paths.values())) == len(paths)
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(build.SOURCES)
