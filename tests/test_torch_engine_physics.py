"""What an engine does with its physics outside the step (CPU): the t = 0
state is one node's equilibrium broadcast over the fluid slots, equal to
the equilibrium computed over the full (Q, T, n) shape and built in one
allocation of that shape; and the spans of the single, ensemble and
sharded engines name the collision, the fluid and tau they run."""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

from repro_torch import obs
from repro_torch.core import collision as col
from repro_torch.core.engine import LBMConfig, SparseTiledLBM, initial_feq
from repro_torch.core.lattice import get_lattice
from repro_torch.dist.lbm import ShardedLBM

PHYSICS = [("lbgk", "incompressible"), ("lbgk", "quasi_compressible"),
           ("lbmrt", "incompressible"), ("lbmrt", "quasi_compressible")]
FLUIDS = ["incompressible", "quasi_compressible"]


def _full_shape_feq(cfg, lat, solid, dtype):
    """The equilibrium computed at every slot of the (Q, T, n) shape."""
    rho = torch.full(solid.shape, cfg.rho0, dtype=dtype)
    u = torch.as_tensor(cfg.u0, dtype=dtype)[:, None, None]
    feq = col.equilibrium(rho, u.expand(3, *solid.shape), lat,
                          cfg.collision.fluid)
    return feq.masked_fill(solid[None], 0.0)


@pytest.mark.parametrize("fluid", FLUIDS)
@pytest.mark.parametrize("rho0,u0,ulps", [(1.0, (0.0, 0.0, 0.0), 0),
                                          (1.02, (0.02, -0.013, 0.0071), 1)],
                         ids=["configurations", "moving"])
def test_initial_feq_is_the_full_shape_equilibrium(fluid, rho0, u0, ulps):
    """Bit for bit at the configurations' (rho0, u0), within one ulp
    elsewhere; zero at solid slots; contiguous."""
    lat = get_lattice("D3Q19")
    gen = torch.Generator().manual_seed(3)
    solid = torch.rand((96, 64), generator=gen) < 0.3
    cfg = LBMConfig(collision=col.CollisionConfig(fluid=fluid), rho0=rho0,
                    u0=u0)
    got = initial_feq(cfg, lat, solid, torch.float64)
    want = _full_shape_feq(cfg, lat, solid, torch.float64)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.all(got[:, solid] == 0.0)
    ulp = torch.finfo(torch.float64).eps * want.abs()
    assert torch.all((got - want).abs() <= ulps * ulp)


class _Storages(TorchFunctionMode):
    """The bytes of every storage a torch function returns, each storage
    once (a function mode: a dispatch mode would import torch._dynamo)."""

    def __init__(self):
        super().__init__()
        self.nbytes = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                storage = t.untyped_storage()
                self.nbytes[storage.data_ptr()] = storage.nbytes()
        return out


@pytest.mark.parametrize("fluid", FLUIDS)
def test_initial_feq_allocates_its_shape_once(fluid):
    """The set-up holds no (Q, T, n) temporary beside the state it returns
    (the quasi-compressible fluid held four before, the incompressible
    three)."""
    lat = get_lattice("D3Q19")
    solid = torch.zeros((512, 64), dtype=torch.bool)
    cfg = LBMConfig(collision=col.CollisionConfig(fluid=fluid))
    size = lat.q * solid.numel() * 8
    with _Storages() as seen:
        initial_feq(cfg, lat, solid, torch.float64)
    assert [n for n in seen.nbytes.values() if n >= size // 4] == [size]


def _engine_spans(collision, fluid, tau, backend):
    """The spans of a periodic box's engine build, one run, and one step
    and one run of its ensemble."""
    physics = col.CollisionConfig(model=collision, fluid=fluid, tau=tau)
    cfg = LBMConfig(backend=backend, dtype="float64", periodic=(True,) * 3,
                    collision=physics)
    rec = obs.SpanRecorder()
    with obs.use(trace=rec):
        eng = SparseTiledLBM(np.ones((8, 8, 8), np.uint8), cfg, device="cpu")
        eng.run(2)
        ens = eng.ensemble(2)
        ens.step(1)
        ens.run(1)
    return rec


@pytest.mark.parametrize("backend", ["gather", "fused"])
@pytest.mark.parametrize("collision,fluid", PHYSICS)
def test_engine_and_ensemble_spans_name_the_physics(collision, fluid, backend):
    rec = _engine_spans(collision, fluid, 0.52, backend)
    physics = {"collision": collision, "fluid": fluid, "tau": 0.52}
    (setup,) = rec.find("lbm.setup")
    (run,) = rec.find("lbm.run")
    assert setup.attrs == {"backend": backend, "dtype": "float64", **physics}
    assert run.attrs == {"steps": 2, **physics}
    for name in ("lbm.ensemble.step", "lbm.ensemble.run"):
        (span,) = rec.find(name)
        assert span.attrs == {"batch": 2, "steps": 1, **physics}


@pytest.mark.parametrize("collision,fluid", PHYSICS[::3])
def test_sharded_run_span_names_the_physics(collision, fluid):
    physics = col.CollisionConfig(model=collision, fluid=fluid, tau=0.7)
    cfg = LBMConfig(backend="fused", dtype="float64", periodic=(True,) * 3,
                    collision=physics)
    rec = obs.SpanRecorder()
    with obs.use(trace=rec):
        ShardedLBM(np.ones((8, 8, 16), np.uint8), cfg, slabs=2,
                   devices="cpu").run(1)
    (run,) = rec.find("lbm.run")
    assert run.attrs == {"steps": 1, "sharded": True, "collision": collision,
                         "fluid": fluid, "tau": 0.7}

