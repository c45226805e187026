"""The expert-parallel MoE layer (``repro_torch/distributed/moe_ep.py``)
held against the reference's ``moe_forward_ep`` on the CPU.

The reference runs in one subprocess of eight fake XLA CPU devices
(``conftest.run_with_devices``), on meshes built over the first 4 or 8 of
them.  The port runs on as many spawned gloo ranks (a ``FileStore`` in the
test's directory): eight for the (data, model) meshes (2, 4) and (4, 2),
four for (1, 4).  Both take the same weights and inputs, made from a seed
with numpy: ``MoEConfig(num_experts=8, top_k=2, d_expert=16,
num_shared=1)``, D = 32.

Cases: capacity factor 8.0 (nothing drops) and 1.0 (drops bind); the
sliced shape (4, 8, 32), whose token count divides the model axis, and the
duplicate shape (4, 1, 32), whose does not on (2, 4) and (4, 2); training
on the three meshes and ``serving=True`` on (2, 4) and (4, 2); and serving
on (4, 2) at d_expert 6, which the data axis does not split: there the
reference's EP sums whole-width outputs over ``data`` (ROADMAP R10), and
the port is held to the reference's one-device layer.  Held: y
within 1e-5 max-abs of the reference; the three aux values within 1e-6,
``drop_fraction`` exactly equal at capacity factor 1.0; the gradients of
sum(y**2) for every leaf and for x within ``1e-4 * max|want| + 1e-6``.
Where nothing drops the gradients are the reference's one-device
``moe_forward`` gradients; where drops bind (EP drops differ from one
device's by design) they are ``jax.grad`` of the reference's EP on the
same mesh.  A port parameter's gradient is its rank's share: summed over
the mesh axes its block does not split, then gathered
(``moe_ep``'s docstring).
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from conftest import run_with_devices

SPAWN_TIMEOUT_S = 300
D, E, K, F = 32, 8, 2, 16
MESHES = {"2x4": (2, 4), "4x2": (4, 2), "1x4": (1, 4)}
SHAPES = {"sliced": (4, 8, D), "duplicate": (4, 1, D)}
FACTORS = (8.0, 1.0)
SERVING_MESHES = ("2x4", "4x2")
# (mesh, shape, capacity factor, serving, d_expert); the last case serves
# an FFN width that the data axis does not split (R10)
R10_F = 6
CASES = ([(mesh, shape, cf, False, F) for mesh in MESHES for shape in SHAPES
          for cf in FACTORS]
         + [(mesh, shape, cf, True, F) for mesh in SERVING_MESHES
            for shape in SHAPES for cf in FACTORS]
         + [("4x2", "sliced", 8.0, True, R10_F)])
LEAVES = ("router", "we_gate", "we_up", "we_down", "shared/w_gate",
          "shared/w_up", "shared/w_down")
AUX = ("load_balance_loss", "router_z_loss", "drop_fraction")


def case_key(mesh, shape, cf, serving, f=F):
    return (f"{mesh}/{shape}/{cf}/{'serving' if serving else 'train'}"
            + ("" if f == F else f"/f{f}"))


def wkey(name, f):
    """A weight's key in the inputs: its FFN width prefixed unless F."""
    return name if f == F or name in ("router",) or name.startswith("x/") \
        else f"f{f}/{name}"


def make_inputs(path):
    """Seeded weights (each ~ N(0, 1/fan_in)) and the two inputs.  The
    inputs share a direction ``u`` that experts 0 and 1 (one model shard)
    favour, so most tokens route there and capacity 1.0 binds."""
    rng = np.random.default_rng(0)

    def w(*shape):
        return rng.standard_normal(shape) / np.sqrt(shape[-2])

    u = rng.standard_normal(D)
    u /= np.linalg.norm(u)
    router = w(D, E)
    router[:, :2] += 2.0 * u[:, None]
    arrays = {"router": router}
    for f in (F, R10_F):
        arrays.update({wkey("we_gate", f): w(E, D, f),
                       wkey("we_up", f): w(E, D, f),
                       wkey("we_down", f): w(E, f, D),
                       wkey("shared/w_gate", f): w(D, f),
                       wkey("shared/w_up", f): w(D, f),
                       wkey("shared/w_down", f): w(f, D)})
    for name, shape in SHAPES.items():
        arrays[f"x/{name}"] = rng.standard_normal(shape) + 1.5 * u
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrays.items()})


REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models.config import MoEConfig
from repro.models.moe import moe_forward
from repro.distributed.moe_ep import moe_forward_ep
with np.load(INPUTS) as f:
    a = {k: f[k] for k in f.files}
def weights(ff):
    pre = "" if ff == 16 else f"f{ff}/"
    p = {k: jnp.asarray(a[pre + k]) for k in ("we_gate", "we_up",
                                               "we_down")}
    p["router"] = jnp.asarray(a["router"])
    p["shared"] = {n: jnp.asarray(a[pre + "shared/" + n])
                   for n in ("w_gate", "w_up", "w_down")}
    return p
def flat(g):
    p, x = g
    r = {k: np.asarray(p[k]) for k in ("router", "we_gate", "we_up",
                                        "we_down")}
    r.update({"shared/" + n: np.asarray(p["shared"][n])
              for n in ("w_gate", "w_up", "w_down")})
    r["x"] = np.asarray(x)
    return r
def with_loss(fn):
    def loss(p, xx):
        y, aux = fn(p, xx)
        return jnp.sum(y ** 2), (y, aux)
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
devs = np.array(jax.devices())
one_device = {}         # (shape, d_expert) -> the drop-free layer's results
out = {}
for mesh_name, shape_name, cf, serving, ff in CASES:
    key = f"{mesh_name}/{shape_name}/{cf}/{'serving' if serving else 'train'}"
    key += "" if ff == 16 else f"/f{ff}"
    shape = MESHES[mesh_name]
    mesh = Mesh(devs[:shape[0] * shape[1]].reshape(shape), ("data", "model"))
    moe = MoEConfig(num_experts=8, top_k=2, d_expert=ff, num_shared=1,
                    capacity_factor=cf)
    x = jnp.asarray(a["x/" + shape_name])
    params = weights(ff)
    ep = lambda p, xx: moe_forward_ep(p, xx, moe, mesh, serving=serving)
    with mesh:
        if cf == 8.0:
            y, aux = jax.jit(ep)(params, x)
            if (shape_name, ff) not in one_device:
                one_device[shape_name, ff] = with_loss(
                    lambda p, xx: moe_forward(p, xx, moe))(params, x)
            (_, (y1, aux1)), g = one_device[shape_name, ff]
            if ff != 16:
                # R10: the reference's EP output is kept apart; the
                # one-device layer is what the port is held to
                out[key + "/ep_y"] = np.asarray(y)
                y, aux = y1, aux1
        else:
            (_, (y, aux)), g = with_loss(ep)(params, x)
    out[key + "/y"] = np.asarray(y)
    for k, v in aux.items():
        out[key + "/aux/" + k] = np.asarray(v)
    for k, v in flat(g).items():
        out[key + "/grad/" + k] = v
np.savez(OUT, **out)
print("OK")
"""


def _rank_main(rank, world, store, inp, out_dir, meshes, cases):
    import torch.distributed as dist

    from repro_torch.distributed.collectives import all_reduce
    from repro_torch.distributed.moe_ep import moe_forward_ep, param_specs
    from repro_torch.distributed.sharding import (gather_leaf, shard_leaf,
                                                  spec_axes)
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.config import MoEConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        with np.load(inp) as f:
            full = {k: torch.from_numpy(f[k]) for k in f.files}
        out = {}
        for mesh_name in meshes:
            data, model = MESHES[mesh_name]
            mesh = make_mesh_for(world, model, device_type="cpu")
            names = mesh.mesh_dim_names
            for _, shape_name, cf, serving, f in [c for c in cases
                                                  if c[0] == mesh_name]:
                key = case_key(mesh_name, shape_name, cf, serving, f)
                moe = MoEConfig(num_experts=E, top_k=K, d_expert=f,
                                num_shared=1, capacity_factor=cf)
                specs = param_specs(moe, mesh, serving)
                x_spec = ("data" if data > 1 else None, None, None)
                blocks = {k: shard_leaf(full[wkey(k, f)], specs[k], mesh
                                        ).requires_grad_(True)
                          for k in LEAVES}
                x = shard_leaf(full["x/" + shape_name], x_spec, mesh
                               ).requires_grad_(True)
                y, aux = moe_forward_ep(blocks, x, moe, mesh,
                                        serving=serving)
                grads = torch.autograd.grad(torch.sum(y ** 2),
                                            [blocks[k] for k in LEAVES]
                                            + [x])
                out[key + "/y"] = gather_leaf(y.detach(), x_spec, mesh
                                              ).numpy()
                for k, v in aux.items():
                    out[key + "/aux/" + k] = v.detach().numpy()
                for k, g in zip(LEAVES, grads):
                    # a parameter's share, summed over the axes its block
                    # does not split
                    g = all_reduce(g.clone(), mesh,
                                   [a for a in names
                                    if a not in spec_axes(specs[k])])
                    out[key + "/grad/" + k] = gather_leaf(g, specs[k],
                                                          mesh).numpy()
                out[key + "/grad/x"] = gather_leaf(grads[-1], x_spec,
                                                   mesh).numpy()
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(world, meshes, tmp, inp, cases):
    out_dir = tmp / f"out{world}"
    out_dir.mkdir()
    ctx = mp.start_processes(
        _rank_main, args=(world, str(tmp / f"store{world}"), str(inp),
                          str(out_dir), meshes, cases),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    with np.load(out_dir / "rank0.npz") as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """-> (the reference's arrays, the port's), every case run once."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    inp = tmp / "inputs.npz"
    make_inputs(inp)
    ref_out = tmp / "reference.npz"
    run_with_devices(f"INPUTS, OUT = {str(inp)!r}, {str(ref_out)!r}\n"
                     f"CASES, MESHES = {CASES!r}, {MESHES!r}\n" + REFERENCE,
                     8)
    with np.load(ref_out) as f:
        want = {k: f[k] for k in f.files}
    got = _spawn(8, ("2x4", "4x2"), tmp, inp, CASES)
    got.update(_spawn(4, ("1x4",), tmp, inp, CASES))
    return want, got


@pytest.mark.parametrize("mesh,shape,cf,serving,f", CASES,
                         ids=[case_key(*c) for c in CASES])
def test_moe_ep_matches_reference(mesh, shape, cf, serving, f, results):
    """On the R10 case the reference is its one-device layer, and its own
    EP reads off by more than the whole output's size."""
    want, got = results
    key = case_key(mesh, shape, cf, serving, f)
    if f != F:
        ep_err = np.abs(want[key + "/ep_y"] - want[key + "/y"]).max()
        assert ep_err > np.abs(want[key + "/y"]).max(), ep_err
    err = np.abs(got[key + "/y"] - want[key + "/y"]).max()
    assert err <= 1e-5, f"y off by {err:.3g}"
    for name in AUX:
        g = float(got[f"{key}/aux/{name}"])
        w = float(want[f"{key}/aux/{name}"])
        if name == "drop_fraction" and cf == 1.0:
            assert np.float32(g) == np.float32(w), (name, g, w)
        else:
            assert abs(g - w) <= 1e-6, (name, g, w)
    for name in LEAVES + ("x",):
        g = got[f"{key}/grad/{name}"].astype(np.float64)
        w = want[f"{key}/grad/{name}"].astype(np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        bound = 1e-4 * np.abs(w).max() + 1e-6
        diff = np.abs(g - w).max()
        assert diff <= bound, f"grad {name} off by {diff:.3g} > {bound:.3g}"


def test_drops_bind_at_capacity_factor_one(results):
    """Every capacity-1.0 case whose choices can overflow a send buffer
    (t_route * k > c_send: the sliced shape on (2, 4) and (1, 4), and
    serving's on both meshes) drops some in the reference, so the exact
    ``drop_fraction`` above holds real drops."""
    from repro_torch.distributed.moe_ep import capacities
    from repro_torch.models.config import MoEConfig

    want, _ = results
    binding = []
    for mesh, shape, cf, serving, _ in CASES:
        data, model = MESHES[mesh]
        moe = MoEConfig(num_experts=E, top_k=K, d_expert=F, num_shared=1,
                        capacity_factor=cf)
        b, s, _ = SHAPES[shape]
        caps = capacities(moe, {"data": data, "model": model},
                          b // data * s, serving)
        if cf == 1.0 and caps["t_route"] * K > caps["c_send"]:
            key = case_key(mesh, shape, cf, serving)
            binding.append(key)
            assert float(want[key + "/aux/drop_fraction"]) > 0, key
    assert len(binding) == 4, binding
