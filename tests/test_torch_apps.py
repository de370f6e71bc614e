"""The port's paper applications (``repro_torch.apps``) against the JAX
reference (``repro.apps``), on the CPU.

The reference draws its initial states from ``jax.random``, so each
comparison starts both packages from the reference's state, carried over
by ``bridge.app_state_from_jax``. Tolerances are max-normalised: the
largest |port - reference| over the largest |reference|. The reference's
own properties (tests/test_apps.py) are held for the port's own states,
and each app's state survives a reshard between virtual CPU slices.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.apps as ref  # noqa: E402
from repro_torch import apps  # noqa: E402
from repro_torch.bridge import app_state_from_jax  # noqa: E402
from repro_torch.core import (gather, make_mesh, place, reshard,  # noqa: E402
                              resized_mesh, slice_devices)
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """The tier-1 run shares the machine's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def max_norm_err(got, want):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().cpu().numpy().astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def to_numpy(state):
    return jax.tree.map(np.asarray, state)


# -- the same states through both packages -----------------------------------


def test_laplacian_matvec_matches_reference():
    x = np.random.default_rng(0).standard_normal((48, 40)).astype(np.float32)
    want = ref.laplacian_matvec(jnp.asarray(x))
    got = apps.laplacian_matvec(torch.from_numpy(x))
    assert max_norm_err(got, want) < 1e-6


def test_jacobi_matches_reference():
    s_ref = ref.jacobi_init(32)
    s = app_state_from_jax("jacobi", to_numpy(s_ref), CPU)
    for _ in range(20):
        s_ref = ref.jacobi_step(s_ref)
        s = apps.jacobi_step(s)
    assert max_norm_err(s["grid"], s_ref["grid"]) < 1e-6
    assert torch.equal(s["rhs"], torch.from_numpy(np.array(s_ref["rhs"])))


@pytest.mark.parametrize("n", [32, 64])
def test_cg_matches_reference(n):
    """10 steps; the vdots sum in another order than XLA's, so 1e-4."""
    s_ref = ref.cg_init(n)
    s = app_state_from_jax("cg", to_numpy(s_ref), CPU)
    assert isinstance(s, apps.CGState)
    for _ in range(10):
        s_ref = ref.cg_step(s_ref)
        s = apps.cg_step(s)
    for name in ("x", "r", "p"):
        assert max_norm_err(getattr(s, name), getattr(s_ref, name)) < 1e-4
    rs = float(s_ref.rs)
    assert abs(float(s.rs) - rs) / rs < 1e-4


def test_nbody_matches_reference():
    s_ref = ref.nbody_init(64)
    s = app_state_from_jax("nbody", to_numpy(s_ref), CPU)
    for _ in range(10):
        s_ref = ref.nbody_step(s_ref)
        s = apps.nbody_step(s)
    for name in ("pos", "vel"):
        assert max_norm_err(s[name], s_ref[name]) < 1e-5
    assert torch.equal(s["mass"],
                       torch.from_numpy(np.array(s_ref["mass"])))


def test_bridge_takes_cg_fields_from_a_dict_and_refuses_unknown_apps():
    s_ref = to_numpy(ref.cg_init(16))
    fields = {k: getattr(s_ref, k) for k in ("x", "r", "p", "rs")}
    s = app_state_from_jax("cg", fields, CPU)
    assert s.rs.shape == () and s.x.shape == (16, 16)
    assert torch.equal(s.r, torch.from_numpy(np.array(fields["r"])))
    with pytest.raises(ValueError, match="unknown app"):
        app_state_from_jax("lm", fields, CPU)


# -- the reference's own properties (tests/test_apps.py) for the port --------


def test_cg_residual_decreases():
    s = apps.cg_init(64, device=CPU)
    r0 = float(torch.sqrt(s.rs))
    for _ in range(30):
        s = apps.cg_step(s)
    assert float(torch.sqrt(s.rs)) < 0.2 * r0


def test_cg_solves_system():
    s = apps.cg_init(32, device=CPU)
    b = s.r + apps.laplacian_matvec(s.x)
    for _ in range(200):
        s = apps.cg_step(s)
    resid = torch.linalg.norm(b - apps.laplacian_matvec(s.x))
    assert float(resid) < 1e-2 * float(torch.linalg.norm(b))


def test_jacobi_contracts():
    s = apps.jacobi_init(32, device=CPU)
    s1 = apps.jacobi_step(s)
    d_early = float((s1["grid"] - s["grid"]).abs().max())
    for _ in range(200):
        s = apps.jacobi_step(s)
    nxt = apps.jacobi_step(s)
    d_late = float((nxt["grid"] - s["grid"]).abs().max())
    assert d_late < 0.2 * d_early


def test_nbody_finite_and_momentum():
    s = apps.nbody_init(64, device=CPU)
    p0 = torch.sum(s["vel"] * s["mass"][:, None], dim=0)
    for _ in range(10):
        s = apps.nbody_step(s)
    assert bool(torch.isfinite(s["pos"]).all())
    p1 = torch.sum(s["vel"] * s["mass"][:, None], dim=0)
    assert float((p1 - p0).abs().max()) < 1e-2


def test_nbody_pair_with_itself_exerts_no_force():
    """The r2 > eps mask zeroes the diagonal: one body does not move
    itself, two bodies pull each other equally."""
    one = {"pos": torch.ones(1, 3), "vel": torch.zeros(1, 3),
           "mass": torch.ones(1)}
    assert torch.equal(apps.nbody_step(one)["vel"], torch.zeros(1, 3))
    two = {"pos": torch.tensor([[0.0, 0, 0], [1.0, 0, 0]]),
           "vel": torch.zeros(2, 3), "mass": torch.ones(2)}
    vel = apps.nbody_step(two)["vel"]
    assert vel[0, 0] > 0 and torch.equal(vel[0], -vel[1])


def test_flexible_sleep_state_size():
    fs = apps.FlexibleSleep(nbytes=1 << 20, step_s=0.0)
    st = fs.init(device=CPU)
    assert st["data"].nbytes == 1 << 20
    assert fs.step(st) is st


def test_init_is_seeded_and_defaults_to_the_card(monkeypatch):
    a = apps.jacobi_init(8, device=CPU)
    b = apps.jacobi_init(8, generator=torch.Generator().manual_seed(1),
                         device=CPU)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(a["grid"], apps.jacobi_init(
        8, generator=torch.Generator().manual_seed(2), device=CPU)["grid"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for init in (lambda: apps.cg_init(8), lambda: apps.jacobi_init(8),
                 lambda: apps.nbody_init(8),
                 lambda: apps.FlexibleSleep(nbytes=64).init(),
                 lambda: apps.calibrate("cg", 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init()


@pytest.mark.parametrize("app", sorted(apps.APPS))
def test_calibrate_times_iterations(app):
    mean, std = apps.calibrate(app, 16, iters=3, device=CPU)
    assert mean > 0 and std >= 0


# -- the state of a malleable job: resharded between virtual slices ----------


def app_states():
    return {"cg": (apps.cg_init(16, device=CPU), apps.cg_step),
            "jacobi": (apps.jacobi_init(16, device=CPU), apps.jacobi_step),
            "nbody": (apps.nbody_init(16, device=CPU), apps.nbody_step),
            "fs": (apps.FlexibleSleep(nbytes=4096, step_s=0.0).init(CPU),
                   lambda s: s)}


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("app", ["cg", "jacobi", "nbody", "fs"])
def test_app_state_survives_reshard_2_4_2(app):
    state, step = app_states()[app]
    devices = slice_devices(4, CPU)
    m2 = make_mesh(2, 1, devices=devices)
    m4 = resized_mesh(m2, 4, devices=devices)
    sharded = tree_map(place, state, apps.data_shardings(state, m2))
    s4 = reshard(sharded, apps.data_shardings(state, m4))
    for x in tree_leaves(s4):
        blocks = {tuple(s.start for s in x.index(c)) for c in x.shards}
        assert len(blocks) == (4 if x.shape else 1)
    s2 = reshard(s4, apps.data_shardings(state, m2))
    back = tree_map(gather, s2)
    assert type(back) is type(state)
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert same_bits(a, b)
    for a, b in zip(tree_leaves(step(back)), tree_leaves(step(state))):
        assert same_bits(a, b)
