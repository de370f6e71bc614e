"""The port's int8 compressed gradient all-reduce (``optim/compression.py``)
against the JAX reference, on the CPU.

``_quantize`` / ``_dequantize`` bit-equal to the reference's on the same
numpy inputs (ragged sizes, an all-zero block, ties that round half to
even). ``compressed_psum_grads`` on 4 virtual CPU slices against the
reference's inside ``shard_map`` on 4 forced host devices (a subprocess,
as ``tests/test_multidevice.py`` runs it): the means and the residuals of
12 error-feedback steps, bit for bit. Then the error-feedback property of
``tests/test_multidevice.py::test_compressed_allreduce_error_feedback_converges``
on the port alone, groups over a pod axis, and the callable of
``make_compressed_allreduce``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim.compression import _dequantize as jax_dequantize  # noqa: E402
from repro.optim.compression import _quantize as jax_quantize  # noqa: E402
from repro_torch.core import (PartitionSpec, NamedSharding,  # noqa: E402
                              make_mesh, slice_devices)
from repro_torch.optim import (compressed_psum_grads,  # noqa: E402
                               make_compressed_allreduce)
from repro_torch.optim.compression import _dequantize, _quantize  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 12


def bits(x):
    """The bit pattern of a float32 array (so -0.0 and 0.0 differ)."""
    return np.asarray(x, dtype=np.float32).view(np.int32)


def quant_input(n, scale, zero_block=False):
    x = (np.random.RandomState(n).randn(n) * scale).astype(np.float32)
    if zero_block:
        x[256:512] = 0.0
    return x


@pytest.mark.parametrize("n,scale,zero_block", [
    (1, 1.0, False), (255, 0.01, False), (256, 3.0, False),
    (1000, 100.0, False),            # ragged: 1000 = 3 blocks + 232
    (777, 1.0, True),                # an all-zero block
    (4096, 1e-3, False)])
def test_quantize_dequantize_bit_equal_to_jax(n, scale, zero_block):
    x = quant_input(n, scale, zero_block)
    want_q, want_s = jax_quantize(jnp.asarray(x))
    got_q, got_s = _quantize(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(bits(got_s.numpy()), bits(want_s))
    want = jax_dequantize(want_q, want_s, (n,), n)
    got = _dequantize(got_q, got_s, (n,), n)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    # per-block max-abs scaling bounds the error by scale / 127 an element
    # (tests/test_optim.py::test_quantize_roundtrip_bounded_error)
    assert np.abs(got.numpy() - x).max() <= np.abs(x).max() / 127.0 + 1e-6
    if zero_block:
        assert got_s[1].item() == 0.0 and not got_q[1].any()


def test_quantize_rounds_half_to_even():
    """A block whose largest value is 127 has scale 1: 0.5, 1.5, 2.5 and
    -2.5 round to 0, 2, 2 and -2, on both sides."""
    x = np.zeros(256, np.float32)
    x[:5] = [127.0, 0.5, 1.5, 2.5, -2.5]
    want_q, _ = jax_quantize(jnp.asarray(x))
    got_q, got_s = _quantize(torch.from_numpy(x))
    assert got_s.item() == 1.0
    assert got_q[0, :5].tolist() == [127, 0, 2, 2, -2]
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


# the reference's compressed_psum_grads inside shard_map on 4 forced host
# devices: STEPS error-feedback steps over two leaves (one ragged), the
# residuals carried from step to step
REFERENCE_RUN = """
import numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.core import make_mesh
from repro.optim.compression import compressed_psum_grads
mesh = make_mesh(4, 1)
data = np.load(IN)

def body(a, b, ea, eb):
    mean, errs = compressed_psum_grads(
        {"a": a[0], "b": b[0]}, mesh, axes=("data",),
        errors={"a": ea[0], "b": eb[0]})
    return (mean["a"][None], mean["b"][None], errs["a"][None],
            errs["b"][None])

spec = P("data")
fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                       out_specs=(spec,) * 4, check_rep=False))
ea = jnp.zeros(data["a"].shape[1:], jnp.float32)
eb = jnp.zeros(data["b"].shape[1:], jnp.float32)
out = {k: [] for k in ("ma", "mb", "ea", "eb")}
for t in range(data["a"].shape[0]):
    ma, mb, ea, eb = fn(data["a"][t], data["b"][t], ea, eb)
    for k, v in zip(out, (ma, mb, ea, eb)):
        out[k].append(np.asarray(v))
np.savez(OUT, **{k: np.stack(v) for k, v in out.items()})
"""


def grads_of_step(data, t):
    return [{"a": torch.from_numpy(data["a"][t, i]),
             "b": torch.from_numpy(data["b"][t, i])} for i in range(4)]


def test_compressed_psum_grads_bit_equal_to_jax_over_12_steps(tmp_path):
    rng = np.random.default_rng(7)
    data = {"a": rng.standard_normal((STEPS, 4, 3, 100)).astype(np.float32),
            "b": (rng.standard_normal((STEPS, 4, 512)) * 1e-3).astype(
                np.float32)}
    data["b"][:, 2, :256] *= 50.0          # one slice sets block 0's scale
    np.savez(tmp_path / "in.npz", **data)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    code = (f"IN = {str(tmp_path / 'in.npz')!r}\n"
            f"OUT = {str(tmp_path / 'out.npz')!r}\n" + textwrap.dedent(
                REFERENCE_RUN))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = np.load(tmp_path / "out.npz")

    mesh = make_mesh(4, 1, devices=slice_devices(4, "cpu"))
    errors = None
    for t in range(STEPS):
        means, errors = compressed_psum_grads(grads_of_step(data, t), mesh,
                                              axes=("data",), errors=errors)
        for i in range(4):
            for leaf in ("a", "b"):
                got_m, got_e = means[i][leaf], errors[i][leaf]
                assert got_m.dtype == got_e.dtype == torch.float32
                assert got_m.shape == data[leaf].shape[2:]
                np.testing.assert_array_equal(
                    bits(got_m.numpy()), bits(ref["m" + leaf][t, i]),
                    err_msg=f"mean {leaf}, step {t}, slice {i}")
                np.testing.assert_array_equal(
                    bits(got_e.numpy()), bits(ref["e" + leaf][t, i]),
                    err_msg=f"residual {leaf}, step {t}, slice {i}")
    # every slice has a buffer of its own
    ptrs = {means[i]["a"].data_ptr() for i in range(4)}
    assert len(ptrs) == 4


def test_error_feedback_converges():
    """A single shot is within 0.25 of the true mean (max-normalised);
    the running average of 12 synced gradients with error feedback is
    closer, and within 0.05 (tests/test_multidevice.py:144)."""
    g = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    truth = g.mean(axis=0)
    mesh = make_mesh(4, 1, devices=slice_devices(4, "cpu"))
    grads = [{"g": torch.from_numpy(g[i])} for i in range(4)]
    errors, acc, first = None, torch.zeros(64), None
    for t in range(STEPS):
        means, errors = compressed_psum_grads(grads, mesh, errors=errors)
        acc += means[0]["g"]
        first = means[0]["g"] if first is None else first
    scale = np.abs(truth).max() + 1e-9
    rel1 = np.abs(first.numpy() - truth).max() / scale
    rel_n = np.abs((acc / STEPS).numpy() - truth).max() / scale
    assert rel1 < 0.25
    assert rel_n < rel1
    assert rel_n < 0.05


def test_groups_follow_the_reduced_axes():
    """On a (pod 2, data 2) mesh, axes ("data",) reduces within each pod;
    ("pod", "data") over all four, the same as one (data 4) mesh."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((4, 300)).astype(np.float32)
    grads = [{"g": torch.from_numpy(g[i])} for i in range(4)]
    cpu4 = slice_devices(4, "cpu")
    podded = make_mesh(2, 1, pod=2, devices=cpu4)
    flat = make_mesh(4, 1, devices=cpu4)
    within, _ = compressed_psum_grads(grads, podded, axes=("data",))
    for pod in range(2):
        alone, _ = compressed_psum_grads(
            grads[2 * pod:2 * pod + 2], make_mesh(2, 1, devices=cpu4))
        for j in range(2):
            torch.testing.assert_close(within[2 * pod + j]["g"],
                                       alone[j]["g"], rtol=0, atol=0)
    everywhere, _ = compressed_psum_grads(grads, podded)
    together, _ = compressed_psum_grads(grads, flat)
    for i in range(4):
        torch.testing.assert_close(everywhere[i]["g"], together[i]["g"],
                                   rtol=0, atol=0)
        torch.testing.assert_close(everywhere[i]["g"], everywhere[0]["g"],
                                   rtol=0, atol=0)


def test_make_compressed_allreduce_over_data_axes_only():
    cpu4 = slice_devices(4, "cpu")
    mesh = make_mesh(4, 1, devices=cpu4)
    specs = {"g": NamedSharding(mesh, PartitionSpec())}
    allreduce = make_compressed_allreduce(mesh, specs)
    g = np.random.default_rng(4).standard_normal((4, 70)).astype(np.float32)
    grads = [{"g": torch.from_numpy(g[i])} for i in range(4)]
    got, got_err = allreduce(grads)
    want, want_err = compressed_psum_grads(grads, mesh)
    for i in range(4):
        torch.testing.assert_close(got[i]["g"], want[i]["g"], rtol=0, atol=0)
        torch.testing.assert_close(got_err[i]["g"], want_err[i]["g"],
                                   rtol=0, atol=0)
    other = make_mesh(4, 1, devices=cpu4)
    with pytest.raises(ValueError, match="mesh"):
        make_compressed_allreduce(other, specs)
    # with a model axis the sum runs over the data axis once per model
    # coordinate: coordinates (0, m) and (1, m) get the mean of their two
    # trees, as two slices of one model way do
    two_ways = make_mesh(2, 2, devices=cpu4)
    got, got_err = make_compressed_allreduce(two_ways, {})(grads)
    for m in range(2):
        want, want_err = compressed_psum_grads(
            [grads[m], grads[2 + m]], make_mesh(2, 1, devices=cpu4[:2]))
        for d in range(2):
            torch.testing.assert_close(got[2 * d + m]["g"], want[d]["g"],
                                       rtol=0, atol=0)
            torch.testing.assert_close(got_err[2 * d + m]["g"],
                                       want_err[d]["g"], rtol=0, atol=0)
