"""The port's SSD scan (plain version, dispatching wrapper, the chunked
algorithm of the model) and Mamba-2 mixer against the JAX reference:
``ssd_ref``, the Pallas kernel in interpret mode and ``ssd_chunked``, on the
same numpy inputs.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version and the chunked path there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.ops import ssd_op as jax_ssd_op  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.layers import shape_tree  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssd import kernel  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_op  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_passes, ssd_ref  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from test_kernels import SSD_CASES  # noqa: E402

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# max-normalised, as tests/test_kernels.py holds the Pallas kernel
TOLS = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def make_inputs(b, s, h, p, n, jdtype, seed=0):
    """x, dt (softplus'ed), a_log, b, c as tests/test_kernels.py draws
    them, from numpy: (jax arrays, torch tensors of the same values)."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    x, bb, cc = randn(b, s, h, p), randn(b, s, n), randn(b, s, n)
    dt = np.logaddexp(0.0, randn(b, s, h)).astype(np.float32)
    a_log = randn(h) * np.float32(0.5)
    jax_in = [jnp.asarray(x).astype(jdtype), jnp.asarray(dt),
              jnp.asarray(a_log), jnp.asarray(bb).astype(jdtype),
              jnp.asarray(cc).astype(jdtype)]
    # the same (rounded) values for both packages
    torch_in = [torch.from_numpy(np.array(t.astype(jnp.float32)))
                .to(TORCH_DTYPES[jdtype] if i in (0, 3, 4) else torch.float32)
                for i, t in enumerate(jax_in)]
    return jax_in, torch_in


def as_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


def max_norm_err(got, want):
    want = as_np(want)
    return float(np.abs(as_np(got) - want).max()
                 / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("b,s,h,p,n,chunk,jdtype,_tol", SSD_CASES)
def test_ssd_matches_jax_ref_and_interpret_kernel(b, s, h, p, n, chunk,
                                                  jdtype, _tol):
    jax_in, torch_in = make_inputs(b, s, h, p, n, jdtype)
    j_ref = jax_ssd_ref(*jax_in)
    j_kernel = jax_ssd_op(*jax_in, chunk=chunk, impl="interpret")
    tol = TOLS[torch_in[0].dtype]
    for y, h_final in (ssd_ref(*torch_in),
                       ssd_op(*torch_in, chunk=chunk),
                       ssd_op(*torch_in, chunk=chunk, impl="ref")):
        assert y.dtype == torch_in[0].dtype and y.shape == (b, s, h, p)
        assert h_final.dtype == torch.float32 and \
            h_final.shape == (b, h, p, n)
        assert max_norm_err(y, j_ref) < tol
        assert max_norm_err(y, j_kernel) < tol


# (b, s, h, p, n, chunk, dtype): S divisible by the chunk; S not, so the
# reference halves its chunk (40 -> 8, 24 -> 8, 5 -> 1); S < chunk; S = 1
CHUNKED_CASES = [
    (2, 64, 3, 16, 32, 16, jnp.float32),
    (2, 40, 3, 16, 32, 16, jnp.float32),
    (1, 24, 2, 32, 16, 16, jnp.float32),
    (2, 5, 2, 16, 16, 4, jnp.float32),
    (1, 20, 2, 16, 32, 64, jnp.float32),
    (2, 1, 2, 16, 16, 16, jnp.float32),
    (2, 40, 2, 16, 32, 16, jnp.bfloat16),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,jdtype", CHUNKED_CASES)
def test_ssd_chunked_and_final_state_match_jax_chunked(b, s, h, p, n, chunk,
                                                       jdtype):
    """The port's ssd_chunked against the JAX one, y and state, and the
    plain version's final state against the JAX chunked state (the JAX
    sequential oracle returns no state)."""
    jax_in, torch_in = make_inputs(b, s, h, p, n, jdtype, seed=1)
    j_y, j_state = jax_ssm.ssd_chunked(*jax_in, chunk)
    tol = TOLS[torch_in[0].dtype]
    y, state = ssm.ssd_chunked(*torch_in, chunk)
    assert y.dtype == torch_in[0].dtype and state.dtype == torch.float32
    assert max_norm_err(y, j_y) < tol
    assert max_norm_err(state, j_state) < tol
    y_ref, h_final = ssd_ref(*torch_in)
    assert max_norm_err(h_final, j_state) < tol
    assert max_norm_err(y_ref, j_y) < tol


# (b, s, h, p, n, chunk, dtype): tests/test_kernels.py's SSD shapes, then
# ragged S (a short last chunk), S < chunk, S = 1, and a chunk above the
# kernel's 128 rows (cut to 128)
PASSES_CASES = [case[:-1] for case in SSD_CASES] + [
    (2, 100, 3, 16, 32, 32, jnp.float32),
    (1, 300, 2, 32, 16, 128, jnp.float32),
    (2, 20, 2, 16, 32, 64, jnp.float32),
    (2, 1, 2, 16, 16, 16, jnp.float32),
    (1, 300, 2, 16, 16, 256, jnp.float32),
    (2, 100, 3, 16, 32, 32, jnp.bfloat16),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,jdtype", PASSES_CASES)
def test_ssd_passes_match_jax_ref_and_chunked(b, s, h, p, n, chunk, jdtype):
    """The CUDA kernel's three passes (chunk states, state passing, chunk
    outputs), mirrored in plain PyTorch, against the JAX sequential oracle
    (y) and the port's chunked path (y and the final state), and their
    final state against the port's sequential plain version's."""
    jax_in, torch_in = make_inputs(b, s, h, p, n, jdtype, seed=2)
    tol = TOLS[torch_in[0].dtype]
    y, h_final = ssd_passes(*torch_in, chunk=chunk)
    assert y.dtype == torch_in[0].dtype and y.shape == (b, s, h, p)
    assert h_final.dtype == torch.float32 and h_final.shape == (b, h, p, n)
    assert max_norm_err(y, jax_ssd_ref(*jax_in)) < tol
    y_chunked, state = ssm.ssd_chunked(*torch_in, chunk)
    assert max_norm_err(y, y_chunked) < tol
    assert max_norm_err(h_final, state) < tol
    assert max_norm_err(h_final, ssd_ref(*torch_in)[1]) < tol


def test_ssd_passes_sum_decays_in_fp64_over_long_chunks():
    """At mamba2-130m's init seg reaches -1e3 within a chunk of 128; the
    passes sum it in fp64 as the CUDA kernel does, and agree with the
    port's chunked path (also fp64) to fp32 rounding."""
    rng = np.random.default_rng(5)
    b, s, h, p, n = 1, 256, 4, 16, 32
    args = [torch.from_numpy(v).float() for v in (
        rng.standard_normal((b, s, h, p)),
        np.logaddexp(0.0, 3.0 * rng.standard_normal((b, s, h)) + 4.0),
        np.zeros(h), rng.standard_normal((b, s, n)),
        rng.standard_normal((b, s, n)))]
    y, h_final = ssd_passes(*args, chunk=128)
    y_chunked, state = ssm.ssd_chunked(*args, 128)
    assert max_norm_err(y, y_chunked) < 1e-6
    assert max_norm_err(h_final, state) < 1e-6


@pytest.mark.parametrize("s,chunk,rows,chunks", [
    (512, 128, 128, 4), (2048, 128, 128, 16), (500, 128, 128, 4),
    (100, 128, 100, 1), (1, 128, 1, 1), (300, 256, 128, 3), (40, 16, 16, 3)])
def test_wrapper_plans_chunks_and_workspace(s, chunk, rows, chunks):
    """The wrapper's plan for the kernel: chunks of min(chunk, S, 128) rows,
    and a workspace that holds what the plain mirror's passes hand on: each
    chunk's fp32 state and seg total (chunk_states), and for bf16 inputs
    the incoming states (state_passing) in bf16 besides."""
    from repro_torch.kernels.ssd.ref import chunk_states, state_passing
    assert kernel.chunk_rows(s, chunk) == rows
    b, h, p, n = 2, 3, 16, 32
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)))
    dt = torch.from_numpy(rng.random((b, s, h)))
    a_log = torch.from_numpy(rng.standard_normal(h))
    bb = torch.from_numpy(rng.standard_normal((b, s, n)))
    states, totals = chunk_states(x, dt, a_log, bb, rows)
    h_in, _ = state_passing(states, totals)
    assert states.shape[1] == chunks
    fp32 = states.numel() + totals.numel()
    assert kernel.workspace_numel(b, s, h, p, n, chunk, torch.float32) == \
        fp32
    h_in_bf16 = h_in.to(torch.bfloat16)
    assert kernel.workspace_numel(b, s, h, p, n, chunk, torch.bfloat16) * \
        4 == fp32 * 4 + h_in_bf16.numel() * h_in_bf16.element_size()


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    """The kernel wrapper never runs a plain version: a CPU tensor is an
    error there, and only a launch adds to its count."""
    _, args = make_inputs(1, 16, 2, 16, 16, jnp.float32)
    before = kernel.ssd_scan.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.ssd_scan(*args)
    assert kernel.ssd_scan.launches == before


def test_ssd_op_rejects_unknown_impl():
    _, args = make_inputs(1, 16, 2, 16, 16, jnp.float32)
    with pytest.raises(ValueError, match="impl"):
        ssd_op(*args, impl="interpret")


def reduced_mamba2():
    _, full = jax_get_model("mamba2-130m")
    return dataclasses.replace(jax_reduced_config(full), dtype="float32")


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_leaves_a_conv_cache_decode_refuses(s):
    """A prompt shorter than conv_width - 1 = 3 tokens leaves a short conv
    cache in both packages. The reference's decode then fails on an einsum;
    the port's prefill agrees with the reference's and its decode raises a
    ValueError that says why."""
    cfg = reduced_mamba2()
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, s + 1)).astype(np.int32)
    j_pre, j_cache = jmodel.prefill(jparams, jnp.asarray(toks[:, :s]),
                                    max_len=8)
    with pytest.raises(ValueError):
        jmodel.decode_step(jparams, j_cache, jnp.asarray(toks[:, s:]),
                           jnp.int32(s))

    model = build_model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    pre, cache = model.prefill(params, torch.from_numpy(toks[:, :s]),
                               max_len=8)
    assert max_norm_err(pre, j_pre) < 1e-4
    conv = cache["blocks"]["p0"]["conv"]
    assert conv.shape == j_cache["blocks"]["p0"]["conv"].shape
    assert conv.shape[2] < cfg.conv_width - 1
    with pytest.raises(ValueError, match="conv cache holds"):
        model.decode_step(params, cache, torch.from_numpy(toks[:, s:]), s)


def flat_shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(getattr(tree, "shape", tree))}


def test_params_from_jax_carries_mamba2_trees():
    """The reference's mamba2 parameters bridge one to one onto the port's
    spec tree: the same key paths and shapes, at the reduced size (real
    arrays) and at the published widths (shapes only)."""
    cfg = reduced_mamba2()
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    model = build_model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    want = flat_shapes(tree_map(lambda s: s.shape, model.specs()))
    assert flat_shapes(params) == want
    assert flat_shapes(tree_map(lambda t: (str(t.dtype),), params)) == \
        {k: ("torch.float32",) for k in want}

    _, full = jax_get_model("mamba2-130m")
    jax_specs = shape_tree(jax_build_model(full).specs())
    port = build_model(get_config("mamba2-130m"), device="cpu")
    assert flat_shapes(tree_map(lambda s: s.shape, port.specs())) == \
        flat_shapes(jax_specs)


def test_ssd_init_cache_and_model_cache_match_reference():
    """ssd_init_cache and CausalLM.init_cache give the reference's shapes
    and dtypes: conv in the model's dtype, the state in fp32."""
    _, full = jax_get_model("mamba2-130m")
    cfg = dataclasses.replace(jax_reduced_config(full), num_layers=3)
    want = jax_ssm.ssd_init_cache(cfg, 2, jnp.bfloat16)
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    one = ssm.ssd_init_cache(port_cfg, 2, torch.bfloat16, "cpu")
    stacked = build_model(port_cfg, device="cpu").init_cache(2, 16)
    j_stacked = jax_build_model(cfg).init_cache(2, 16)
    for name in ("conv", "state"):
        assert tuple(one[name].shape) == want[name].shape
        assert str(one[name].dtype)[6:] == str(want[name].dtype)
        got = stacked["blocks"]["p0"][name]
        assert tuple(got.shape) == j_stacked["blocks"]["p0"][name].shape
        assert got.dtype == one[name].dtype and not got.any()


def test_chunked_sums_decays_in_fp64_over_long_chunks():
    """With dt as large as mamba2-130m's init makes it, seg = cumsum(dt a)
    reaches -1e3 within a chunk of 128. The reference sums it in fp32 and
    carries that sum's rounding into every decay; the port's chunked path
    (as its CUDA kernel) sums it in fp64 and stays as close to an fp64
    recurrence as the sequential fp32 plain version does."""
    rng = np.random.default_rng(5)
    b, s, h, p, n = 1, 256, 4, 16, 32
    x = rng.standard_normal((b, s, h, p))
    dt = np.logaddexp(0.0, 3.0 * rng.standard_normal((b, s, h)) + 4.0)
    a_log = np.zeros(h)
    bb, cc = rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n))
    args64 = [torch.from_numpy(v) for v in (x, dt, a_log, bb, cc)]
    # the fp64 recurrence
    a = -torch.exp(args64[2])
    state = torch.zeros((b, h, p, n), dtype=torch.float64)
    ys = []
    for t in range(s):
        state = state * torch.exp(args64[1][:, t] * a)[..., None, None] + \
            torch.einsum("bn,bhp->bhpn", args64[3][:, t],
                         args64[0][:, t] * args64[1][:, t, :, None])
        ys.append(torch.einsum("bn,bhpn->bhp", args64[4][:, t], state))
    want = torch.stack(ys, dim=1).numpy()
    args32 = [t.float() for t in args64]
    y_seq, _ = ssd_ref(*args32)
    y_chunked, _ = ssm.ssd_chunked(*args32, 128)
    j_chunked, _ = jax_ssm.ssd_chunked(
        *[jnp.asarray(t.numpy()) for t in args32], 128)
    err_seq = max_norm_err(y_seq, want)
    err_port = max_norm_err(y_chunked, want)
    err_jax = max_norm_err(j_chunked, want)
    assert err_port < 1e-5 and err_port < 4 * err_seq + 1e-7
    assert err_jax > 10 * err_port    # the reference's fp32 sum
