"""The port's RG-LRU scan (plain version, dispatching wrapper, the model's
log-depth scan) and RG-LRU block against the JAX reference: ``rglru_ref``,
the Pallas kernel in interpret mode, the associative scan, the gates, the
mixer, prefill and decode, on the same numpy inputs and bridged weights.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.ops import rglru_op as jax_rglru_op  # noqa: E402
from repro.kernels.rglru.ref import rglru_ref as jax_rglru_ref  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models.layers import init_param as jax_init_param  # noqa: E402
from repro.models.layers import shape_tree  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rglru import kernel  # noqa: E402
from repro_torch.kernels.rglru.ops import rglru_op  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_ref  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.layers import ParamSpec, init_param  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402

# elementwise, as tests/test_kernels.py holds the Pallas kernel
ATOL, RTOL = 1e-5, 1e-4
# model-level, max-normalised, as tests/test_decode_consistency.py
MODEL_TOL = 1e-4
# (b, s, w) from tests/test_kernels.py's search space (b 1-3, s 32-128,
# w 64-256), run with its chunk min(32, s) and block min(64, w)
KERNEL_CASES = [(1, 32, 64), (2, 64, 128), (3, 128, 256), (2, 128, 64)]


def make_ab(b, s, w, seed=0):
    """Decays a in (0, 0.99) and inputs b as tests/test_kernels.py draws
    them, from numpy."""
    rng = np.random.default_rng(seed)
    a = (0.99 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))) \
        .astype(np.float32)
    return a, rng.standard_normal((b, s, w), dtype=np.float32)


def as_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def max_norm_err(got, want):
    want = as_np(want)
    return float(np.abs(as_np(got) - want).max()
                 / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("b,s,w", KERNEL_CASES)
def test_rglru_matches_jax_ref_and_interpret_kernel(b, s, w):
    a, bb = make_ab(b, s, w)
    ja, jb = jnp.asarray(a), jnp.asarray(bb)
    j_ref = np.asarray(jax_rglru_ref(ja, jb))
    j_kernel = np.asarray(jax_rglru_op(ja, jb, chunk=min(32, s),
                                       block_w=min(64, w), impl="interpret"))
    ta, tb = torch.from_numpy(a), torch.from_numpy(bb)
    for h in (rglru_ref(ta, tb), rglru_op(ta, tb),
              rglru_op(ta, tb, impl="ref")):
        assert h.dtype == torch.float32 and h.shape == (b, s, w)
        np.testing.assert_allclose(h.numpy(), j_ref, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(h.numpy(), j_kernel, atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("s", [1, 37])
def test_rglru_ref_continues_from_h0_as_jax_ref(s):
    """The initial state carries on as in the JAX oracle, and a scan split
    in two at any step, the second half from the first's last state, gives
    the whole scan."""
    a, bb = make_ab(2, s, 48, seed=1)
    h0 = np.random.default_rng(2).standard_normal((2, 48), dtype=np.float32)
    want = np.asarray(jax_rglru_ref(jnp.asarray(a), jnp.asarray(bb),
                                    jnp.asarray(h0)))
    ta, tb, th0 = (torch.from_numpy(x) for x in (a, bb, h0))
    got = rglru_op(ta, tb, th0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    cut = s // 2
    first = rglru_ref(ta[:, :cut], tb[:, :cut], th0) if cut else None
    rest = rglru_ref(ta[:, cut:], tb[:, cut:],
                     first[:, -1] if cut else th0)
    joined = torch.cat([first, rest], dim=1) if cut else rest
    np.testing.assert_allclose(joined.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s", [1, 2, 5, 64, 100])
def test_log_depth_scan_matches_jax_associative_scan(s):
    """The model's CPU scan (doubling steps) against the reference's
    ``jax.lax.associative_scan``, and both against the sequential oracle,
    for S a power of two and not."""
    a, bb = make_ab(2, s, 32, seed=3)
    want = np.asarray(jax_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(bb)))
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        got.numpy(), rglru_ref(torch.from_numpy(a),
                               torch.from_numpy(bb)).numpy(),
        atol=ATOL, rtol=RTOL)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    """The kernel wrapper never runs a plain version: a CPU tensor is an
    error there, and only a launch adds to its count."""
    a, bb = (torch.from_numpy(x) for x in make_ab(1, 8, 16))
    before = kernel.rglru_scan.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.rglru_scan(a, bb)
    assert kernel.rglru_scan.launches == before


def test_rglru_op_rejects_unknown_impl():
    a, bb = (torch.from_numpy(x) for x in make_ab(1, 8, 16))
    with pytest.raises(ValueError, match="impl"):
        rglru_op(a, bb, impl="interpret")


def test_lru_a_init_lies_in_the_reference_range():
    """``lru_a`` draws u uniform in [0.9, 0.999) and returns the inverse
    softplus of -8 log u: softplus(lam) / 8 = -log u, so exp of minus it
    lies in the range, as the reference's init does."""
    spec = ParamSpec((4, 4096), ("layers", "state"), "lru_a")
    lam = init_param(torch.Generator().manual_seed(0), spec, torch.float32)
    u = torch.exp(-torch.nn.functional.softplus(lam.double()) / 8.0)
    assert lam.shape == (4, 4096) and torch.isfinite(lam).all()
    assert u.min() >= 0.9 - 1e-6 and u.max() < 0.999 + 1e-6
    assert u.max() - u.min() > 0.09                 # spread over the range
    j_lam = np.asarray(jax_init_param(jax.random.PRNGKey(0), _jax_spec(spec),
                                      jnp.float32))
    j_u = np.exp(-np.logaddexp(0.0, j_lam.astype(np.float64)) / 8.0)
    assert j_u.min() >= 0.9 - 1e-6 and j_u.max() < 0.999 + 1e-6


def _jax_spec(spec):
    from repro.models.layers import ParamSpec as JaxParamSpec
    return JaxParamSpec(spec.shape, spec.logical, spec.init, spec.scale)


# -- the block ---------------------------------------------------------------------


def reduced_cfg(**changes):
    _, full = jax_get_model("recurrentgemma-9b")
    return dataclasses.replace(jax_reduced_config(full), dtype="float32",
                               **changes)


def block_setup(seed=0):
    """(cfg, port cfg, jax mixer params, port mixer params, x as numpy):
    one RG-LRU mixer of the reduced config, weights drawn as the
    reference's init draws an unstacked layer's."""
    cfg = reduced_cfg()
    specs = jax_rglru.rglru_specs(cfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(specs))
    jparams = {name: jax_init_param(k, spec, jnp.float32)
               for k, (name, spec) in zip(keys, specs.items())}
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, cfg.d_model), dtype=np.float32)
    return cfg, ModelConfig(**dataclasses.asdict(cfg)), jparams, params, x


def test_gates_match_jax():
    cfg, _, jparams, params, x = block_setup()
    xw = x[..., :cfg.lru_width]
    ja, jb = jax_rglru._gates(jparams, jnp.asarray(xw))
    a, b = rglru._gates(params, torch.from_numpy(xw))
    assert a.dtype == b.dtype == torch.float32
    assert max_norm_err(a, ja) < 1e-6 and max_norm_err(b, jb) < 1e-6


def test_gates_round_exp_as_the_reference_where_beta_cancels():
    """beta = sqrt(1 - exp(2 log a)) cancels where log a is tiny (the
    recurrence gate r near 0): there one ulp of exp moves beta by a large
    fraction. The port takes each exp in fp64 and rounds it once; in that
    range XLA's fp32 exp gives the same bits, where torch's fp32 exp rounds
    the other way for some inputs. On inputs that saturate r, the port's
    gates then agree with the reference's to fp32 rounding, where the same
    formula with torch's fp32 exp is off by orders of magnitude more.
    (Weights drawn at a depth the model does not have saturate r;
    tests/test_torch_model.py says what that does at model level.)"""
    rng = np.random.default_rng(7)
    log_a = -np.exp(rng.uniform(np.log(1e-9), np.log(1e-5), 4096)) \
        .astype(np.float32)
    j_exp = np.asarray(jnp.exp(2.0 * jnp.asarray(log_a)))
    t_log_a = torch.from_numpy(log_a)
    rounded = torch.exp(2.0 * t_log_a.double()).float().numpy()
    fp32 = torch.exp(2.0 * t_log_a).numpy()
    np.testing.assert_array_equal(rounded, j_exp)
    assert (fp32 != j_exp).mean() > 0.01

    cfg, _, jparams, params, _ = block_setup()
    x = (40.0 * rng.standard_normal((1, 64, cfg.lru_width))).astype(
        np.float32)
    ja, jb = jax_rglru._gates(jparams, jnp.asarray(x))
    a, b = rglru._gates(params, torch.from_numpy(x))
    r = torch.sigmoid(torch.from_numpy(x) @ params["w_a"] + params["b_a"])
    assert (r < 1e-6).float().mean() > 0.05          # r saturates
    log_a = -8.0 * r * torch.nn.functional.softplus(params["lam"])
    b_fp32 = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                        1e-12)) * torch.sigmoid(
        torch.from_numpy(x) @ params["w_x"] + params["b_x"]) * \
        torch.from_numpy(x)
    assert max_norm_err(a, ja) < 1e-6 and max_norm_err(b, jb) < 1e-6
    assert max_norm_err(b_fp32, jb) > 100 * max(max_norm_err(b, jb), 1e-9)


def test_mixer_prefill_and_decode_match_jax():
    """rglru_mixer_apply, rglru_prefill (output, conv and h caches) and
    decode steps from the prefill's cache, against the reference; the port
    updates the cache in place and returns the same dict."""
    cfg, port_cfg, jparams, params, x = block_setup(seed=1)
    s = 20
    jy = jax_rglru.rglru_mixer_apply(jparams, jnp.asarray(x), cfg)
    y = rglru.rglru_mixer_apply(params, torch.from_numpy(x), port_cfg)
    assert max_norm_err(y, jy) < MODEL_TOL

    jy, jcache = jax_rglru.rglru_prefill(jparams, jnp.asarray(x[:, :s]), cfg)
    y, cache = rglru.rglru_prefill(params, torch.from_numpy(x[:, :s]),
                                   port_cfg)
    assert max_norm_err(y, jy) < MODEL_TOL
    for name in ("conv", "h"):
        assert cache[name].shape == jcache[name].shape
        assert max_norm_err(cache[name], jcache[name]) < MODEL_TOL
    assert cache["h"].dtype == torch.float32
    for t in range(s, x.shape[1]):
        jy, jcache = jax_rglru.rglru_decode(
            jparams, jnp.asarray(x[:, t:t + 1]), cfg, jcache)
        y, out = rglru.rglru_decode(params, torch.from_numpy(x[:, t:t + 1]),
                                    port_cfg, cache)
        assert out is cache
        assert max_norm_err(y, jy) < MODEL_TOL
        assert max_norm_err(cache["h"], jcache["h"]) < MODEL_TOL
        assert max_norm_err(cache["conv"], jcache["conv"]) < MODEL_TOL
    # decode continues the scan: its last output is the full mixer's
    full = rglru.rglru_mixer_apply(params, torch.from_numpy(x), port_cfg)
    assert max_norm_err(y[:, 0], full[:, -1]) < MODEL_TOL


def test_init_cache_matches_reference():
    """CausalLM.init_cache gives the reference's shapes, dtypes and values:
    conv in the model's dtype, h in fp32, zeros, and the local layer's ring
    of min(window, max_len) slots at position -1."""
    cfg = dataclasses.replace(reduced_cfg(), dtype="bfloat16")
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    for max_len in (16, 200):
        got = build_model(port_cfg, device="cpu").init_cache(2, max_len)
        ref = jax_build_model(cfg).init_cache(2, max_len)
        got_leaves, ref_leaves = flat(got), flat(ref)
        assert sorted(got_leaves) == sorted(ref_leaves)
        for path, w in ref_leaves.items():
            g = got_leaves[path]
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype)[6:] == str(w.dtype), path
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_params_from_jax_carries_recurrentgemma_trees():
    """The reference's recurrentgemma parameters bridge one to one onto the
    port's spec tree: the same key paths and shapes (stacked units and the
    2-layer tail), at the reduced size (real arrays) and at the published
    widths (shapes only)."""
    cfg = reduced_cfg(num_layers=8)
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    model = build_model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    want = flat(tree_map(lambda s: s.shape, model.specs()))
    assert {k: tuple(v.shape) for k, v in flat(params).items()} == want
    assert {"tail0", "tail1", "blocks"} <= {k[0] for k in want}

    _, full = jax_get_model("recurrentgemma-9b")
    jax_specs = flat(shape_tree(jax_build_model(full).specs()))
    port = build_model(get_config("recurrentgemma-9b"), device="cpu")
    assert flat(tree_map(lambda s: s.shape, port.specs())) == \
        {k: tuple(v) for k, v in jax_specs.items()}


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_leaves_a_conv_cache_decode_refuses(s):
    """A prompt shorter than conv_width - 1 = 3 tokens leaves a short conv
    cache in both packages. The reference's rglru_decode then fails on its
    einsum; the port's prefill agrees with the reference's and its decode
    raises a ValueError that says why."""
    cfg = reduced_cfg()
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
    assert max_norm_err(pre, j_pre) < MODEL_TOL
    conv = cache["blocks"]["p0"]["conv"]
    assert conv.shape == j_cache["blocks"]["p0"]["conv"].shape
    assert conv.shape[2] < cfg.conv_width - 1
    with pytest.raises(ValueError, match="conv cache holds"):
        model.decode_step(params, cache, torch.from_numpy(toks[:, s:]), s)


def per_layer_fan_in_draw(specs, init, rng):
    """Numpy weights for a stacked parameter tree, each normal weight drawn
    at one layer's fan-in (the axes a product sums over: all but the last
    of a projection back to the embedding, else the first), the rest
    (zeros, lru_a) taken from ``init``, the reference's own draw."""
    if isinstance(specs, dict):
        return {k: per_layer_fan_in_draw(specs[k], init[k], rng)
                for k in specs}
    if specs.init != "normal":
        return np.asarray(init)
    one, axes = specs.shape[1:], specs.logical[1:]
    fan = (int(np.prod(one[:-1])) if len(one) > 1 and axes[-1] == "embed"
           else one[0])
    return (rng.standard_normal(specs.shape) / np.sqrt(fan)).astype(
        np.float32)


def test_unit_agrees_with_jax_at_a_per_layer_fan_in():
    """One (rglru, rglru, local) unit in fp32, its stacked weights drawn by
    numpy at a per-layer fan-in and carried to both packages by the bridge
    (chip_smoke.py draws the same way on the card, ROADMAP.md Queue 3): the
    forward's logits and the prefill cache's recurrent states agree to
    MODEL_TOL, max-normalised, beyond the window (prompt 80, window 64)."""
    cfg = reduced_cfg(num_layers=3)
    model = jax_build_model(cfg)
    ref_init = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(2)))
    np_params = dict(ref_init, blocks=per_layer_fan_in_draw(
        model.specs()["blocks"], ref_init["blocks"],
        np.random.default_rng(3)))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 80))
    jparams = jax.tree.map(jnp.asarray, np_params)
    want, _ = jax.jit(model.forward)(jparams, jnp.asarray(toks))
    _, want_cache = jax.jit(model.prefill, static_argnames="max_len")(
        jparams, jnp.asarray(toks), max_len=88)
    port = build_model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    params = params_from_jax(np_params, device="cpu")
    got, _ = port.forward(params, torch.from_numpy(toks))
    _, got_cache = port.prefill(params, torch.from_numpy(toks), max_len=88)
    assert max_norm_err(got, np.asarray(want)) < MODEL_TOL
    for j in ("p0", "p1"):
        assert max_norm_err(got_cache["blocks"][j]["h"], np.asarray(
            want_cache["blocks"][j]["h"])) < MODEL_TOL
