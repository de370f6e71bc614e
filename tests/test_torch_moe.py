"""The port's mixture-of-experts feed-forward (``models/moe.py``) and the
"moe" block kind against the JAX reference, on the CPU.

The same numpy inputs and the reference's own parameters (through the
bridge) go through ``repro.models.moe.moe_apply`` and the port's: outputs
and the router's loss at fp32, 1e-5 max-normalised, and the routing (the
chosen experts, their slots, the tokens dropped) equal. Capacities: the
reduced configs' factor 8.0 (no token drops), 0.5 and 1.0 (tokens drop),
and decode's factor ``top_k`` at S 1. Then the reduced gemma2, phi3.5 and
deepseek through ``loss`` (with its aux term, whole and in ``ce_chunk``
chunks), and every decoder config's parameter tree at its published sizes
against the reference's, from shapes only.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.layers import init_from_specs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import ParamSpec  # noqa: E402

# fp32 on both sides, the same products summed in another order
TOL = 1e-5
# the model-level tolerance of tests/test_decode_consistency.py
MODEL_TOL = 1e-4
MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-moe-16b"]
DECODERS = ["smollm-135m", "granite-3-2b", "qwen3-4b", "gemma2-27b",
            "recurrentgemma-9b", "mamba2-130m", "phi3.5-moe-42b-a6.6b",
            "deepseek-moe-16b"]


def reduced(arch):
    """The reference's reduced config of ``arch`` in fp32, and the port's
    copy of it."""
    cfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                              dtype="float32")
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def max_norm(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / (np.abs(want).max() + 1e-6))


def moe_case(arch, s, seed=0):
    """The reference's moe parameters for ``arch``'s reduced config and an
    input (2, s, d_model), as numpy."""
    cfg, pcfg = reduced(arch)
    params = init_from_specs(jax.random.PRNGKey(2), jax_moe.moe_specs(cfg),
                             jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    return cfg, pcfg, jax.tree.map(np.asarray, params), x


def jax_slots(cfg, x, params, factor):
    """The reference's routing, recomputed from its own steps: the experts
    top_k picks and each choice's slot (``ne * cap`` where it drops)."""
    logits = (jnp.asarray(x) @ params["router"]).astype(jnp.float32)
    _, experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    bsz, s = x.shape[:2]
    ne = cfg.num_experts
    cap = jax_moe.capacity(cfg, s, factor)
    flat_e = experts.reshape(bsz, s * cfg.top_k)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, ne, dtype=jnp.int32), axis=1) - 1
    my_pos = jnp.take_along_axis(pos, flat_e[..., None], axis=-1)[..., 0]
    slot = jnp.where(my_pos < cap, flat_e * cap + my_pos, ne * cap)
    return np.asarray(experts), np.asarray(slot), cap


# (arch, sequence length, capacity factor): None is the config's (8.0 in
# the reduced configs, nothing drops); 0.5 and 1.0 drop tokens at S 64;
# top_k at S 1 is decode's
MOE_CASES = [(arch, s, factor) for arch in MOE_ARCHS
             for s, factor in ((40, None), (64, 0.5), (64, 1.0), (1, "top_k"))]


@pytest.mark.parametrize("arch,s,factor", MOE_CASES)
def test_moe_apply_matches_jax(arch, s, factor):
    cfg, pcfg, params, x = moe_case(arch, s)
    if factor == "top_k":
        factor = float(cfg.top_k)
    want_y, want_aux = jax_moe.moe_apply(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg,
        capacity_factor=factor)
    tp = params_from_jax(params, device="cpu")
    tx = torch.from_numpy(x)
    got_y, got_aux = moe.moe_apply(tp, tx, pcfg, capacity_factor=factor)
    assert got_y.shape == want_y.shape and got_y.dtype == torch.float32
    assert max_norm(got_y, want_y) < TOL
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=TOL)

    # the same experts, in the same order, and the same slots
    experts, slots, cap = jax_slots(
        cfg, x, params, cfg.capacity_factor if factor is None else factor)
    _, got_experts, _, _ = moe.route(tp, tx, pcfg)
    np.testing.assert_array_equal(got_experts.numpy(), experts)
    got_slots = moe.dispatch_slots(got_experts, cfg.num_experts, cap)
    np.testing.assert_array_equal(got_slots.numpy(), slots)
    dropped = int((slots == cfg.num_experts * cap).sum())
    if factor in (0.5, 1.0):
        assert dropped > 0, "the capacity should bite"
    else:
        assert dropped == 0


def test_moe_drops_choices_past_capacity_in_token_order():
    """With every token routed to the same two experts, each expert keeps
    its first ``cap`` choices, counted token-major, and the rest drop."""
    cfg, pcfg = reduced("phi3.5-moe-42b-a6.6b")
    experts = torch.tensor([[[3, 5]] * 12])              # (1, 12, k 2)
    slots = moe.dispatch_slots(experts, cfg.num_experts, 8)
    ne_cap = cfg.num_experts * 8
    want = [[3 * 8 + t, 5 * 8 + t] if t < 8 else [ne_cap, ne_cap]
            for t in range(12)]
    assert slots.reshape(12, 2).tolist() == want


def test_moe_drops_leave_the_shared_path():
    """A token whose every choice drops gets only the shared experts'
    output (deepseek), or zeros without them (phi3.5)."""
    for arch in MOE_ARCHS:
        cfg, pcfg, params, x = moe_case(arch, 64)
        tp = params_from_jax(params, device="cpu")
        tx = torch.from_numpy(x)
        factor = 0.5
        _, experts, _, _ = moe.route(tp, tx, pcfg)
        cap = moe.capacity(pcfg, 64, factor)
        slots = moe.dispatch_slots(experts, pcfg.num_experts, cap).reshape(
            2, 64, pcfg.top_k)
        gone = (slots == pcfg.num_experts * cap).all(-1)
        assert gone.any()
        y, _ = moe.moe_apply(tp, tx, pcfg, capacity_factor=factor)
        if pcfg.num_shared_experts:
            from repro_torch.models.layers import mlp_apply
            rest = mlp_apply(tp["shared"], tx, pcfg)[gone]
        else:
            rest = torch.zeros_like(y[gone])
        torch.testing.assert_close(y[gone], rest, rtol=0, atol=0)


LOSS_ARCHS = ["gemma2-27b", "phi3.5-moe-42b-a6.6b", "deepseek-moe-16b"]


@pytest.mark.parametrize("ce_chunk", [0, 16])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_with_router_aux_matches_jax(arch, ce_chunk):
    """``loss`` of the reduced config: the total (cross-entropy plus the
    routers' loss) and each part against the reference's, whole and by
    ``ce_chunk``."""
    cfg, pcfg = reduced(arch)
    cfg = dataclasses.replace(cfg, ce_chunk=ce_chunk)
    pcfg = dataclasses.replace(pcfg, ce_chunk=ce_chunk)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    want, want_parts = model.loss(params, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)})
    port = build_model(pcfg, device="cpu")
    got, parts = port.loss(params_from_jax(jax.tree.map(np.asarray, params),
                                           device="cpu"),
                           {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=MODEL_TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[key]), float(want_parts[key]),
                                   rtol=MODEL_TOL, atol=1e-9)
    if cfg.family == "moe":
        assert float(parts["aux"]) > 0
    else:
        assert float(parts["aux"]) == 0


def spec_shapes(tree, is_spec):
    """{key path: (shape, logical axes)} of a spec tree."""
    out = {}

    def walk(t, path):
        if is_spec(t):
            out[path] = (tuple(t.shape), tuple(t.logical))
        else:
            for k, v in t.items():
                walk(v, path + (k,))
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", DECODERS)
def test_param_tree_at_published_sizes_matches_jax(arch):
    """The port's ``specs()`` and the reference's ``CausalLM.specs()`` at
    the published config, from shapes only (nothing allocated): the same
    key paths, shapes and logical axes."""
    from repro.models.layers import is_spec
    ref = jax_build_model(jax_get_config(arch)).specs()
    mine = build_model(get_config(arch), device="cpu").specs()
    want = spec_shapes(ref, is_spec)
    got = spec_shapes(mine, lambda t: isinstance(t, ParamSpec))
    assert got == want


def test_bridge_carries_the_moe_tree_one_to_one():
    """deepseek's reduced tree through the bridge: the router, stacked
    experts (E, D, F) / (E, F, D), the shared experts and the dense head0,
    every leaf equal and of its shape."""
    cfg, _ = reduced("deepseek-moe-16b")
    params = jax.tree.map(np.asarray,
                          jax_build_model(cfg).init(jax.random.PRNGKey(5)))
    got = params_from_jax(params, device="cpu")
    ffn = got["blocks"]["p0"]["ffn"]
    e, f, ne = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    reps = cfg.num_layers - cfg.first_dense_layers
    assert ffn["router"].shape == (reps, e, ne)
    assert ffn["w_gate"].shape == ffn["w_up"].shape == (reps, ne, e, f)
    assert ffn["w_down"].shape == (reps, ne, f, e)
    assert ffn["shared"]["w_gate"].shape == (reps, e, 2 * f)
    assert got["head0"]["ffn"]["w_gate"].shape == (e, cfg.first_dense_ff)
    flat = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat:
        t = got
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), leaf)
