"""The port's CausalLM (forward, prefill, decode_step) against the JAX
reference, on the reference's own weights carried over by the bridge.

Configs: ``reduced_config(smollm)``, smollm's true widths (d_model 576, 9
query / 3 KV heads, d_ff 1536) cut to 2 layers and a 2048 vocab (the 9/3
head layout is the odd GQA group that the reduced 4/1 never exercises), the
reduced qwen3 (qk_norm) and granite, and mamba2 reduced and at its true
widths (d_inner 1536, 24 SSD heads of 64, state 128, chunk 128) cut to 2
layers and a 2048 vocab, and recurrentgemma reduced (8 layers: two
(rglru, rglru, local) units and the 2-layer tail, window 64, a prompt of 80
so that the local ring wraps) and at its attention's true shape (16 query
heads on 1 KV head, head_dim 256) cut to one unit, and the reduced gemma2
(local + global layers with softcaps, a prompt of 80 beyond the window of
64), phi3.5-moe and deepseek-moe (shared experts, a first dense layer),
whose forward also gives the routers' loss. On the CPU
``attn_impl="auto"`` takes the chunked attention, which is also held
against the plain attention here, the SSD mixer takes the chunked scan and
the RG-LRU mixer its log-depth scan; the kernel branches run only on the
card, where ``chip_smoke.py`` holds them against the CPU paths.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402

KEY = jax.random.PRNGKey(1)
T = 5            # decode steps after the prefill, unless STEPS says
# max-normalised, as tests/test_decode_consistency.py holds the reference
TOL = 1e-4


def reduced_fp32(full):
    return dataclasses.replace(jax_reduced_config(full), dtype="float32")


CASES = {
    # name: (architecture, its test config, batch, prompt length)
    "smollm-reduced": ("smollm-135m", reduced_fp32, 2, 32),
    "smollm-widths-2-layers": ("smollm-135m", lambda full: dataclasses.replace(
        full, num_layers=2, vocab_size=2048, dtype="float32"), 2, 64),
    # the other configs build_model accepts: qk_norm, a 4:1 GQA group
    "qwen3-reduced": ("qwen3-4b", reduced_fp32, 2, 32),
    "granite-reduced": ("granite-3-2b", reduced_fp32, 2, 32),
    # attention-free "ssd" blocks: the prompt spans two chunks of the
    # reduced config's 16, the full sequence does not divide them
    "mamba2-reduced": ("mamba2-130m", reduced_fp32, 2, 32),
    "mamba2-widths-2-layers": ("mamba2-130m", lambda full: dataclasses.replace(
        full, num_layers=2, vocab_size=2048, dtype="float32"), 2, 64),
    # rglru + local blocks: a prompt beyond the window of 64, decode on
    # the wrapped ring
    "recurrentgemma-reduced": ("recurrentgemma-9b", lambda full:
                               dataclasses.replace(reduced_fp32(full),
                                                   num_layers=8), 2, 80),
    "recurrentgemma-heads-256": ("recurrentgemma-9b", lambda full:
                                 dataclasses.replace(
                                     reduced_fp32(full), num_layers=3,
                                     num_heads=16, num_kv_heads=1,
                                     head_dim=256), 2, 80),
    # local + global with softcaps: the local ring wraps
    "gemma2-reduced": ("gemma2-27b", reduced_fp32, 2, 80),
    # "moe" blocks: routed experts; shared experts and a dense head0
    "phi3.5-moe-reduced": ("phi3.5-moe-42b-a6.6b", reduced_fp32, 2, 32),
    "deepseek-moe-reduced": ("deepseek-moe-16b", reduced_fp32, 2, 32),
}
# Decode steps of the recurrentgemma cases: the forward pass spans 96
# tokens, which the attention's chunk of 64 halves to 32 (at 85 it would
# halve to 1 and the reference would trace thousands of chunk pairs).
STEPS = {"recurrentgemma-reduced": 16, "recurrentgemma-heads-256": 16,
         "gemma2-reduced": 16}
# Cases whose reference runs under jax.jit: eagerly, the RG-LRU's
# associative scan and the unit's scan run op by op for minutes.
JIT = {"recurrentgemma-reduced", "recurrentgemma-heads-256"}
# Cases whose weights are drawn at the architecture's own depth and cut to
# the case's layers. The reference's init takes a stacked weight's layers
# axis as its fan-in, so mamba2's 2 layers drawn on their own get weights
# sqrt(12) times mamba2-130m's: dt reaches 60, and the reference's fp32
# chunk sums (the port's are fp64) put the two packages' logits at the
# edge of the 1e-4 tolerance (ROADMAP.md, Queue 3). Drawn for 24 layers, as
# mamba2-130m's are, they sit well inside it. recurrentgemma's units drawn
# for 8 layers (or 3) get weights sqrt(6) (or sqrt(12)) times
# recurrentgemma-9b's: the recurrence gate's pre-activation z grows with
# them, r = sigmoid(z) saturates, and there log a = -8 r softplus(lam)
# turns z's absolute rounding error into a relative error of the gated
# input (and 1 - exp(2 log a) cancels). The two packages' fp32 logits then
# differ by 2.5e-4 (1.2e-4 at 3 layers). Drawn for 38 layers, as
# recurrentgemma-9b's are, they agree to 6e-6 (ROADMAP.md, Queue 3).
INIT_DEPTH = {"mamba2-widths-2-layers": 24, "recurrentgemma-reduced": 38,
              "recurrentgemma-heads-256": 38}


def init_params(case, cfg):
    """The reference's init for ``cfg``, or the first layers of its init at
    INIT_DEPTH (the stacked units and the tail the cut model has)."""
    depth = INIT_DEPTH.get(case)
    if depth is None:
        return jax_build_model(cfg).init(KEY)
    deep = jax_build_model(dataclasses.replace(cfg, num_layers=depth)).init(KEY)
    reps = cfg.pattern_repeats[0]
    keep = jax_build_model(cfg).specs()
    return {k: jax.tree.map(lambda a: a[:reps], deep[k]) if k == "blocks"
            else deep[k] for k in keep}


@functools.lru_cache(maxsize=None)
def reference(case: str):
    """The JAX model's outputs for one case, as numpy."""
    arch, make_cfg, b, s = CASES[case]
    steps = STEPS.get(case, T)
    cfg = make_cfg(jax_get_model(arch)[1])
    model = jax_build_model(cfg)
    params = init_params(case, cfg)
    forward, prefill, decode_step = (model.forward, model.prefill,
                                     model.decode_step)
    if case in JIT:
        forward, decode_step = jax.jit(forward), jax.jit(decode_step)
        prefill = jax.jit(prefill, static_argnames="max_len")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + steps)).astype(np.int32)
    fwd, aux = forward(params, jnp.asarray(toks))
    pre, cache = prefill(params, jnp.asarray(toks[:, :s]),
                         max_len=s + steps)
    out = {"cfg": cfg, "params": jax.tree.map(np.asarray, params),
           "tokens": toks, "forward": np.asarray(fwd), "aux": float(aux),
           "prefill": np.asarray(pre),
           "cache": jax.tree.map(np.asarray, cache), "decode": []}
    for t in range(steps):
        dec, cache = decode_step(
            params, cache, jnp.asarray(toks[:, s + t:s + t + 1]),
            jnp.int32(s + t))
        out["decode"].append(np.asarray(dec))
    return out


def port_config(cfg, **changes) -> ModelConfig:
    return dataclasses.replace(ModelConfig(**dataclasses.asdict(cfg)),
                               **changes)


def close(got, want, scale):
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err < TOL, f"max-normalised error {err}"


def leaves(tree, prefix=()):
    """{key path: leaf} of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in leaves(sub, prefix + (k,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_prefill_decode_match_jax(case):
    ref = reference(case)
    _, _, b, s = CASES[case]
    steps = STEPS.get(case, T)
    model = build_model(port_config(ref["cfg"]), device="cpu")
    params = params_from_jax(ref["params"], device="cpu")
    toks = torch.from_numpy(ref["tokens"])
    scale = float(np.abs(ref["forward"]).max()) + 1e-6

    fwd, aux = model.forward(params, toks)
    assert fwd.dtype == torch.float32 and fwd.shape == ref["forward"].shape
    close(fwd, ref["forward"], scale)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), ref["aux"], rtol=1e-5, atol=1e-9)

    pre, cache = model.prefill(params, toks[:, :s], max_len=s + steps)
    close(pre, ref["prefill"], scale)
    want = leaves(ref["cache"])
    got = {path: t.numpy() for path, t in leaves(cache).items()}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        if path[-1] == "pos":
            np.testing.assert_array_equal(got[path], w)
        else:
            close(got[path], w, float(np.abs(w).max()) + 1e-6)

    for t in range(steps):
        dec, cache = model.decode_step(params, cache,
                                       toks[:, s + t:s + t + 1], s + t)
        close(dec, ref["decode"][t], scale)
        close(dec[:, 0], ref["forward"][:, s + t], scale)
        close(dec[:, 0], fwd[:, s + t].numpy(), scale)


# chunk sizes: one chunk; dividing S; not dividing S (halved until it does)
@pytest.mark.parametrize("chunk", [96, 16, 64])
def test_chunked_attention_matches_plain_attention(chunk):
    """The CPU path of the prefill attention against the plain materialised
    softmax, on smollm's 9/3 head layout, (B, S, H, D) in and out."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 96, heads, 64), dtype=np.float32)) for heads in (9, 3, 3))
    cfg = dataclasses.replace(get_config("smollm-135m"), attn_chunk=chunk)
    got = chunked_attention(q, k, v, cfg, causal=True, window=None)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_unknown_attn_impl_is_refused():
    ref = reference("smollm-reduced")
    model = build_model(port_config(ref["cfg"], attn_impl="flash"),
                        device="cpu")
    params = params_from_jax(ref["params"], device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        model.forward(params, torch.from_numpy(ref["tokens"]))


def test_list_archs_agrees_with_reference():
    assert list_archs() == jax_list_archs()


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_config_copy_matches_reference(arch):
    """The port's own copies of each config and of ModelConfig give the same
    fields, values and derived sizes as the reference's."""
    mine, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for name in ("q_per_kv", "d_inner", "ssm_heads", "pattern_repeats"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_build_model_builds_dense_global_and_names_roadmap_otherwise(arch):
    """Every architecture of the zoo builds at its published widths, as the
    reference's build_model builds it: the dense "global" configs, gemma2's
    local + global layout, mamba2's "ssd" stack, recurrentgemma's (rglru,
    rglru, local) pattern, the "moe" configs and paligemma's decoder (a
    patch frontend) as a CausalLM, seamless as an EncDecLM; the parameter
    tree from its specs alone has the reference's key paths and shapes."""
    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    assert model.cfg is cfg
    want = jax_build_model(jax_get_config(arch))
    assert type(model).__name__ == type(want).__name__
    got_specs, want_specs = leaves(model.specs()), leaves(jax.tree.map(
        lambda sp: sp.shape, want.specs(),
        is_leaf=lambda x: hasattr(x, "logical")))
    assert set(got_specs) == set(want_specs)
    for path, spec in got_specs.items():
        assert spec.shape == want_specs[path], path
