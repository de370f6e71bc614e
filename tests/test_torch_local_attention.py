"""The port's "local" (sliding-window) attention against the JAX reference:
the chunked path with a window, the prefill's ring-buffer cache (window
slots, position p in slot p % window, unfilled slots at -1) for prompts
shorter than, as long as and longer than the window, and decode steps that
run across the ring's wrap, on the same numpy inputs and bridged weights.

On the CPU the prefill takes the chunked path; on the card the flash kernel
takes the window (``chip_smoke.py`` holds it against the plain version).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jax_attn  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.layers import init_param as jax_init_param  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

WINDOW = 16
# max-normalised, as tests/test_decode_consistency.py holds the reference
TOL = 1e-4


def setup(seed=0):
    """(jax cfg, port cfg, jax params, port params): recurrentgemma's
    reduced attention (4 query heads on 1 KV head, head_dim 32) with a
    window of 16 and chunks of 8."""
    _, full = jax_get_model("recurrentgemma-9b")
    cfg = dataclasses.replace(jax_reduced_config(full), dtype="float32",
                              sliding_window=WINDOW, attn_chunk=8)
    specs = jax_attn.attention_specs(cfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(specs))
    jparams = {name: jax_init_param(k, spec, jnp.float32)
               for k, (name, spec) in zip(keys, specs.items())}
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, ModelConfig(**dataclasses.asdict(cfg)), jparams, params


def max_norm_err(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("s,window", [(64, 16), (64, 24), (40, 64)])
def test_chunked_attention_with_window_matches_jax_and_plain(s, window):
    """A window that is a multiple of the chunk, one that is not, and one
    longer than the sequence; (B, S, H, D) in and out."""
    cfg, port_cfg, _, _ = setup()
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, s, heads, 32), dtype=np.float32)
               for heads in (4, 1, 1))
    want = np.asarray(jax_attn.chunked_attention(
        *(jnp.asarray(t) for t in (q, k, v)), cfg, causal=True,
        window=window))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = attn.chunked_attention(tq, tk, tv, port_cfg, causal=True,
                                 window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    plain = attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                          tv.transpose(1, 2), causal=True,
                          window=window).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("s", [10, WINDOW, 37])
def test_local_prefill_keeps_the_ring_as_jax(s):
    """s < window: slots s.. hold position -1; s == window: full, in
    order; s > window: the last window positions, each in slot p % window.
    The output, k, v and pos all agree with the reference (pos exactly)."""
    cfg, port_cfg, jparams, params = setup()
    x = np.random.default_rng(2).standard_normal(
        (2, s, cfg.d_model), dtype=np.float32)
    jy, jcache = jax_attn.attention_prefill(jparams, jnp.asarray(x), cfg,
                                            kind="local", cache_len=64)
    y, cache = attn.attention_prefill(params, torch.from_numpy(x), port_cfg,
                                      kind="local", cache_len=64)
    assert max_norm_err(y, jy) < TOL
    assert cache["k"].shape == jcache["k"].shape == (2, WINDOW, 1, 32)
    np.testing.assert_array_equal(cache["pos"].numpy(), jcache["pos"])
    want_pos = np.full(WINDOW, -1)
    kept = np.arange(max(0, s - WINDOW), s)
    want_pos[kept % WINDOW] = kept
    np.testing.assert_array_equal(cache["pos"].numpy(), want_pos)
    for name in ("k", "v"):
        assert max_norm_err(cache[name], jcache[name]) < TOL


def test_local_decode_steps_across_the_wrap_as_jax():
    """From a prompt of 12, 30 decode steps write slots 12..15, then wrap
    to slot 0 at position 16 and on: every step's output and cache agree
    with the reference's, the ring holds the last window positions, and
    the window mask keeps the oldest slot out once it falls behind."""
    cfg, port_cfg, jparams, params = setup()
    s, steps = 12, 30
    x = np.random.default_rng(3).standard_normal(
        (2, s + steps, cfg.d_model), dtype=np.float32)
    _, jcache = jax_attn.attention_prefill(jparams, jnp.asarray(x[:, :s]),
                                           cfg, kind="local", cache_len=64)
    _, cache = attn.attention_prefill(params, torch.from_numpy(x[:, :s]),
                                      port_cfg, kind="local", cache_len=64)
    for t in range(s, s + steps):
        jy, jcache = jax_attn.decode_attention(
            jparams, jnp.asarray(x[:, t:t + 1]), cfg, jcache, jnp.int32(t),
            window=WINDOW)
        y, out = attn.decode_attention(params, torch.from_numpy(
            x[:, t:t + 1]), port_cfg, cache, t, window=WINDOW)
        assert out is cache
        assert max_norm_err(y, jy) < TOL, t
        np.testing.assert_array_equal(cache["pos"].numpy(), jcache["pos"])
        for name in ("k", "v"):
            assert max_norm_err(cache[name], jcache[name]) < TOL
    held = np.arange(s + steps - WINDOW, s + steps)
    assert sorted(cache["pos"].tolist()) == held.tolist()
    # the last step attends exactly the window: the plain softmax over the
    # full sequence's keys within it gives the same output
    full_y, _ = attn.attention_prefill(params, torch.from_numpy(x), port_cfg,
                                       kind="local", cache_len=64)
    assert max_norm_err(y[:, 0], full_y[:, -1]) < TOL


def test_cross_attention_is_not_ported():
    """The "cross" kind is ported (the name stays from when it raised): on
    these weights (4 query heads on 1 KV head, chunks of 8, a window the
    cross kind ignores), keys from another sequence without RoPE and no
    causal mask, against the reference; the first Sq keys when the other
    sequence is longer, as the reference cuts them."""
    cfg, port_cfg, jparams, params = setup()
    rng = np.random.default_rng(7)
    for sq, sk in ((8, 5), (24, 40)):
        x = rng.standard_normal((2, sq, cfg.d_model), dtype=np.float32)
        x_kv = rng.standard_normal((2, sk, cfg.d_model), dtype=np.float32)
        want = jax_attn.attention_apply(jparams, jnp.asarray(x), cfg,
                                        kind="cross", x_kv=jnp.asarray(x_kv))
        got = attn.attention_apply(params, torch.from_numpy(x), port_cfg,
                                   kind="cross", x_kv=torch.from_numpy(x_kv))
        assert max_norm_err(got, want) < TOL, (sq, sk)
