"""The port's registry builds every pattern the reference builds.

Hybrids the zoo does not ship, a Mamba-2 mixer or an RG-LRU mixer beside
global attention in one pattern (family "dense"), against the JAX
reference on the CPU: ``forward``, ``loss`` and every gradient leaf of the
reduced configs, from the reference's own parameters carried over by the
bridge. An unknown block kind raises ``ValueError(kind)`` in both
packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402

KEY = jax.random.PRNGKey(5)
# fp32 on both sides, as tests/test_torch_model.py and test_torch_train.py
# hold them: the logits and every gradient leaf max-normalised to 1e-4, the
# loss to a relative 1e-5
TOL = 1e-4
LOSS_RTOL = 1e-5

# (arch the mixer comes from, pattern, extra fields, batch, sequence length,
# the depth the weights are drawn at): the reference's init takes a stacked
# weight's layers axis as its fan-in, so a cut model drawn on its own is
# chaotic (tests/test_torch_model.py); drawn deep and cut, it is not. The
# SSD hybrid takes the attention widths the reduced configs give the other
# archs (mamba2-130m has no attention heads); the RG-LRU one spans the
# window of 64 and keeps recurrentgemma's attention
HYBRIDS = {
    "ssd+global": ("mamba2-130m", ("ssd", "global"),
                   dict(num_heads=4, num_kv_heads=1, head_dim=32, d_ff=256),
                   2, 32, 24),
    "rglru+global": ("recurrentgemma-9b", ("rglru", "global"), {}, 2, 80,
                     38),
}


def hybrid(name):
    """The reference's reduced config of the hybrid, fp32, and the port's
    copy of it."""
    arch, pattern, extra, *_ = HYBRIDS[name]
    cfg = dataclasses.replace(jax_reduced_config(jax_get_model(arch)[1]),
                              pattern=pattern, family="dense",
                              dtype="float32", **extra)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def init_params(cfg, depth):
    """The reference's init of ``cfg`` drawn at ``depth`` layers, cut to
    the reduced model's stacked units."""
    deep = jax_build_model(dataclasses.replace(cfg, num_layers=depth)).init(
        KEY)
    reps = cfg.pattern_repeats[0]
    keep = jax_build_model(cfg).specs()
    return {k: jax.tree.map(lambda a: a[:reps], deep[k]) if k == "blocks"
            else deep[k] for k in keep}


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in leaves(sub, prefix + (k,)).items()}
    return {prefix: tree}


def max_norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def batch_of(cfg, b, s):
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)}
    batch["labels"][rng.random((b, s)) < 0.25] = -1
    return batch


@pytest.mark.parametrize("name", sorted(HYBRIDS))
def test_hybrid_builds_and_matches_jax(name):
    """The port builds the hybrid (its registry once refused "ssd" and
    "rglru" blocks outside their own archs' patterns); ``forward`` (logits
    and aux), ``loss`` and every gradient leaf agree with the reference's
    (its value_and_grad under jax.jit)."""
    *_, b, s, depth = HYBRIDS[name]
    cfg, pcfg = hybrid(name)
    params = init_params(cfg, depth)
    batch = batch_of(cfg, b, s)
    model = jax_build_model(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, jaux = jax.jit(model.forward)(params, jbatch["tokens"])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, jbatch)

    port = build_model(pcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    assert set(leaves(tparams)) == set(leaves(port.specs()))
    with torch.no_grad():
        logits, aux = port.forward(tparams, torch.from_numpy(batch["tokens"]))
    assert logits.shape == jlogits.shape
    assert max_norm_err(logits, jlogits) < TOL
    assert float(aux) == float(jaux) == 0.0
    for p in leaves(tparams).values():
        p.requires_grad_(True)
    loss, _ = port.loss(tparams, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = leaves(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in leaves(tparams).items()}
    assert set(got) == set(want)
    for path, g in got.items():
        assert max_norm_err(g, want[path]) < TOL, path


@pytest.mark.parametrize("name", sorted(HYBRIDS))
def test_hybrid_prefill_and_decode_run(name):
    """The hybrid serves too: prefill fills each block's cache (the SSD or
    RG-LRU state beside the KV cache) and a decode step after it gives the
    logits forward gives at that position."""
    *_, b, s, depth = HYBRIDS[name]
    cfg, pcfg = hybrid(name)
    params = params_from_jax(jax.tree.map(
        np.asarray, init_params(cfg, depth)), device="cpu")
    tokens = torch.from_numpy(batch_of(cfg, b, s + 1)["tokens"]).long()
    port = build_model(pcfg, device="cpu")
    with torch.no_grad():
        full, _ = port.forward(params, tokens)
        _, cache = port.prefill(params, tokens[:, :s], s + 8)
        step, _ = port.decode_step(params, cache, tokens[:, s:], s)
    assert max_norm_err(step[:, 0], full[:, s]) < TOL


def test_unknown_block_kind_raises_value_error_in_both_packages():
    cfg, pcfg = hybrid("ssd+global")
    bad = dataclasses.replace(cfg, pattern=("ssd", "conv"))
    with pytest.raises(ValueError, match="conv"):
        jax_build_model(bad).specs()
    with pytest.raises(ValueError, match="conv"):
        build_model(dataclasses.replace(pcfg, pattern=("ssd", "conv")),
                    device="cpu").specs()
