"""Tensor parallelism inside a slice (``model_ways`` > 1) in the port against
the JAX reference, on the CPU.

The port drives a slice's model coordinates in lockstep from one process,
on virtual CPU devices (``slice_devices(n, "cpu")``), and writes the
collectives that the reference's GSPMD derives from ``constrain``. Held
here against the reference: ``constrain`` without a context, the sharding
rules and the ZeRO-1 layout on ``(data, model)`` meshes, the loss and
every gradient against ``jax.value_and_grad`` at ``model_ways`` 2 and 4
(heads split with the KV heads whole or split, local and global layers
with softcaps, a tied and an untied table, a vocab that does not divide;
the SSD mixer by heads, and whole where its rows do not split on head
boundaries; the RG-LRU mixer by width; the mixture of experts by experts
with the shared experts and a dense first layer wider than d_ff; the
encoder-decoder), the remats and ``ce_chunk``, and, in one subprocess with
8 forced host devices, the reference's elastic run at ``model_ways`` 2
under both rule tables (and mamba2's under ``TP_DP_RULES``) and its
compressed all-reduce over a ``(2, 2)`` mesh. Then the port alone: prefill
and decode against ``model_ways`` 1, the SSD mixer's gated norm,
resizes, checkpoints across slice counts and the fault path, and the
launcher.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.core.sharding import FSDP_RULES as JAX_FSDP  # noqa: E402
from repro.core.sharding import TP_DP_RULES as JAX_RULES  # noqa: E402
from repro.core.sharding import constrain as jax_constrain  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMData as JaxData  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.optim import init_state as jax_init_state  # noqa: E402
from repro.optim.adamw import zero1_logical as jax_zero1  # noqa: E402
from repro_torch.bridge import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.core import (Action, Decision, FSDP_RULES,  # noqa: E402
                              TP_DP_RULES, gather, make_mesh, slice_devices)
from repro_torch.core import tensor_parallel as tp  # noqa: E402
from repro_torch.core.sharding import (activation_rules,  # noqa: E402
                                       constrain)
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import (AdamWConfig, compressed_psum_grads,  # noqa: E402
                               make_compressed_allreduce, zero1_logical)
from repro_torch.runtime import ElasticTrainer, TrainerConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = slice_devices(8, "cpu")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
RULES = {"TP_DP_RULES": TP_DP_RULES, "FSDP_RULES": FSDP_RULES}

# reduced configs: (arch, changes)
CASES = {
    # 4 query heads / 1 KV head: heads split, the KV head whole on each
    "smollm": ("smollm-135m", {}),
    # 4 / 2: both split at model_ways 2; at 4 each head takes its KV head
    "qwen3-kv2": ("qwen3-4b", {"num_kv_heads": 2}),
    # local and global layers, softcaps, tied table, embed_scale; S 96
    # passes the window of 64
    "gemma2": ("gemma2-27b", {}),
    # a vocab no model axis divides: the table whole on every coordinate
    "odd-vocab": ("smollm-135m", {"vocab_size": 2049}),
    # an untied unembedding, split by vocab
    "untied": ("smollm-135m", {"tie_embeddings": False}),
    # the SSD mixer: 16 heads of 16, in_proj's 560 columns split off the
    # boundaries of [z, x, B, C, dt], the conv's 288 channels off the heads'
    "mamba2": ("mamba2-130m", {}),
    # 15 heads: out_proj's 240 rows split, but not on head boundaries, and
    # in_proj's 527 columns whole: the mixer runs whole
    "mamba2-odd-heads": ("mamba2-130m", {"d_model": 120}),
    # rglru, rglru, local (4 query heads, 1 KV head, window 64); W 128
    "recurrentgemma": ("recurrentgemma-9b", {}),
    # 8 experts, top 2, no shared experts; 4 query heads, 1 KV head
    "phi35-moe": ("phi3.5-moe-42b-a6.6b", {}),
    # a dense first layer 4 times d_ff wide (as deepseek's 10944 against
    # 1408), then 8 experts, top 2, and 2 shared experts
    "deepseek-moe": ("deepseek-moe-16b", {"first_dense_ff": 1024}),
    # encoder and decoder, non-causal and cross attention, 4 heads, 16
    # frames (lm_batch)
    "seamless": ("seamless-m4t-medium", {}),
}
# one case of each family with SSD, RG-LRU, mixture-of-experts or
# encoder-decoder blocks
KIND_CASES = ("mamba2", "recurrentgemma", "phi35-moe", "deepseek-moe",
              "seamless")
FRAMES = 16


@pytest.fixture(autouse=True)
def one_thread():
    """The tier-1 run shares the machine's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def fp32_config(case, **changes):
    arch, more = CASES[case]
    cfg = dataclasses.replace(jax_reduced_config(jax_get_model(arch)[1]),
                              dtype="float32", **more, **changes)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def init_params(pcfg, seed=0):
    """Parameters drawn with numpy, as the reference's init draws them but
    at each layer's own fan-in (a stacked weight's second axis, where the
    reference takes the stacked layers axis: cut models drawn so are
    chaotic; tests/test_torch_train.py); norms at zero, as both inits."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        stacked = spec.logical[0] == "layers" and len(spec.shape) > 2
        fan_in = spec.shape[1] if stacked else spec.shape[0]
        return (rng.standard_normal(spec.shape) * spec.scale
                / np.sqrt(fan_in)).astype(np.float32)

    return tree_map(draw, build_model(pcfg, device="cpu").specs())


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(case, s=32, ce_chunk=0):
    """The reduced config, its parameters (numpy), a batch of ``s``
    positions and ``jax.jit(jax.value_and_grad)`` of the reference's
    loss there: (cfg, pcfg, params, batch, loss, ce, grads)."""
    cfg, pcfg = fp32_config(case, ce_chunk=ce_chunk)
    params = init_params(pcfg)
    batch = lm_batch(cfg, s=s)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        jax_build_model(cfg).loss, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    return (cfg, pcfg, params, batch, float(loss), float(parts["ce"]),
            leaves(jax.tree.map(np.asarray, grads)))


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in leaves(sub, prefix + (k,)).items()}
    return {prefix: tree}


def max_norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def lm_batch(cfg, b=2, s=32, seed=0):
    """Tokens and labels (a quarter masked); an encoder-decoder's batch
    also FRAMES frames of the stub frontend (fewer than the tokens, within
    one chunk: tests/test_torch_encdec.py)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.25] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.enc_layers:
        batch["frontend"] = rng.standard_normal(
            (b, FRAMES, cfg.d_model)).astype(np.float32)
    return batch


def attention_calls(cfg):
    """The attention calls of one forward pass, per model coordinate: one
    a layer of an attention kind; an encoder-decoder's encoder layers and
    its decoder's self and cross attention."""
    if cfg.enc_layers:
        return cfg.enc_layers + 2 * cfg.num_layers
    model = build_model(ModelConfig(**dataclasses.asdict(cfg)),
                        device="cpu")
    return sum(kind in attn.KINDS for _, _, kind in model._layers())


def model_mesh(ways, data=1):
    return make_mesh(data, ways, devices=slice_devices(data * ways, "cpu"))


def coordinate_views(model, params, mesh, rules=TP_DP_RULES):
    """One tree per model coordinate of the first slice: views of
    ``params``' leaves on the coordinate's model block, so autograd adds
    the coordinates' gradients into the whole leaves."""
    sh = tree_map(lambda lg, s: rules.sharding_for(lg, s.shape, mesh),
                  model.logical(), model.specs())
    return [tree_map(lambda x, s, c=c: x[tp.model_spec(s).index(x.shape, c)],
                     params, sh)
            for c in tp.slices_of(mesh)[0]]


def port_loss_and_grads(pcfg, np_params, batch, ways, rules=TP_DP_RULES):
    """The port's loss and whole gradients at ``ways`` model coordinates
    (each coordinate's blocks and the activation rules by ``rules``), and
    the query / KV head counts each attention call saw."""
    model = build_model(pcfg, device="cpu")
    params = params_from_jax(np_params, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    mesh = model_mesh(ways)
    seen, attend = [], attn._attend

    def spy(q, k, v, cfg, window, causal=True):
        seen.append((q.shape[2], k.shape[2]))
        return attend(q, k, v, cfg, window, causal)

    attn._attend = spy
    try:
        with activation_rules(mesh, rules):
            loss, parts = model.loss(
                coordinate_views(model, params, mesh, rules),
                {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        attn._attend = attend
    loss.backward()
    return loss, parts, {k: p.grad for k, p in leaves(params).items()}, seen


# -- constrain and the rules ------------------------------------------------------


def test_constrain_without_a_context_returns_its_input():
    """As the reference's: no context, no change; and a context of one way
    inside a slice changes nothing either."""
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert constrain(x, ("batch", "seq", "embed")) is x
    jx = jnp.arange(6.0).reshape(1, 2, 3)
    assert jax_constrain(jx, ("batch", "seq", "embed")) is jx
    with activation_rules(model_mesh(1, data=2), TP_DP_RULES):
        assert constrain(x, ("batch", "seq", "embed")) is x
    parts = [x, 2 * x]
    with activation_rules(model_mesh(2), TP_DP_RULES):
        whole = constrain(tp.Partial(parts), ("batch", "seq", "embed"))
        assert constrain(parts, ("batch", "seq", "embed")) is parts
        with pytest.raises(TypeError, match="per model coordinate"):
            constrain(x, ("batch", "seq", "embed"))
    assert all(torch.equal(w, 3 * x) for w in whole)
    assert whole[0] is not whole[1]


@pytest.mark.parametrize("data,ways", [(1, 2), (2, 2), (1, 4), (4, 2)])
def test_spec_for_and_zero1_match_reference_on_model_meshes(data, ways):
    """Every leaf of every family's reduced tree (the SSD and RG-LRU
    mixers, the experts and the router, the encoder-decoder) under both
    rule tables, beside
    test_torch_elastic.py::test_spec_for_and_zero1_match_reference's
    meshes of one model way."""
    mesh = make_mesh(data, ways, devices=["cpu"] * 16)
    jmesh = AbstractMesh((data, ways), ("data", "model"))
    for arch in ("smollm-135m", "qwen3-4b", "granite-3-2b", "gemma2-27b",
                 "mamba2-130m", "recurrentgemma-9b", "phi3.5-moe-42b-a6.6b",
                 "deepseek-moe-16b", "seamless-m4t-medium"):
        cfg = jax_reduced_config(jax_get_model(arch)[1])
        specs = build_model(ModelConfig(**dataclasses.asdict(cfg)),
                            device="cpu").specs()
        for s in tree_leaves(specs):
            for rules, jrules in ((TP_DP_RULES, JAX_RULES),
                                  (FSDP_RULES, JAX_FSDP)):
                assert tuple(rules.spec_for(s.logical, s.shape, mesh)) == \
                    tuple(jrules.spec_for(s.logical, s.shape, jmesh)), \
                    (arch, s)
                assert zero1_logical(s.logical, s.shape, mesh, rules) == \
                    jax_zero1(s.logical, s.shape, jmesh, jrules), (arch, s)


# -- the loss and its gradients against JAX ----------------------------------------


@pytest.mark.parametrize("ways", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case, ways):
    """``loss`` and every gradient leaf at ``ways`` model coordinates
    against ``jax.value_and_grad`` of the reference's loss; each attention
    call runs on its coordinate's heads (H / ways query heads, their KV
    heads), once per attention layer and coordinate."""
    cfg, pcfg, params, batch, jloss, jce, want = jax_loss_and_grads(
        case, s=96 if case in ("gemma2", "recurrentgemma") else 32)
    check_against_jax(cfg, pcfg, params, batch, jloss, jce, want, ways)


def check_against_jax(cfg, pcfg, params, batch, jloss, jce, want, ways,
                      rules=TP_DP_RULES):
    loss, parts, grads, seen = port_loss_and_grads(pcfg, params, batch, ways,
                                                   rules)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(parts["ce"].item(), jce, rtol=LOSS_RTOL)
    assert set(grads) == set(want)
    for path, g in grads.items():
        err = max_norm_err(g.numpy(), want[path])
        assert err < GRAD_TOL, (path, err)
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if h:
        local_kv = kv // ways if kv % ways == 0 else max(
            h // ways // (h // kv), 1)
        assert seen == [(h // ways, local_kv)] * (attention_calls(cfg) * ways)
    else:
        assert seen == []


@pytest.mark.parametrize("case", KIND_CASES)
def test_loss_and_grads_match_jax_under_fsdp_rules(case):
    """The families of the SSD, RG-LRU, mixture-of-experts and
    encoder-decoder blocks at 2 model coordinates under FSDP_RULES (the
    model blocks the same, the embed axis whole inside a slice) against
    ``jax.value_and_grad``, as under TP_DP_RULES."""
    args = jax_loss_and_grads(case, s=96 if case == "recurrentgemma" else 32)
    check_against_jax(*args, 2, rules=FSDP_RULES)


def test_dense_first_layer_sums_its_partial_sums():
    """deepseek's first layer is a gated MLP wider than d_ff (10944
    against 1408; here 1024 against 256): at 2 model coordinates each holds
    512 of its columns, no fewer than d_ff, and its outputs are partial
    sums all the same. A split is read from the leaf's shape against its
    spec's, so the loss and the first layer's gradients match JAX."""
    cfg, pcfg, params, batch, jloss, _, want = jax_loss_and_grads(
        "deepseek-moe")
    model = build_model(pcfg, device="cpu")
    mesh = model_mesh(2)
    views = coordinate_views(model, params_from_jax(params, "cpu"), mesh)
    assert views[0]["head0"]["ffn"]["w_down"].shape[0] == 512 >= cfg.d_ff
    assert tp.is_split(views[0]["head0"]["ffn"]["w_down"],
                       model.specs()["head0"]["ffn"]["w_down"].shape)
    loss, _, grads, _ = port_loss_and_grads(pcfg, params, batch, 2)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    for path, g in grads.items():
        if path[0] == "head0":
            assert max_norm_err(g.numpy(), want[path]) < GRAD_TOL, path


def test_ssd_gated_norm_takes_its_mean_over_the_whole_width():
    """The SSD mixer's gated RMSNorm at 2 and 4 model coordinates, each
    coordinate holding its heads' channels of y and z: the sums of squares
    are added over the coordinates before any normalises, so the
    coordinates' outputs put together equal the whole norm's; normalising
    each coordinate's channels alone would be off by far more."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import rms_norm
    _, pcfg = fp32_config("mamba2")
    rng = np.random.default_rng(3)
    di = pcfg.d_inner
    y, z = (torch.from_numpy(rng.standard_normal((2, 8, di)).astype(
        np.float32)) for _ in range(2))
    # channels of unequal scale, as heads are
    y = y * torch.linspace(0.2, 3.0, di)
    norm = torch.from_numpy(rng.standard_normal(di).astype(np.float32))
    want = rms_norm(y * torch.nn.functional.silu(z), norm, pcfg.norm_eps)
    for ways in (2, 4):
        w = di // ways
        cut = [slice(m * w, (m + 1) * w) for m in range(ways)]
        parts = [{"norm": norm[c]} for c in cut]
        with activation_rules(model_mesh(ways), TP_DP_RULES):
            got = ssm._tp_gated_norm(parts, [y[..., c] for c in cut],
                                     [z[..., c] for c in cut], pcfg)
        assert max_norm_err(torch.cat(got, -1), want) < 1e-6
        alone = torch.cat([rms_norm(y[..., c] * torch.nn.functional.silu(
            z[..., c]), norm[c], pcfg.norm_eps) for c in cut], -1)
        assert max_norm_err(alone, want) > 0.1


@pytest.mark.parametrize("ce_chunk", [0, 12])
def test_remat_and_ce_chunk_at_two_ways(ce_chunk):
    """The reduced smollm at 2 model coordinates, the logits whole or by 12
    positions (a ragged last chunk): remat "none" against JAX, and "dots"
    and "nothing_saveable" bit-equal to "none"."""
    _, pcfg, params, batch, jloss, _, want = jax_loss_and_grads(
        "smollm", ce_chunk=ce_chunk)
    runs = {remat: port_loss_and_grads(
        dataclasses.replace(pcfg, remat=remat), params, batch, 2)
        for remat in ("none", "dots", "nothing_saveable")}
    loss, _, grads, _ = runs["none"]
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    for path, g in grads.items():
        assert max_norm_err(g.numpy(), want[path]) < GRAD_TOL, path
    for remat in ("dots", "nothing_saveable"):
        other_loss, _, other, _ = runs[remat]
        assert torch.equal(other_loss, loss), remat
        for path, g in grads.items():
            assert torch.equal(other[path], g), (remat, path)


def test_prefill_and_decode_match_one_way():
    """prefill and decode_step of the reduced gemma2 (local and global
    layers, 2 KV heads) at 2 and 4 model coordinates against 1: the logits,
    and the cache whole (the KV heads put together where split)."""
    cfg, pcfg = fp32_config("gemma2")
    model = build_model(pcfg, device="cpu")
    params = params_from_jax(init_params(pcfg), "cpu")
    toks = torch.from_numpy(lm_batch(cfg, s=72)["tokens"]).long()
    want_logits, want_cache = model.prefill(params, toks[:, :70], 80)
    want_cache = tree_map(torch.clone, want_cache)
    step_cache = tree_map(torch.clone, want_cache)
    want_steps = [model.decode_step(params, step_cache, toks[:, i:i + 1],
                                    i)[0] for i in (70, 71)]
    for ways in (2, 4):
        mesh = model_mesh(ways)
        parts = coordinate_views(model, params, mesh)
        with activation_rules(mesh, TP_DP_RULES):
            logits, cache = model.prefill(parts, toks[:, :70], 80)
            assert max_norm_err(logits, want_logits) < 1e-5
            for got, want in zip(tree_leaves(cache),
                                 tree_leaves(want_cache)):
                assert got.shape == want.shape
                assert max_norm_err(got.float(), want.float()) < 1e-5
            for i, want in zip((70, 71), want_steps):
                got, _ = model.decode_step(parts, cache, toks[:, i:i + 1], i)
                assert max_norm_err(got, want) < 1e-5, (ways, i)


@pytest.mark.parametrize("case", KIND_CASES)
def test_prefill_and_decode_of_each_kind_match_one_way(case):
    """prefill and decode_step at 2 and 4 model coordinates against 1 for
    the SSD, RG-LRU (past its local layer's window), mixture-of-experts and
    encoder-decoder families: the logits to 1e-5 max-normalised, and the
    cache whole (the SSD state, h, the KV and cross KV heads put together
    from their blocks), each leaf to 1e-5."""
    cfg, pcfg = fp32_config(case)
    model = build_model(pcfg, device="cpu")
    params = params_from_jax(init_params(pcfg), "cpu")
    # the encoder-decoder's prompt within one chunk of queries (its cross
    # attention's key cut: tests/test_torch_encdec.py)
    n = 30 if cfg.enc_layers else 70
    batch = lm_batch(cfg, s=n + 2)
    toks = torch.from_numpy(batch["tokens"]).long()
    front = (torch.from_numpy(batch["frontend"]),) if cfg.enc_layers else ()
    want_logits, want_cache = model.prefill(params, *front, toks[:, :n],
                                            n + 10)
    want_cache = tree_map(torch.clone, want_cache)
    step_cache = tree_map(torch.clone, want_cache)
    want_steps = [model.decode_step(params, step_cache, toks[:, i:i + 1],
                                    i)[0] for i in (n, n + 1)]
    for ways in (2, 4):
        mesh = model_mesh(ways)
        parts = coordinate_views(model, params, mesh)
        with activation_rules(mesh, TP_DP_RULES):
            logits, cache = model.prefill(parts, *front, toks[:, :n], n + 10)
            assert max_norm_err(logits, want_logits) < 1e-5, ways
            for got, want in zip(tree_leaves(cache),
                                 tree_leaves(want_cache)):
                assert got.shape == want.shape
                assert max_norm_err(got.float(), want.float()) < 1e-5, ways
            for i, want in zip((n, n + 1), want_steps):
                got, _ = model.decode_step(parts, cache, toks[:, i:i + 1], i)
                assert max_norm_err(got, want) < 1e-5, (ways, i)
            for got, want in zip(tree_leaves(cache),
                                 tree_leaves(step_cache)):
                assert max_norm_err(got.float(), want.float()) < 1e-5, ways


@pytest.mark.parametrize("case", ["mamba2", "recurrentgemma", "phi35-moe",
                                  "deepseek-moe"])
def test_blocks_run_whole_where_three_ways_split_nothing(case):
    """At 3 model coordinates the rules split none of these reduced
    configs' heads, widths, experts or vocab (16 SSD heads, W 128, 8
    experts, 2048 rows): the SSD and RG-LRU mixers put their leaves
    together and run whole (``tensor_parallel.run_whole``), the experts and
    router run whole on every coordinate, and forward, prefill and decode
    give one way's logits."""
    cfg, pcfg = fp32_config(case)
    model = build_model(pcfg, device="cpu")
    params = params_from_jax(init_params(pcfg), "cpu")
    toks = torch.from_numpy(lm_batch(cfg, s=34)["tokens"]).long()
    want, _ = model.forward(params, toks[:, :32])
    want_pre, cache = model.prefill(params, toks[:, :32], 40)
    want_step, _ = model.decode_step(params, cache, toks[:, 32:33], 32)
    mesh = model_mesh(3)
    parts = coordinate_views(model, params, mesh)
    with activation_rules(mesh, TP_DP_RULES):
        got, _ = model.forward(parts, toks[:, :32])
        got_pre, cache = model.prefill(parts, toks[:, :32], 40)
        got_step, _ = model.decode_step(parts, cache, toks[:, 32:33], 32)
    for g, w in ((got, want), (got_pre, want_pre), (got_step, want_step)):
        assert max_norm_err(g, w) < 1e-5, case


def test_forward_gathers_the_vocab_and_refuses_other_kinds():
    """forward's logits put together from the vocab's blocks; under the
    context the block kinds that once raised (the SSD and RG-LRU mixers,
    the mixture of experts, the encoder-decoder) now run at 2 model
    coordinates, their logits those of one."""
    for case in ("smollm", "mamba2", "recurrentgemma", "phi35-moe",
                 "seamless"):
        cfg, pcfg = fp32_config(case)
        model = build_model(pcfg, device="cpu")
        params = params_from_jax(init_params(pcfg), "cpu")
        batch = lm_batch(cfg)
        args = ((torch.from_numpy(batch["frontend"]),) if cfg.enc_layers
                else ()) + (torch.from_numpy(batch["tokens"]).long(),)
        want, _ = model.forward(params, *args)
        mesh = model_mesh(2)
        with activation_rules(mesh, TP_DP_RULES):
            got, _ = model.forward(coordinate_views(model, params, mesh),
                                   *args)
        assert got.shape == want.shape
        assert max_norm_err(got, want) < 1e-5, case


# -- the reference's elastic run and compressed all-reduce, in one subprocess ------

REFERENCE_RUN = """
import dataclasses, json
import jax, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.core import Action, Decision, make_mesh, sharding
from repro.data import DataConfig
from repro.models import build_model, get_model, reduced_config
from repro.optim import AdamWConfig, init_state
from repro.optim.compression import compressed_psum_grads
from repro.runtime import ElasticTrainer, TrainerConfig


class ScriptedRMS:
    def __init__(self, script):
        self.script, self.calls = dict(script), 0

    def request_reconfig(self, job_id, *, current, minimum, maximum,
                         factor, preferred):
        self.calls += 1
        return self.script.get(self.calls,
                               Decision(Action.NO_ACTION, current))

    def confirm_resize(self, job_id, decision, timeout_s):
        return True, 0.0


def load(path):
    params = {}
    for name, value in np.load(path).items():
        *keys, last = name.split("/")
        node = params
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = value
    return params


runs, arrays = {}, {}
for key, arch, path, rules in (
        ("TP_DP_RULES", "smollm-135m", PARAMS, "TP_DP_RULES"),
        ("FSDP_RULES", "smollm-135m", PARAMS, "FSDP_RULES"),
        ("mamba2", "mamba2-130m", PARAMS_MAMBA2, "TP_DP_RULES")):
    cfg = dataclasses.replace(reduced_config(get_model(arch)[1]),
                              dtype="float32")
    params = load(path)
    tr = ElasticTrainer(build_model(cfg), AdamWConfig(**OPT),
                        DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=8),
                        TrainerConfig(**TCFG, rules=getattr(sharding, rules)),
                        rms=ScriptedRMS({1: Decision(Action.EXPAND, 4)}))
    tr.slices = 2
    tr.mesh = make_mesh(2, 2)
    tr.dmr.current_slices = 2
    state = tr.init_state(seed=0)
    state["params"] = params
    state["opt"] = init_state(params)
    state = jax.device_put(state, tr._state_shardings(tr.mesh))
    out = tr.train(state=state)
    coord = {d.id: c for c, d in np.ndenumerate(tr.mesh.devices)}
    index = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(out["params"]):
        name = "/".join(k.key for k in path)
        for sh in leaf.addressable_shards:
            d, m = coord[sh.device.id]
            arrays[f"{key}|{name}|{d}|{m}"] = np.asarray(sh.data)
            index[f"{name}|{d}|{m}"] = [list(s.indices(n))[:2] for s, n in
                                        zip(sh.index, leaf.shape)]
    runs[key] = {"metrics": tr.metrics,
                 "resizes": [(r["action"], r["from"], r["to"])
                             for r in tr.resize_log],
                 "rng": np.asarray(out["rng"]).tolist(),
                 "mesh": list(tr.mesh.devices.shape), "index": index}

# the compressed all-reduce on (data 2, model 2): leaf "a" split over the
# model axis on its last dimension, leaf "b" whole on both model coordinates
mesh = make_mesh(2, 2)
grads = np.load(IN)


def body(a, b, ea, eb):
    mean, errs = compressed_psum_grads(
        {"a": a[0], "b": b[0]}, mesh, axes=("data",),
        errors={"a": ea[0], "b": eb[0]})
    return (mean["a"][None], mean["b"][None], errs["a"][None],
            errs["b"][None])


sa, sb = P("data", None, "model"), P("data")
fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(sa, sb, sa, sb),
                       out_specs=(sa, sb, sa, sb), check_rep=False))
ea = np.zeros(grads["a"].shape[1:], np.float32)
eb = np.zeros(grads["b"].shape[1:], np.float32)
comp = {k: [] for k in ("ma", "mb", "ea", "eb")}
for t in range(grads["a"].shape[0]):
    ma, mb, ea, eb = fn(grads["a"][t], grads["b"][t], ea, eb)
    for k, v in zip(comp, (ma, mb, ea, eb)):
        comp[k].append(np.asarray(v))
arrays.update({"comp|" + k: np.stack(v) for k, v in comp.items()})
np.savez(OUT + "/arrays.npz", **arrays)
with open(OUT + "/runs.json", "w") as f:
    json.dump(runs, f)
"""
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
TCFG = dict(steps=5, model_ways=2, max_slices=4, check_period=2,
            log_period=1)
STEPS = 12


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """One subprocess with 8 forced host devices, started before the
    module's first test so that it runs beside them: the reference's
    elastic run at model_ways 2 (2 slices, an EXPAND to 4 at the first
    reconfiguration point, 5 fp32 steps) of smollm under both rule tables
    and of mamba2 under TP_DP_RULES, and its compressed all-reduce on a
    (2, 2) mesh over STEPS error-feedback steps."""
    out = tmp_path_factory.mktemp("tp_reference")
    rng = np.random.default_rng(11)
    grads = {"a": rng.standard_normal((STEPS, 2, 3, 200)).astype(np.float32),
             "b": (rng.standard_normal((STEPS, 2, 512)) * 1e-3).astype(
                 np.float32)}
    grads["b"][:, 1, :256] *= 50.0       # one slice sets block 0's scale
    np.savez(out / "in.npz", **grads)
    for case, name in (("smollm", "params.npz"),
                       ("mamba2", "params_mamba2.npz")):
        _, pcfg = fp32_config(case)
        np.savez(out / name, **{"/".join(k): v for k, v in
                                leaves(init_params(pcfg)).items()})
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    code = (f"OPT = {OPT!r}\nTCFG = {TCFG!r}\nIN = {str(out / 'in.npz')!r}\n"
            f"PARAMS = {str(out / 'params.npz')!r}\n"
            f"PARAMS_MAMBA2 = {str(out / 'params_mamba2.npz')!r}\n"
            f"OUT = {str(out)!r}\n"
            + textwrap.dedent(REFERENCE_RUN))
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
    try:
        yield out, proc, grads
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def reference(reference_run):
    """The reference run's results: (runs, arrays, the all-reduce's
    inputs)."""
    out, proc, grads = reference_run
    proc.wait(timeout=600)
    assert proc.returncode == 0, (out / "stderr.txt").read_text()[-4000:]
    return (json.loads((out / "runs.json").read_text()),
            dict(np.load(out / "arrays.npz")), grads)


class ScriptedRMS:
    def __init__(self, script):
        self.script, self.calls = dict(script), 0

    def request_reconfig(self, job_id, *, current, minimum, maximum,
                         factor, preferred):
        self.calls += 1
        return self.script.get(self.calls,
                               Decision(Action.NO_ACTION, current))

    def confirm_resize(self, job_id, decision, timeout_s):
        return True, 0.0


class FedBatches:
    """The reference's data stream as torch tensors."""

    def __init__(self, data):
        self.data = data

    def batch(self, step):
        return {k: torch.from_numpy(np.array(v))
                for k, v in self.data.batch(step).items()}


@pytest.mark.parametrize("rules", ["TP_DP_RULES", "FSDP_RULES"])
def test_elastic_run_at_two_ways_reproduces_reference(reference, rules):
    """The reference's elastic run at model_ways 2 and the port's on
    ``CPU8``, from the same bridged state and the reference's batches:
    the same losses, lr and gradient norms to 1e-4, the same slice counts,
    the same rng key, and on every mesh coordinate of the (4, 2) mesh the
    same block of every parameter as the reference's device there: the
    same box, and the same update from the start to 1e-3 in norm (the runs
    sum in other orders, and AdamW's early steps move an element by about
    lr whatever the size of its gradient, so an element whose gradient is
    rounding noise in both runs may move either way), each block equal to
    the port's whole leaf there."""
    check_elastic_run(reference, rules, "smollm", rules)


def test_mamba2_elastic_run_at_two_ways_reproduces_reference(reference):
    """The same for the reduced mamba2-130m under TP_DP_RULES: its SSD
    mixers split by heads, with the gated norm's sums of squares and the
    projection's blocks put together over the model coordinates."""
    check_elastic_run(reference, "mamba2", "mamba2", "TP_DP_RULES")


def check_elastic_run(reference, key, case, rules):
    runs, arrays, _ = reference
    ref = runs[key]
    cfg, pcfg = fp32_config(case)
    params = init_params(pcfg)
    start = {"params": params, "opt": jax_init_state(params),
             "rng": jax.random.PRNGKey(1), "step": jnp.int32(0)}
    data = JaxData(JaxDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=8))
    port = ElasticTrainer(build_model(pcfg, device="cpu"), AdamWConfig(**OPT),
                          FedBatches(data),
                          TrainerConfig(**TCFG, rules=RULES[rules]),
                          rms=ScriptedRMS({1: Decision(Action.EXPAND, 4)}),
                          devices=CPU8, slices=2)
    assert port.mesh.shape == {"data": 2, "model": 2}
    out = port.train(state=state_from_jax(
        jax.tree.map(np.array, start), device="cpu",
        shardings=port._state_shardings(port.mesh)))
    assert ref["resizes"] == [["EXPAND", 2, 4]]
    assert [(r["action"], r["from"], r["to"]) for r in port.resize_log] == \
        [("EXPAND", 2, 4)]
    assert [m["slices"] for m in port.metrics] == \
        [m["slices"] for m in ref["metrics"]] == [2, 2, 4, 4, 4]
    for got, want in zip(port.metrics, ref["metrics"]):
        assert got["step"] == want["step"]
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    assert gather(out["rng"]).tolist() == ref["rng"]
    assert list(port.mesh.devices.shape) == ref["mesh"] == [4, 2]
    first = leaves(params)
    for path, leaf in leaves(out["params"]).items():
        name = "/".join(path)
        whole = gather(leaf)
        for (d, m), block in leaf.shards.items():
            box = [[s.start, s.stop] for s in leaf.index((d, m))]
            assert box == ref["index"][f"{name}|{d}|{m}"], (name, d, m)
            theirs = arrays[f"{key}|{name}|{d}|{m}"]
            moved = theirs - first[path][leaf.index((d, m))]
            assert np.linalg.norm(block.numpy() - theirs) <= \
                1e-3 * np.linalg.norm(moved), (name, d, m)
            assert torch.equal(block, whole[leaf.index((d, m))])


def test_compressed_allreduce_at_two_ways_bit_equal_to_jax(reference):
    """compressed_psum_grads over a (data 2, model 2) mesh, each
    coordinate's tree its model block of every leaf, against the
    reference's shard_map over STEPS error-feedback steps: the means and
    the residuals bit for bit; make_compressed_allreduce the same."""
    _, arrays, grads = reference
    mesh = make_mesh(2, 2, devices=slice_devices(4, "cpu"))
    coords = mesh.coords()
    allreduce = make_compressed_allreduce(mesh, {})
    errors = errs2 = None
    for t in range(STEPS):
        tree = [{"a": torch.from_numpy(grads["a"][t, d, :, m * 100:
                                                  (m + 1) * 100]),
                 "b": torch.from_numpy(grads["b"][t, d])}
                for d, m in coords]
        means, errors = compressed_psum_grads(tree, mesh, axes=("data",),
                                              errors=errors)
        means2, errs2 = allreduce(tree, errs2)
        for i, (d, m) in enumerate(coords):
            cols = slice(m * 100, (m + 1) * 100)
            for got, want in ((means[i]["a"], arrays["comp|ma"][t, d, :,
                                                                cols]),
                              (means[i]["b"], arrays["comp|mb"][t, d]),
                              (errors[i]["a"], arrays["comp|ea"][t, d, :,
                                                                 cols]),
                              (errors[i]["b"], arrays["comp|eb"][t, d])):
                np.testing.assert_array_equal(
                    got.numpy().view(np.int32), want.view(np.int32))
            assert torch.equal(means2[i]["a"], means[i]["a"])
            assert torch.equal(errs2[i]["b"], errors[i]["b"])


# -- the port alone: the trainer's layouts, checkpoints, the launcher --------------


def test_step_matches_one_way_and_replicas_stay_equal():
    """One fp32 step of the trainer at (slices, model_ways) (1, 2), (2, 2),
    (1, 4) under both rule tables against (2, 1): the loss and the gradient
    norm to 1e-5, every parameter and moment after the update to 1e-5 of
    its largest, from random moments (so no element's update hangs on its
    gradient's sign); every replica of a block bit-equal to its first."""
    cfg, pcfg = fp32_config("smollm")
    np_params = init_params(pcfg)
    model = build_model(pcfg, device="cpu")
    data = JaxData(JaxDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=8))
    batch = FedBatches(data).batch(0)
    rng = np.random.default_rng(5)
    mu = tree_map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * 1e-3, np_params)
    nu = tree_map(lambda p: rng.random(p.shape).astype(np.float32) * 1e-5,
                  np_params)
    state = {"params": np_params,
             "opt": {"mu": mu, "nu": nu, "step": np.int32(3)},
             "rng": np.array([0, 1], np.uint32), "step": np.int32(3)}
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)

    def step(slices, ways, rules):
        tr = ElasticTrainer(model, opt, FedBatches(data),
                            TrainerConfig(model_ways=ways, max_slices=slices,
                                          rules=rules),
                            devices=CPU8, slices=slices)
        new, metrics = tr.train_step(state_from_jax(
            state, "cpu", shardings=tr._state_shardings(tr.mesh)), batch)
        for x in tree_leaves(new):
            whole = gather(x)
            for c, block in x.shards.items():
                assert torch.equal(block, whole[x.index(c)])
        return [gather(x) for x in tree_leaves(new)], metrics

    want, base = step(2, 1, TP_DP_RULES)
    for rules in (TP_DP_RULES, FSDP_RULES):
        for slices, ways in ((1, 2), (2, 2), (1, 4)):
            got, metrics = step(slices, ways, rules)
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(metrics[key]),
                                           float(base[key]), rtol=1e-5)
            for g, w in zip(got, want):
                if g.dtype.is_floating_point:
                    assert max_norm_err(g, w) < 1e-5, (slices, ways)
                else:
                    assert torch.equal(g, w)


def test_checkpoint_at_two_ways_restores_onto_other_slice_counts(tmp_path):
    """A TrainState saved by the trainer on a (2, 2) mesh restores onto
    (1, 2) and (4, 2), each coordinate's block the saved state's; and the
    fault path at model_ways 2 (a step that raises once) restores the last
    checkpoint onto the same mesh and ends bit-equal to a run without the
    fault."""
    _, pcfg = fp32_config("smollm")
    model = build_model(pcfg, device="cpu")
    data = DataConfig(vocab_size=pcfg.vocab_size, seq_len=16, global_batch=4)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)

    def trainer(data, ckpt_dir):
        return ElasticTrainer(model, opt, data, TrainerConfig(
            steps=4, model_ways=2, max_slices=4, ckpt_dir=ckpt_dir,
            ckpt_period=2, log_period=1), devices=CPU8, slices=2)

    tr = trainer(data, str(tmp_path / "a"))
    saved = tr.train(seed=0)
    for slices in (1, 4):
        sh = tr._state_shardings(make_mesh(slices, 2, devices=CPU8))
        back = tr.store.restore(4, sh, sh)
        for got, want in zip(tree_leaves(back), tree_leaves(saved)):
            whole = gather(want)
            assert got.sharding.mesh.shape == {"data": slices, "model": 2}
            for c, block in got.shards.items():
                assert torch.equal(block, whole[got.index(c)])

    faulty = trainer(data, str(tmp_path / "b"))
    step_fn, calls = faulty.train_step, []

    def flaky(state, batch):
        calls.append(int(state["step"]))
        if len(calls) == 4:                 # the step from 3 to 4
            raise RuntimeError("injected fault")
        return step_fn(state, batch)

    faulty.train_step = flaky
    out = faulty.train(seed=0)
    assert calls == [0, 1, 2, 3, 2, 3]
    assert faulty.recoveries == [{"failed": 3, "restored": 2}]
    for got, want in zip(tree_leaves(out), tree_leaves(saved)):
        assert torch.equal(gather(got), gather(want))


def test_train_launcher_runs_at_two_model_ways(capsys):
    from repro_torch.launch import train
    assert train.main(["--device", "cpu", "--model-ways", "2", "--devices",
                       "2", "--slices", "1", "--elastic", "--steps", "4",
                       "--global-batch", "4", "--seq-len", "16"]) == 0
    out = capsys.readouterr().out
    assert "2 virtual slices of one device (cpu)" in out.splitlines()[0]
    assert "2 model coordinates each" in out.splitlines()[0]
    assert "step     4 loss" in out and "slices 2" in out
    assert "'action': 'EXPAND', 'from': 1, 'to': 2" in out


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b",
                                  "deepseek-moe-16b", "seamless-m4t-medium"])
def test_train_launcher_runs_each_family_at_two_and_four_model_ways(arch,
                                                                    capsys):
    """launch.train takes the SSD, RG-LRU, mixture-of-experts and
    encoder-decoder families at --model-ways 2 and 4 (one slice, then two
    virtual slices of two coordinates with an EXPAND), each step's loss
    finite."""
    from repro_torch.launch import train
    for ways, devices in ((4, "1"), (2, "2")):
        assert train.main(["--arch", arch, "--device", "cpu", "--model-ways",
                           str(ways), "--devices", devices, "--slices", "1",
                           "--elastic", "--steps", "2", "--global-batch",
                           "4", "--seq-len", "16"]) == 0
        out = capsys.readouterr().out
        assert f"{ways} model coordinates each" in out.splitlines()[0]
        losses = [float(line.split()[3]) for line in out.splitlines()
                  if line.startswith("step ")]
        assert len(losses) == 2 and np.isfinite(losses).all(), out


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-4b", "granite-3-2b",
                                  "gemma2-27b", "paligemma-3b",
                                  "mamba2-130m", "recurrentgemma-9b",
                                  "phi3.5-moe-42b-a6.6b", "deepseek-moe-16b",
                                  "seamless-m4t-medium"])
def test_trainer_trains_each_dense_family_at_two_and_four_ways(arch):
    """ElasticTrainer at model_ways 2 and 4 (one slice) and at (2, 2),
    under TP_DP_RULES and FSDP_RULES, for every family, the dense attention
    ones, the SSD and RG-LRU ones, the mixtures of experts and the
    encoder-decoder (paligemma's batches carry its patch embeddings,
    seamless's its frames): two fp32 steps whose losses match the same
    steps at model_ways 1 on as many slices to 1e-5, every replica of a
    block bit-equal to its first; and one slice's the two slices' (for the
    mixtures of experts by the trainer's routing pre-pass, which gives
    each slice's router loss the whole batch's routed shares)."""
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(
        jax_reduced_config(jax_get_model(arch)[1]), dtype="float32")))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(init_params(cfg), "cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                      frontend=cfg.frontend,
                      frontend_tokens=cfg.frontend_tokens,
                      d_model=cfg.d_model)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)

    def losses(slices, ways, rules):
        tr = ElasticTrainer(model, opt, data, TrainerConfig(
            steps=2, model_ways=ways, max_slices=slices, log_period=1,
            rules=rules), devices=CPU8, slices=slices)
        out = tr.train(state=tr.init_state(params=params))
        for x in tree_leaves(out):
            whole = gather(x)
            for c, block in x.shards.items():
                assert torch.equal(block, whole[x.index(c)])
        return [m["loss"] for m in tr.metrics]

    want = {slices: losses(slices, 1, TP_DP_RULES) for slices in (1, 2)}
    assert all(np.isfinite(want[1] + want[2]))
    np.testing.assert_allclose(want[2], want[1], rtol=1e-5)
    for rules in (TP_DP_RULES, FSDP_RULES):
        for slices, ways in ((1, 2), (1, 4), (2, 2)):
            np.testing.assert_allclose(losses(slices, ways, rules),
                                       want[slices], rtol=1e-5,
                                       err_msg=f"{slices} x {ways}")


@pytest.mark.parametrize("case", KIND_CASES)
def test_bridge_carries_reference_params_into_coordinate_blocks(case):
    """The reference's own parameters (its init, as numpy) through
    ``bridge.params_from_jax`` into a TrainState on a (1, 2) mesh: each
    coordinate's model block of every leaf, as ``slice_grads`` reads it,
    equals the tests' ``coordinate_views``, and the blocks put together
    again (as ``_slice_sum`` puts gradients together) are the reference's
    arrays bit for bit: the SSD and RG-LRU mixers, the router and the
    experts, the encoder-decoder."""
    from repro_torch.core.sharding import read_box
    cfg, pcfg = fp32_config(case)
    jparams = jax.tree.map(np.asarray,
                           jax_build_model(cfg).init(jax.random.PRNGKey(0)))
    model = build_model(pcfg, device="cpu")
    params = params_from_jax(jparams, "cpu")
    tr = ElasticTrainer(model, AdamWConfig(), DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2),
        TrainerConfig(model_ways=2), devices=CPU8[:2])
    placed = tr.init_state(params=params)["params"]
    views = [leaves(v) for v in coordinate_views(model, params, tr.mesh)]
    want = leaves(jparams)
    for path, x in leaves(placed).items():
        back = np.zeros(x.shape, np.float32)
        for m, c in enumerate(tp.slices_of(tr.mesh)[0]):
            box = tp.model_block(x, c)
            block = read_box(x, box, c)
            assert torch.equal(block, views[m][path]), (path, m)
            back[box] = block.numpy()
        np.testing.assert_array_equal(back, want[path])


@pytest.mark.parametrize("case", ["mamba2", "deepseek-moe"])
def test_resize_checkpoint_and_compression_take_ssd_and_moe(case, tmp_path):
    """ZeRO-1 moments, resizes, checkpoints and the compressed all-reduce
    take an SSD and a mixture-of-experts model at model_ways 2 as they take
    the dense ones: 4 fp32 steps on 2 slices of 2 coordinates with an
    EXPAND to 4 at the first reconfiguration point (the parameters and the
    ZeRO-1 moments resharded 2 -> 4 in memory) end bit-equal to 2 steps on
    2 slices, checkpointed, restored onto 4 and run on; the checkpoint of
    the resized run restores onto 1 and 4 slices block for block; and
    compressed_psum_grads over one step's per-coordinate gradient blocks on
    a (2, 2) mesh gives each coordinate the mean of its slices' blocks
    within the int8 rounding (half a scale)."""
    from repro_torch.core.tensor_parallel import model_block
    from repro_torch.runtime.trainer import slice_grads
    cfg, pcfg = fp32_config(case)
    model = build_model(pcfg, device="cpu")
    params = params_from_jax(init_params(pcfg), "cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)

    def trainer(steps, slices, ckpt_dir, rms=None):
        return ElasticTrainer(model, opt, data, TrainerConfig(
            steps=steps, model_ways=2, max_slices=4, check_period=2,
            log_period=1, ckpt_dir=str(tmp_path / ckpt_dir), ckpt_period=2),
            rms=rms, devices=CPU8, slices=slices)

    tr = trainer(4, 2, "elastic", ScriptedRMS({1: Decision(Action.EXPAND,
                                                          4)}))
    out = tr.train(state=tr.init_state(params=params))
    assert [(r["action"], r["from"], r["to"]) for r in tr.resize_log] == \
        [("EXPAND", 2, 4)]
    fixed_tr = trainer(2, 2, "restart")
    fixed = fixed_tr.train(state=fixed_tr.init_state(params=params))
    wide = trainer(4, 4, "restart")
    sh = wide._state_shardings(wide.mesh)
    restarted = wide.train(state=wide.store.restore(2, sh, sh))
    for got, want in zip(tree_leaves(out), tree_leaves(restarted)):
        assert torch.equal(gather(got), gather(want))
    for slices in (1, 4):
        sh = tr._state_shardings(make_mesh(slices, 2, devices=CPU8))
        back = tr.store.restore(4, sh, sh)
        for got, want in zip(tree_leaves(back), tree_leaves(out)):
            whole = gather(want)
            for c, block in got.shards.items():
                assert torch.equal(block, whole[got.index(c)])

    mesh = fixed_tr.mesh
    batch = fixed_tr.data.batch(0)
    trees = []
    for j, coords in enumerate(tp.slices_of(mesh)):
        loss = torch.zeros(())
        grads = slice_grads(model, fixed["params"], coords, 1, lambda i, j=j: (
            {k: v[4 * j:4 * j + 4] for k, v in batch.items()}, 0.5), loss,
            opt)
        trees += [tree_map(lambda g, x, c=c: g[model_block(x, c)].clone(),
                           grads, fixed["params"]) for c in coords]
    means, _ = compressed_psum_grads(trees, mesh, axes=("data",))
    coords = mesh.coords()
    for i, (d, m) in enumerate(coords):
        mate = coords.index((1 - d, m))
        for got, a, b in zip(tree_leaves(means[i]), tree_leaves(trees[i]),
                             tree_leaves(trees[mate])):
            exact = (a + b) / 2
            half_scale = 0.5 * max(a.abs().max(), b.abs().max()) / 127
            assert got.shape == a.shape
            assert (got - exact).abs().max() <= half_scale * 1.001 + 1e-30
