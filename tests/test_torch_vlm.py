"""The port's paligemma-3b (a decoder with a patch frontend stub) against
the JAX reference, on the CPU: ``forward`` with the patch embeddings
prepended, ``prefill`` and ``decode_step`` at positions past them, ``loss``
whole and over sequence chunks with every gradient, the data stream's
frontend batches, ``Server.run`` (text only, as the reference's Server),
the bridge over the parameter tree and the launchers.

The config is the reference's reduced paligemma (d_model 128, 4 query
heads on 1 KV head of 32, 2 layers, 8 patch embeddings, vocab 2048) in
fp32, its weights drawn by the reference's init at paligemma's 18 layers
and cut to 2 (a stacked weight's fan-in is its layers axis: 2 layers drawn
alone are chaotic; ROADMAP.md, Queue 3), and carried over by the bridge.
Inputs are made with numpy. On the CPU the port's attention takes its
chunked path; ``chip_smoke.py`` phase (y) runs the flash kernel at the
published widths.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMData as JaxData  # noqa: E402
from repro.data import batch_specs as jax_batch_specs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import Server as JaxServer  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.data import (DataConfig, SyntheticLMData,  # noqa: E402
                              batch_specs)
from repro_torch.models import CausalLM, ModelConfig, build_model  # noqa: E402
from repro_torch.runtime import Request, Server  # noqa: E402

ARCH = "paligemma-3b"
KEY = jax.random.PRNGKey(4)
DEPTH = 18           # paligemma-3b's layers, the scale the weights are drawn at
B, S, T = 2, 32, 5   # batch, prompt tokens, decode steps
# max-normalised, as tests/test_decode_consistency.py holds the reference;
# the loss to a relative 1e-5, as tests/test_torch_train.py
TOL = 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """The tier-1 run shares the machine's cores among its workers: the
    port's small ops run on one thread each, not on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def configs(**changes):
    """The reference's reduced paligemma in fp32, and the port's copy."""
    cfg = dataclasses.replace(jax_reduced_config(jax_get_model(ARCH)[1]),
                              dtype="float32", **changes)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def init_params(cfg):
    """The reference's init of ``cfg`` drawn at DEPTH layers, cut to
    ``cfg``'s."""
    deep = jax_build_model(dataclasses.replace(cfg, num_layers=DEPTH)).init(
        KEY)
    reps = cfg.pattern_repeats[0]
    return {k: jax.tree.map(lambda a: a[:reps], v) if k == "blocks" else v
            for k, v in deep.items()}


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in leaves(sub, prefix + (k,)).items()}
    return {prefix: tree}


def max_norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def inputs(cfg, seed=0):
    """Tokens (B, S + T) and patch embeddings (B, frontend_tokens, E)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    front = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model),
                                dtype=np.float32)
    return toks, front


@functools.lru_cache(maxsize=None)
def reference():
    """The JAX model's outputs, as numpy: forward over the whole sequence,
    prefill of the first S tokens after the patches, T decode steps at
    positions nf + S + t."""
    cfg, _ = configs()
    model = jax_build_model(cfg)
    params = init_params(cfg)
    toks, front = inputs(cfg)
    nf = cfg.frontend_tokens
    fwd, _ = model.forward(params, jnp.asarray(toks),
                           extra_embeds=jnp.asarray(front))
    pre, cache = model.prefill(params, jnp.asarray(toks[:, :S]),
                               max_len=nf + S + T,
                               extra_embeds=jnp.asarray(front))
    out = {"params": jax.tree.map(np.asarray, params), "tokens": toks,
           "front": front, "forward": np.asarray(fwd),
           "prefill": np.asarray(pre),
           "cache": jax.tree.map(np.asarray, cache), "decode": []}
    for t in range(T):
        dec, cache = model.decode_step(
            params, cache, jnp.asarray(toks[:, S + t:S + t + 1]),
            jnp.int32(nf + S + t))
        out["decode"].append(np.asarray(dec))
    return out


def port_model():
    _, pcfg = configs()
    ref = reference()
    return (build_model(pcfg, device="cpu"),
            params_from_jax(ref["params"], device="cpu"), ref)


def test_forward_with_patch_embeddings_matches_jax():
    model, params, ref = port_model()
    toks, front = (torch.from_numpy(ref[k]) for k in ("tokens", "front"))
    fwd, aux = model.forward(params, toks, extra_embeds=front)
    nf = front.shape[1]
    assert fwd.shape == (B, nf + S + T, model.cfg.vocab_size)
    assert max_norm_err(fwd, ref["forward"]) < TOL
    assert aux.item() == 0.0
    # the patches change every position after them
    plain, _ = model.forward(params, toks)
    assert max_norm_err(plain, fwd[:, nf:].numpy()) > 1e-2


def test_prefill_and_decode_after_the_patches_match_jax_and_forward():
    """The cache holds the patches' positions first; decode steps at nf +
    S + t agree with the reference's and with forward's logits there."""
    model, params, ref = port_model()
    toks, front = (torch.from_numpy(ref[k]) for k in ("tokens", "front"))
    nf = front.shape[1]
    scale = float(np.abs(ref["forward"]).max())
    pre, cache = model.prefill(params, toks[:, :S], max_len=nf + S + T,
                               extra_embeds=front)
    assert max_norm_err(pre, ref["prefill"]) < TOL
    assert np.abs(pre[:, 0].numpy() - ref["forward"][:, nf + S - 1]).max() \
        / scale < TOL
    want = leaves(ref["cache"])
    got = leaves(cache)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        if path[-1] == "pos":
            np.testing.assert_array_equal(got[path].numpy(), w)
            assert (w[..., :nf + S] == np.arange(nf + S)).all()
        else:
            assert max_norm_err(got[path], w) < TOL, path
    for t in range(T):
        dec, cache = model.decode_step(params, cache,
                                       toks[:, S + t:S + t + 1], nf + S + t)
        assert max_norm_err(dec, ref["decode"][t]) < TOL, t
        err = np.abs(dec[:, 0].numpy() - ref["forward"][:, nf + S + t]).max()
        assert err / scale < TOL, t


def lm_batch(cfg, seed=1):
    """Text tokens and labels (about a quarter masked) after
    frontend_tokens patch embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    s = S - cfg.frontend_tokens
    labels = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels[rng.random((B, s)) < 0.25] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                np.int32),
            "labels": labels,
            "frontend": rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model), dtype=np.float32)}


@pytest.mark.parametrize("ce_chunk", [0, 16, 10])
def test_loss_and_grads_with_patches_match_jax(ce_chunk):
    """The patch positions carry no labels: whole logits, chunks of 16, and
    a ragged last chunk (10, 10, 4 over 24 text positions)."""
    cfg, pcfg = configs(ce_chunk=ce_chunk)
    params = init_params(cfg)
    batch = lm_batch(cfg)
    (jloss, jparts), jgrads = jax.value_and_grad(
        jax_build_model(cfg).loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    for p in leaves(tparams).values():
        p.requires_grad_(True)
    loss, parts = build_model(pcfg, device="cpu").loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(parts["ce"].item(), float(jparts["ce"]),
                               rtol=LOSS_RTOL)
    want = leaves(jax.tree.map(np.asarray, jgrads))
    got = leaves(tparams)
    assert set(got) == set(want)
    for path, p in got.items():
        assert max_norm_err(p.grad, want[path]) < TOL, path


def test_data_stream_carries_patch_embeddings():
    """Text of seq_len - frontend_tokens tokens beside (B, frontend_tokens,
    d_model) fp32 embeddings, the shapes and types of the reference's
    batches and batch_specs; standard normal draws."""
    cfg, pcfg = configs()
    kw = dict(vocab_size=cfg.vocab_size, seq_len=S, global_batch=4,
              frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
              d_model=cfg.d_model)
    got = SyntheticLMData(DataConfig(**kw)).batch(2)
    want = JaxData(JaxDataConfig(**kw)).batch(2)
    specs = jax_batch_specs(JaxDataConfig(**kw))
    assert set(got) == set(want) == set(specs) == set(
        batch_specs(DataConfig(**kw)))
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape == specs[name].shape
        assert batch_specs(DataConfig(**kw))[name] == (
            tuple(t.shape), t.dtype)
    assert got["tokens"].dtype == torch.int32
    assert got["frontend"].dtype == torch.float32
    assert got["tokens"].shape == (4, S - cfg.frontend_tokens)
    front = got["frontend"]
    assert abs(float(front.mean())) < 0.1 and abs(float(front.std()) - 1) < 0.1
    assert torch.equal(SyntheticLMData(DataConfig(**kw)).batch(2)["frontend"],
                       front)


def test_server_serves_text_as_the_jax_server():
    """The Server passes no patch embeddings, as the reference's: the same
    greedy tokens from the same weights."""
    cfg, pcfg = configs()
    params = init_params(cfg)
    jax_server = JaxServer(jax_build_model(cfg), params, batch=2, max_len=32)
    server = Server(build_model(pcfg, device="cpu"),
                    params_from_jax(jax.tree.map(np.asarray, params),
                                    device="cpu"), batch=2, max_len=32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 6, 4)]
    want = jax_server.run([JaxRequest(rid=i, prompt=p, max_new_tokens=4)
                           for i, p in enumerate(prompts)])
    got = server.run([Request(rid=i, prompt=p, max_new_tokens=4)
                      for i, p in enumerate(prompts)])
    assert got == want and len(got) == 3


def test_bridge_carries_the_parameter_tree_unchanged():
    """Every leaf of paligemma's tree at its key path and shape, bit for
    bit, and the tree is what the port's specs describe."""
    cfg, pcfg = configs()
    params = jax.tree.map(np.asarray, jax_build_model(cfg).init(KEY))
    got = leaves(params_from_jax(params, device="cpu"))
    want = leaves(params)
    specs = leaves(CausalLM(pcfg, device="cpu").specs())
    assert set(got) == set(want) == set(specs)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape == specs[path].shape
        np.testing.assert_array_equal(t.numpy(), want[path])


def test_launchers_run_paligemma_on_cpu(capsys):
    from repro_torch.launch import serve, train
    assert serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "2",
                       "--new-tokens", "2", "--batch", "2"]) == 0
    assert train.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                       "--global-batch", "2", "--seq-len", "32"]) == 0
    out = capsys.readouterr().out
    assert f"{ARCH} on cpu: 4 tokens, 2 requests" in out
    assert "step     2 loss" in out and f"{ARCH} on cpu: 2 steps" in out
