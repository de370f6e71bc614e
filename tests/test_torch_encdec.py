"""The port's encoder-decoder (seamless-m4t-medium's ``EncDecLM``) and its
cross attention against the JAX reference, on the CPU: ``encode``,
``forward``, ``loss`` with every gradient, ``prefill``'s caches (the self
cache and the encoder output's cross keys and values) and ``decode_step``,
prefill + decode against forward, the data stream's encoder-decoder
batches, the bridge over the parameter tree and the launchers; then the
"cross" attention kind alone and the non-causal chunked path.

The config is the reference's reduced seamless (d_model 128, 4 heads of 32
on 4 KV heads, 2 + 2 layers, chunks of 64, vocab 2048) in fp32, its
weights drawn by the reference's init at seamless's 12 + 12 layers and cut
to 2 + 2 (a stacked weight's fan-in is its layers axis; ROADMAP.md, Queue
3), carried over by the bridge. Inputs are made with numpy.

The reference's non-causal attention attends the first Sq keys, Sq the
query length, and fails where a chunk of them is empty; the port mirrors
both (ROADMAP.md, "Reference behaviour the port mirrors on purpose"). So
the model-level checks keep frames <= queries within one chunk, the regime
of tests/test_decode_consistency.py (16 frames, 32 tokens). On the CPU the
port's attention takes its chunked path; ``chip_smoke.py`` phase (z) runs
the flash kernel at the published widths.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMData as JaxData  # noqa: E402
from repro.data import batch_specs as jax_batch_specs  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_attention_ref)
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.models.layers import init_from_specs as jax_init  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.data import (DataConfig, SyntheticLMData,  # noqa: E402
                              batch_specs)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import EncDecLM, ModelConfig, build_model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.transformer import DOTS  # noqa: E402

ARCH = "seamless-m4t-medium"
KEY = jax.random.PRNGKey(5)
DEPTH = 12             # seamless's encoder and decoder layers
B, F, S, T = 2, 16, 32, 5   # batch, frames, tokens, decode steps
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
    """The reference's reduced seamless in fp32, and the port's copy."""
    cfg = dataclasses.replace(jax_reduced_config(jax_get_model(ARCH)[1]),
                              dtype="float32", **changes)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def init_params(cfg):
    """The reference's init of ``cfg`` drawn at DEPTH + DEPTH layers, each
    stack cut to ``cfg``'s depth."""
    deep = jax_build_model(dataclasses.replace(
        cfg, num_layers=DEPTH, enc_layers=DEPTH)).init(KEY)
    cut = {"enc_blocks": cfg.enc_layers, "dec_blocks": cfg.num_layers}
    return {k: jax.tree.map(lambda a, n=cut[k]: a[:n], v) if k in cut
            else v for k, v in deep.items()}


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in leaves(sub, prefix + (k,)).items()}
    return {prefix: tree}


def max_norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@functools.lru_cache(maxsize=None)
def reference():
    """The JAX model's outputs, as numpy: encode, forward over F frames and
    S tokens, prefill of the first S - T tokens, T decode steps."""
    cfg, _ = configs()
    model = jax_build_model(cfg)
    params = init_params(cfg)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, F, cfg.d_model), dtype=np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jf, jt = jnp.asarray(frames), jnp.asarray(toks)
    fwd, _ = model.forward(params, jf, jt)
    pre, cache = model.prefill(params, jf, jt[:, :S - T], max_len=S)
    out = {"params": jax.tree.map(np.asarray, params), "frames": frames,
           "tokens": toks, "encode": np.asarray(model.encode(params, jf)),
           "forward": np.asarray(fwd), "prefill": np.asarray(pre),
           "cache": jax.tree.map(np.asarray, cache), "decode": []}
    for t in range(S - T, S):
        dec, cache = model.decode_step(params, cache, jt[:, t:t + 1],
                                       jnp.int32(t))
        out["decode"].append(np.asarray(dec))
    return out


def port_model(**changes):
    _, pcfg = configs(**changes)
    ref = reference()
    return (build_model(pcfg, device="cpu"),
            params_from_jax(ref["params"], device="cpu"), ref)


def test_build_model_gives_an_encoder_decoder():
    model, _, _ = port_model()
    assert isinstance(model, EncDecLM) and model.cfg.enc_layers == 2


def test_encode_and_forward_match_jax():
    model, params, ref = port_model()
    frames, toks = (torch.from_numpy(ref[k]) for k in ("frames", "tokens"))
    enc = model.encode(params, frames)
    assert enc.shape == (B, F, model.cfg.d_model)
    assert max_norm_err(enc, ref["encode"]) < TOL
    fwd, aux = model.forward(params, frames, toks)
    assert fwd.shape == ref["forward"].shape == (B, S, model.cfg.vocab_size)
    assert max_norm_err(fwd, ref["forward"]) < TOL
    assert aux.dtype == torch.float32 and aux.item() == 0.0


def test_prefill_caches_and_decode_match_jax_and_forward():
    """The self cache (k, v, pos), the cross keys and values over every
    frame, the prefill's and each decode step's logits against the
    reference's, and against forward's at the same positions."""
    model, params, ref = port_model()
    frames, toks = (torch.from_numpy(ref[k]) for k in ("frames", "tokens"))
    scale = float(np.abs(ref["forward"]).max())
    pre, cache = model.prefill(params, frames, toks[:, :S - T], max_len=S)
    assert max_norm_err(pre, ref["prefill"]) < TOL
    assert np.abs(pre[:, 0].numpy() - ref["forward"][:, S - T - 1]).max() \
        / scale < TOL
    want, got = leaves(ref["cache"]), leaves(cache)
    assert sorted(got) == sorted(want) == sorted(
        ("dec_blocks",) + k for k in (("self", "k"), ("self", "v"),
                                      ("self", "pos"), ("cross_k",),
                                      ("cross_v",)))
    assert got[("dec_blocks", "cross_k")].shape == (
        2, B, F, model.cfg.num_kv_heads, model.cfg.head_dim)
    # init_cache: zeros of cache_specs' tree (the cross keys specified
    # S long), positions -1
    empty = leaves(model.init_cache(B, S))
    assert sorted(empty) == sorted(want)
    for path, t in empty.items():
        assert tuple(t.shape) == leaves(model.cache_specs(B, S))[path].shape
        assert (t == (-1 if path[-1] == "pos" else 0)).all(), path
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        if path[-1] == "pos":
            np.testing.assert_array_equal(got[path].numpy(), w)
        else:
            assert max_norm_err(got[path], w) < TOL, path
    for i, t in enumerate(range(S - T, S)):
        dec, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        assert max_norm_err(dec, ref["decode"][i]) < TOL, t
        err = np.abs(dec[:, 0].numpy() - ref["forward"][:, t]).max()
        assert err / scale < TOL, t


def enc_dec_batch(cfg, seed=1):
    """F frames, S // 2 tokens and labels (about a quarter masked)."""
    rng = np.random.default_rng(seed)
    s = S // 2
    labels = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    labels[rng.random((B, s)) < 0.25] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                np.int32),
            "labels": labels,
            "frontend": rng.standard_normal((B, F, cfg.d_model),
                                            dtype=np.float32)}


def port_loss_and_grads(pcfg, np_params, batch):
    tparams = params_from_jax(np_params, device="cpu")
    for p in leaves(tparams).values():
        p.requires_grad_(True)
    loss, parts = build_model(pcfg, device="cpu").loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss, parts, {k: p.grad for k, p in leaves(tparams).items()}


@pytest.mark.parametrize("remat", ["none", "nothing_saveable", "dots"])
def test_loss_and_grads_match_jax(remat):
    """Every gradient leaf, the encoder's and enc_in's included; under
    "nothing_saveable" and "dots" each layer is recomputed in the backward
    pass, as the reference's jax.checkpoint of each layer."""
    cfg, pcfg = configs(remat=remat)
    params = init_params(cfg)
    batch = enc_dec_batch(cfg)
    (jloss, jparts), jgrads = jax.value_and_grad(
        jax_build_model(cfg).loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, parts, grads = port_loss_and_grads(
        pcfg, jax.tree.map(np.asarray, params), batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(parts["ce"].item(), float(jparts["ce"]),
                               rtol=LOSS_RTOL)
    assert parts["aux"].item() == float(jparts["aux"]) == 0.0
    want = leaves(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for path, g in grads.items():
        assert max_norm_err(g, want[path]) < TOL, path


class ProductCount(TorchDispatchMode):
    """Counts the matrix products (``transformer.DOTS``) that run."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in DOTS
        return func(*args, **(kwargs or {}))


def test_remat_dots_names_its_roadmap_item():
    """remat="dots" checkpoints each layer exactly as "nothing_saveable"
    (the name stays from when it raised): the reference checkpoints an
    encoder-decoder layer with JAX's default policy whatever the remat, so
    no product is saved and the backward pass runs as many products, with
    the same loss and gradients bit for bit; a forward without a graph
    runs."""
    cfg, _ = configs()
    np_params = jax.tree.map(np.asarray, init_params(cfg))
    batch = enc_dec_batch(cfg)
    runs = {}
    for remat in ("nothing_saveable", "dots"):
        _, pcfg = configs(remat=remat)
        tparams = params_from_jax(np_params, device="cpu")
        for p in leaves(tparams).values():
            p.requires_grad_(True)
        loss, _ = build_model(pcfg, device="cpu").loss(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
        with ProductCount() as bwd:
            loss.backward()
        runs[remat] = (loss.item(), bwd.n,
                       {k: p.grad for k, p in leaves(tparams).items()})
    (l0, n0, g0), (l1, n1, g1) = runs["nothing_saveable"], runs["dots"]
    assert l0 == l1 and n0 == n1 > 0
    for path in g0:
        torch.testing.assert_close(g1[path], g0[path], rtol=0, atol=0)
    _, pcfg = configs(remat="dots")
    with torch.no_grad():
        build_model(pcfg, device="cpu").loss(
            params_from_jax(np_params, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_data_stream_gives_encoder_decoder_batches():
    """seq_len // 2 tokens and seq_len // 2 frames of d_model, fp32, the
    shapes and types of the reference's batches and batch_specs."""
    cfg, _ = configs()
    kw = dict(vocab_size=cfg.vocab_size, seq_len=S, global_batch=4,
              frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
              d_model=cfg.d_model, enc_dec=True)
    got = SyntheticLMData(DataConfig(**kw)).batch(1)
    want = JaxData(JaxDataConfig(**kw)).batch(1)
    specs = jax_batch_specs(JaxDataConfig(**kw))
    mine = batch_specs(DataConfig(**kw))
    assert set(got) == set(want) == set(specs) == set(mine)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape == specs[name].shape
        assert mine[name] == (tuple(t.shape), t.dtype)
    assert got["tokens"].shape == (4, S // 2)
    assert got["frontend"].shape == (4, S // 2, cfg.d_model)
    assert got["frontend"].dtype == torch.float32
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_bridge_carries_the_parameter_tree_unchanged():
    cfg, pcfg = configs()
    params = jax.tree.map(np.asarray, jax_build_model(cfg).init(KEY))
    got = leaves(params_from_jax(params, device="cpu"))
    want = leaves(params)
    specs = leaves(EncDecLM(pcfg, device="cpu").specs())
    assert set(got) == set(want) == set(specs)
    assert {p[0] for p in got} == {"embed", "enc_in", "enc_blocks",
                                   "enc_norm", "dec_blocks", "final_norm"}
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape == specs[path].shape
        np.testing.assert_array_equal(t.numpy(), want[path])


def test_launchers_train_seamless_and_refuse_to_serve_it(capsys):
    from repro_torch.launch import serve, train
    with pytest.raises(SystemExit, match="no Server path.*init_cache"):
        serve.main(["--device", "cpu", "--arch", ARCH])
    assert train.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                       "--global-batch", "2", "--seq-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "step     2 loss" in out and f"{ARCH} on cpu: 2 steps" in out


# -- cross attention alone ------------------------------------------------------


def cross_setup(sq, sk, seed=2):
    """(jax cfg, port cfg, jax params, port params, x, x_kv) for one cross
    attention layer of the reduced seamless (chunks of 64)."""
    cfg, pcfg = configs()
    params = jax_init(jax.random.PRNGKey(seed),
                      jax_attn.cross_attention_specs(cfg), jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, sq, cfg.d_model), dtype=np.float32)
    x_kv = rng.standard_normal((B, sk, cfg.d_model), dtype=np.float32)
    return (cfg, pcfg, params,
            params_from_jax(jax.tree.map(np.asarray, params), device="cpu"),
            x, x_kv)


@pytest.mark.parametrize("sq,sk", [
    (32, 32),     # Sq = Sk
    (48, 16),     # Sq > Sk within one chunk: every key
    (128, 100),   # Sq > Sk over two chunks, the second one short
    (16, 48),     # Sq < Sk: the first 16 keys only
    (64, 200),    # Sq < Sk: the first 64
])
def test_cross_attention_matches_jax(sq, sk):
    cfg, pcfg, jparams, params, x, x_kv = cross_setup(sq, sk)
    want = np.asarray(jax_attn.attention_apply(
        jparams, jnp.asarray(x), cfg, kind="cross", x_kv=jnp.asarray(x_kv)))
    got = attn.attention_apply(params, torch.from_numpy(x), pcfg,
                               kind="cross", x_kv=torch.from_numpy(x_kv))
    assert got.shape == (B, sq, cfg.d_model)
    assert max_norm_err(got, want) < TOL
    if sq < sk:
        # the reference's key cut: the frames past Sq do not matter
        cut = attn.attention_apply(params, torch.from_numpy(x), pcfg,
                                   kind="cross",
                                   x_kv=torch.from_numpy(x_kv[:, :sq]))
        torch.testing.assert_close(got, cut, rtol=0, atol=0)


@pytest.mark.parametrize("sq,sk", [(128, 64), (100, 16)])
def test_cross_attention_raises_where_the_reference_does(sq, sk):
    """Fewer frames than queries and a chunk of the first Sq keys empty:
    the reference fails on an empty reduction, the port says why."""
    cfg, pcfg, jparams, params, x, x_kv = cross_setup(sq, sk)
    with pytest.raises(ValueError, match="zero-size"):
        jax_attn.attention_apply(jparams, jnp.asarray(x), cfg, kind="cross",
                                 x_kv=jnp.asarray(x_kv))
    with pytest.raises(ValueError, match="non-causal attention of "
                                         f"{sq} queries over {sk} keys"):
        attn.attention_apply(params, torch.from_numpy(x), pcfg,
                             kind="cross", x_kv=torch.from_numpy(x_kv))
    k = torch.zeros((B, sk, 4, 32))
    with pytest.raises(ValueError, match="a chunk is empty"):
        attn.noncausal_keys(k, k, pcfg, sq)


@pytest.mark.parametrize("sq,sk", [(48, 16), (16, 48), (64, 64)])
def test_noncausal_chunked_path_matches_jax_and_plain(sq, sk):
    """The chunked path without a causal mask against the reference's
    (GQA 4 / 2, D 32) and, on the keys it attends (the first Sq), against
    the kernel's plain version attention_ref(causal=False) and the
    reference's."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, sq, 4, 32), dtype=np.float32)
    k, v = (rng.standard_normal((B, sk, 2, 32), dtype=np.float32)
            for _ in range(2))
    cfg, pcfg = configs()
    want = np.asarray(jax_attn.chunked_attention(
        *(jnp.asarray(t) for t in (q, k, v)), cfg, causal=False,
        window=None))
    got = attn.chunked_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                 pcfg, causal=False, window=None)
    assert max_norm_err(got, want) < 1e-5
    kc, vc = (t[:, :sq].transpose(0, 2, 1, 3) for t in (k, v))
    qt = q.transpose(0, 2, 1, 3)
    plain = attention_ref(*(torch.from_numpy(np.ascontiguousarray(t))
                            for t in (qt, kc, vc)), causal=False)
    jplain = np.asarray(jax_attention_ref(
        *(jnp.asarray(t) for t in (qt, kc, vc)), causal=False))
    assert max_norm_err(plain, jplain) < 1e-5
    assert max_norm_err(got, plain.transpose(1, 2).numpy()) < 1e-5


def test_chip_smoke_trains_seamless_as_an_encoder_decoder():
    """chip_smoke.py's zt row of seamless: its stream gives S / 2 frames of
    d_model and S / 2 tokens a row at the fp32 and bf16 shapes (the
    reference's train_4k sequence split by enc_dec), the row keeps every
    layer, and the kernel checks hold the step's three attention calls,
    each with its own mask: the encoder's self attention and the cross
    attention of the decoder's S / 2 queries over the S / 2 frames without
    a causal mask (the same call), the decoder's self attention causal."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    depth, cuts, fp32, (b, s) = cs.ZT_CELLS[ARCH]
    assert depth == DEPTH and cuts == (DEPTH,) and (b, s) == (8, 4096)
    cfg = cs.zt_config(ARCH, DEPTH)
    assert (cfg.num_layers, cfg.enc_layers, cfg.remat) == (12, 12, "dots")
    for rows, seq in (fp32, (b, s)):
        batch = SyntheticLMData(cs.zt_data(cfg, rows, seq)).batch(0)
        assert batch["frontend"].shape == (rows, seq // 2, cfg.d_model)
        assert batch["frontend"].dtype == torch.float32
        assert batch["tokens"].shape == batch["labels"].shape == \
            (rows, seq // 2)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    half = s // 2
    encoder = (b, h, kv, half, half, d, False, None, None)
    cross = (b, h, kv, half, half, d, False, None, None)
    decoder = (b, h, kv, half, half, d, True, None, None)
    cases = [tuple(case[:9]) for case in cs.zt_kernel_cases()
             if case[9] == torch.bfloat16 and case[10] == "bshd"]
    for call in (encoder, cross, decoder):
        assert call in cases
    assert cs.zt_label((*encoder, torch.bfloat16, "bshd")) == "seamless-2048"
    assert cs.zt_label((*decoder, torch.bfloat16, "bshd")) == \
        "seamless-dec-2048"
    assert cs.ZT_ROWS["seamless-2048"] == cs.ZT_ROWS["seamless-dec-2048"] \
        == ARCH
