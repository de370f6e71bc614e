"""Gradients of the port's two scans and of the two scan models against the
JAX reference, on the CPU.

The reference trains mamba2 and recurrentgemma through XLA's autodiff of
its plain scans (``repro.models.ssm.ssd_chunked``, the associative scan
``repro.models.rglru.rglru_scan``); the port's CPU paths run torch autograd
of the same functions. Both are fed the same numpy inputs (or weights, by
the bridge). On the card the scans take the hand-written forward and
backward kernels (``kernels/ssd/csrc/ssd_scan_bwd.cu``, the second entry of
``kernels/rglru/csrc/rglru_scan.cu``) through autograd Functions; here
those Functions run with the kernels' plain mirrors in their place, and
``chip_smoke.py`` holds the kernels themselves against these paths.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.ref import rglru_ref as jax_rglru_ref  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import (rglru_bwd_chunks,  # noqa: E402
                                          rglru_bwd_ref, rglru_ref)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import (ssd_bwd_passes, ssd_passes,  # noqa: E402
                                         ssd_ref)
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402

# fp32 on both sides, sums in another order: max-normalised 1e-4 for every
# gradient (the reference's own model-level tolerance); the loss to a
# relative 1e-5, as tests/test_torch_train.py holds smollm's
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
KEY = jax.random.PRNGKey(5)


def max_norm_err(got, want):
    """max |got - want| over max |want| (over 1 where want is all zeros, as
    a one-step scan's gradient of a decay that multiplies nothing)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def ssd_inputs(b, s, h, p, n, seed=0):
    """x, dt (softplus'ed), a_log, B, C and dy as tests/test_kernels.py
    draws the scan's inputs, fp32 numpy."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    return (randn(b, s, h, p), np.logaddexp(0.0, randn(b, s, h))
            .astype(np.float32), randn(h) * np.float32(0.5), randn(b, s, n),
            randn(b, s, n), randn(b, s, h, p))


def torch_grads(fn, args, cotangents):
    """Gradients of ``fn(*args)``'s outputs against ``cotangents`` (None
    skips an output) with respect to every arg, by torch autograd."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, torch.from_numpy(g)) for o, g in zip(outs, cotangents)
             if g is not None]
    grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                [g for _, g in pairs], allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, leaves)]


# (b, s, h, p, n, chunk): chunks that divide S; S that the chunk does not
# divide, which both packages' ssd_chunked halve it for (40 -> 8, 24 -> 8);
# S below the chunk; several chunks of the reference's own 16
SSD_GRAD_CASES = [
    (2, 64, 3, 16, 32, 16),
    (2, 40, 3, 16, 32, 16),
    (1, 24, 2, 32, 16, 16),
    (1, 20, 2, 16, 32, 64),
    (2, 96, 2, 16, 16, 32),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_GRAD_CASES)
def test_ssd_chunked_grads_match_jax(b, s, h, p, n, chunk):
    """dx, ddt, da_log, dB and dC of the port's chunked SSD (the model's CPU
    path) against jax.grad of the reference's, fp32, for a random dy."""
    *args, dy = ssd_inputs(b, s, h, p, n)
    want = jax.jit(jax.grad(lambda *a: jnp.vdot(
        jax_ssm.ssd_chunked(*a, chunk)[0], dy), argnums=range(5)))(
            *(jnp.asarray(a) for a in args))
    got = torch_grads(lambda *a: ssm.ssd_chunked(*a, chunk)[0], args, [dy])
    for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc"), got, want):
        assert max_norm_err(g, w) < GRAD_TOL, name


# (b, s, h, p, n, chunk, with dh_final): several chunks, a ragged S (a short
# last chunk), S below the chunk, S = 1 (with and without a final-state
# gradient), a chunk above the kernel's 128 rows, mamba2's P 64 and N 128
BWD_PASSES_CASES = [
    (2, 64, 3, 16, 32, 16, False),
    (1, 128, 2, 32, 64, 32, True),
    (2, 100, 3, 16, 32, 32, True),
    (1, 300, 2, 16, 16, 256, False),
    (2, 20, 2, 64, 128, 64, True),
    (2, 1, 2, 16, 16, 16, True),
    (2, 1, 2, 16, 16, 16, False),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_dh", BWD_PASSES_CASES)
def test_ssd_bwd_passes_match_autograd_and_jax(b, s, h, p, n, chunk,
                                               with_dh):
    """The backward kernel's passes, mirrored in plain PyTorch, against
    torch autograd of the sequential plain version (y and, with a gradient
    of its own, h_final) and, for y alone, jax.grad of the reference's
    sequential oracle."""
    *args, dy = ssd_inputs(b, s, h, p, n, seed=1)
    rng = np.random.default_rng(2)
    dh = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_dh else None
    got = ssd_bwd_passes(*(torch.from_numpy(a) for a in args),
                         torch.from_numpy(dy),
                         None if dh is None else torch.from_numpy(dh),
                         chunk=chunk)
    want = torch_grads(ssd_ref, args, [dy, dh])
    for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert max_norm_err(g, w) < GRAD_TOL, name
    if dh is None and s <= 64:      # the oracle runs op by op in JAX
        from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
        jwant = jax.grad(lambda *a: jnp.vdot(jax_ssd_ref(*a), dy),
                         argnums=range(5))(*(jnp.asarray(a) for a in args))
        for name, g, w in zip(("dx", "ddt", "da_log", "db", "dc"), got,
                              jwant):
            assert max_norm_err(g, w) < GRAD_TOL, name


def test_ssd_bwd_passes_keep_bf16_types():
    """bf16 x, B and C: the passes compute in fp32 and give each gradient
    its input's dtype, within bf16's rounding of fp32 autograd."""
    *args, dy = ssd_inputs(2, 40, 2, 16, 32)
    t = [torch.from_numpy(a) for a in args]
    for i in (0, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
    got = ssd_bwd_passes(*t, torch.from_numpy(dy).to(torch.bfloat16),
                         chunk=16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    want = torch_grads(ssd_ref, [a.float().numpy() for a in t],
                       [torch.from_numpy(dy).to(torch.bfloat16).float()
                        .numpy()])
    for g, w in zip(got, want):
        assert max_norm_err(g.float(), w) < 2e-2


# (b, s, w): RG-LRU scans, a ragged length, S = 1
RGLRU_GRAD_CASES = [(2, 32, 16), (1, 37, 24), (2, 1, 8)]


def rglru_inputs(b, s, w, seed=0):
    """a in (0, 0.99), b, h0 and dh, fp32 numpy, as tests/test_kernels.py
    draws the scan's a and b."""
    rng = np.random.default_rng(seed)
    a = (0.99 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))).astype(
        np.float32)
    return (a, rng.standard_normal((b, s, w), dtype=np.float32),
            rng.standard_normal((b, w), dtype=np.float32),
            rng.standard_normal((b, s, w), dtype=np.float32))


@pytest.mark.parametrize("b,s,w", RGLRU_GRAD_CASES)
def test_rglru_scan_grads_match_jax_associative_scan(b, s, w):
    """da and db of the port's log-depth scan (the model's CPU path)
    against jax.grad of the reference's associative scan."""
    a, bb, _, dh = rglru_inputs(b, s, w)
    want = jax.jit(jax.grad(
        lambda x, y: jnp.vdot(jax_rglru.rglru_scan(x, y), dh),
        argnums=(0, 1)))(jnp.asarray(a), jnp.asarray(bb))
    got = torch_grads(rglru.rglru_scan, [a, bb], [dh])
    for name, g, wnt in zip(("da", "db"), got, want):
        assert max_norm_err(g, wnt) < GRAD_TOL, name


@pytest.mark.parametrize("b,s,w", RGLRU_GRAD_CASES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_ref_grads_match_jax_ref(b, s, w, with_h0):
    """da, db and dh0 of the plain version (the backward kernel's yardstick)
    against jax.grad of the reference's sequential oracle, with and
    without an initial state."""
    a, bb, h0, dh = rglru_inputs(b, s, w, seed=1)
    args = [a, bb, h0] if with_h0 else [a, bb]
    want = jax.grad(lambda *x: jnp.vdot(jax_rglru_ref(*x), dh),
                    argnums=range(len(args)))(*(jnp.asarray(x) for x in args))
    got = torch_grads(rglru_ref, args, [dh])
    for name, g, wnt in zip(("da", "db", "dh0"), got, want):
        assert max_norm_err(g, wnt) < GRAD_TOL, name


# -- the kernel ops' gradients, the plain mirrors in the kernels' place -----------


def test_ssd_function_routes_both_passes_through_the_wrappers(monkeypatch):
    """The ``ssd_scan_fwd`` op keeps the forward wrapper's workspace and
    its registered gradient hands it, dy and the final state's gradient (None when the
    loss does not read h_final) to the backward wrapper. With the plain
    mirrors standing in for the two kernels, its gradients are autograd's
    of the plain version."""
    calls = []

    def fake_fwd(x, dt, a_log, b, c, *, chunk, keep_workspace):
        calls.append(("fwd", chunk, keep_workspace))
        y, h_final = ssd_passes(x, dt, a_log, b, c, chunk=chunk)
        return y, h_final, torch.zeros(3)

    def fake_bwd(x, dt, a_log, b, c, dy, dh_final, workspace, *, chunk):
        calls.append(("bwd", chunk, dh_final is None, workspace.numel()))
        return ssd_bwd_passes(x, dt, a_log, b, c, dy, dh_final, chunk=chunk)

    monkeypatch.setattr(ssd_ops, "ssd_scan", fake_fwd)
    monkeypatch.setattr(ssd_ops, "ssd_scan_bwd", fake_bwd)
    *args, dy = ssd_inputs(2, 40, 2, 16, 32)
    dh = np.random.default_rng(3).standard_normal((2, 2, 16, 32)).astype(
        np.float32)
    for cotangents in ([dy, None], [dy, dh]):
        got = torch_grads(lambda *a: ssd_ops.ssd_fwd_op(*a, 16)[:2], args,
                          cotangents)
        want = torch_grads(ssd_ref, args, cotangents)
        for g, w in zip(got, want):
            assert max_norm_err(g, w) < GRAD_TOL
    assert calls == [("fwd", 16, True), ("bwd", 16, True, 3),
                     ("fwd", 16, True), ("bwd", 16, False, 3)]


def test_rglru_function_saves_h_and_routes_the_backward(monkeypatch):
    """The ``rglru_scan_fwd`` op saves the forward's output h (not b) and
    its gradient hands it, a, h0 and dh to the backward wrapper; with the plain scan and the backward's
    plain mirror standing in for the two kernels, da, db and dh0 are
    autograd's of the plain version."""
    seen = []

    def fake_bwd(a, h, h0, dh):
        seen.append((h, h0 is None))
        return rglru_bwd_ref(a, h, h0, dh)

    monkeypatch.setattr(rglru_ops, "rglru_scan", rglru_ref)
    monkeypatch.setattr(rglru_ops, "rglru_scan_bwd", fake_bwd)
    a, bb, h0, dh = rglru_inputs(2, 9, 4)
    for args in ([a, bb], [a, bb, h0]):
        got = torch_grads(lambda *x: rglru_ops.rglru_fwd_op(
            *x, *([None] if len(x) == 2 else [])), args, [dh])
        want = torch_grads(rglru_ref, args, [dh])
        assert len(got) == len(want) == len(args)
        for g, w in zip(got, want):
            assert max_norm_err(g, w) < GRAD_TOL
        h = rglru_ref(*(torch.from_numpy(x) for x in args))
        assert torch.equal(seen[-1][0], h) and seen[-1][1] == (len(args) == 2)


@pytest.mark.parametrize("b,s,w", RGLRU_GRAD_CASES)
def test_rglru_bwd_ref_matches_autograd(b, s, w):
    """The backward kernel's reverse recurrence, mirrored step by step,
    against torch autograd of the plain version, with and without h0."""
    a, bb, h0, dh = rglru_inputs(b, s, w, seed=2)
    for args in ([a, bb], [a, bb, h0]):
        t = [torch.from_numpy(x) for x in args]
        h = rglru_ref(*t)
        got = rglru_bwd_ref(t[0], h, t[2] if len(t) == 3 else None,
                            torch.from_numpy(dh))
        want = torch_grads(rglru_ref, args, [dh])
        for g, wnt in zip(got, want):
            assert max_norm_err(g, wnt) < GRAD_TOL
        assert (got[2] is None) == (len(args) == 2)


@pytest.mark.parametrize("b,s,w,chunk,seg", [
    (2, 300, 5, 128, 16), (1, 128, 3, 128, 16), (2, 100, 4, 128, 16),
    (1, 1, 2, 128, 16), (2, 37, 6, 8, 2), (1, 64, 3, 16, 16)])
def test_rglru_bwd_chunks_match_the_step_by_step_mirror(b, s, w, chunk, seg):
    """The backward kernel's order (segments, chunk aggregates, the chunks'
    chain right to left, each segment rescanned from its carry) gives the
    step-by-step recurrence's gradients: S over several chunks and ragged,
    S one chunk exactly, S below a chunk, S 1, and many chunks of a few
    segments, with and without h0."""
    a, bb, h0, dh = rglru_inputs(b, s, w, seed=4)
    t = [torch.from_numpy(x) for x in (a, bb, h0, dh)]
    for init in (None, t[2]):
        h = rglru_ref(t[0], t[1], init)
        got = rglru_bwd_chunks(t[0], h, init, t[3], chunk=chunk, seg=seg)
        want = rglru_bwd_ref(t[0], h, init, t[3])
        for g, wnt in zip(got, want):
            if wnt is None:
                assert g is None
                continue
            assert g.shape == wnt.shape
            assert max_norm_err(g, wnt) < 1e-6


def test_ops_take_the_plain_version_on_the_cpu_under_autograd():
    """On CPU tensors the ops take the plain version, differentiable by
    torch autograd, whatever the grad mode."""
    *args, dy = ssd_inputs(1, 8, 2, 16, 16)
    got = torch_grads(lambda *a: ssd_ops.ssd_op(*a, chunk=4), args,
                      [dy, None])
    want = torch_grads(ssd_ref, args, [dy])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a, bb, h0, dh = rglru_inputs(1, 5, 3)
    got = torch_grads(rglru_ops.rglru_op, [a, bb, h0], [dh])
    want = torch_grads(rglru_ref, [a, bb, h0], [dh])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the two scan models' loss and gradients --------------------------------------

# the reduced configs, their batch and the depth their weights are drawn at:
# the reference's init takes a stacked weight's layers axis as its fan-in,
# so a cut model drawn on its own is chaotic (tests/test_torch_model.py);
# drawn at its architecture's depth and cut, it is not. recurrentgemma's
# batch spans the window of 64 (80 tokens; its attention chunk halves to 16)
MODELS = {"mamba2-130m": (2, 32, 24), "recurrentgemma-9b": (2, 80, 38)}


def reduced_fp32(arch, remat):
    cfg = dataclasses.replace(jax_reduced_config(jax_get_model(arch)[1]),
                              dtype="float32", remat=remat)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def init_params(cfg, depth):
    """The reference's init of ``cfg`` drawn as its ``depth``-layer model's
    layers are, cut to the reduced model's stacked units and tail."""
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


@pytest.mark.parametrize("remat", ["none", "nothing_saveable"])
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_scan_model_loss_and_grads_match_jax(arch, remat):
    """The reduced mamba2-130m and recurrentgemma-9b in fp32: CausalLM.loss
    and every gradient leaf against jax.value_and_grad of the reference's
    loss (under jax.jit: the RG-LRU's associative scan runs op by op for
    minutes otherwise), with and without remat."""
    b, s, depth = MODELS[arch]
    cfg, pcfg = reduced_fp32(arch, remat)
    params = init_params(cfg, depth)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)}
    batch["labels"][rng.random((b, s)) < 0.25] = -1
    model = jax_build_model(cfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    port = build_model(pcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
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
        assert max_norm_err(g, want[path]) < GRAD_TOL, path


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_train_launcher_trains_the_scan_models_on_cpu(arch, capsys):
    from repro_torch.launch import train
    assert train.main(["--device", "cpu", "--arch", arch, "--steps", "4",
                       "--global-batch", "4", "--seq-len", "32"]) == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"step +\d+ loss (\S+)", out)]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert f"{arch} on cpu: 4 steps" in out
