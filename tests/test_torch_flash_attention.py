"""The port's flash attention (plain version and dispatching wrapper) against
the JAX reference: ``attention_ref`` and the Pallas kernel in interpret
mode, on the same numpy inputs.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import \
    flash_attention_op as jax_flash_op  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention_op  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from test_kernels import FLASH_CASES  # noqa: E402

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# fp32: both sides are fp32 with sums in another order; bf16: outputs are
# rounded to bf16 (2^-8 relative) on both sides
TOLS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def make_inputs(b, h, kv, sq, sk, d, jdtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d))]
    jax_in = [jnp.asarray(a).astype(jdtype) for a in arrs]
    # the same (rounded) values for both packages
    torch_in = [torch.from_numpy(np.array(x.astype(jnp.float32)))
                .to(TORCH_DTYPES[jdtype]) for x in jax_in]
    return jax_in, torch_in


def as_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


@pytest.mark.parametrize(
    "b,h,kv,s,d,causal,window,softcap,jdtype,_tol", FLASH_CASES)
def test_flash_matches_jax_ref_and_interpret_kernel(
        b, h, kv, s, d, causal, window, softcap, jdtype, _tol):
    (jq, jk, jv), (q, k, v) = make_inputs(b, h, kv, s, s, d, jdtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    j_ref = as_np(jax_attention_ref(jq, jk, jv, **kw))
    j_kernel = as_np(jax_flash_op(jq, jk, jv, block_q=128, block_k=128,
                                  impl="interpret", **kw))
    tol = TOLS[q.dtype]
    for out in (attention_ref(q, k, v, **kw),
                flash_attention_op(q, k, v, **kw),
                flash_attention_op(q, k, v, impl="ref", **kw)):
        assert out.dtype == q.dtype and out.shape == q.shape
        np.testing.assert_allclose(as_np(out), j_ref, atol=tol, rtol=tol)
        np.testing.assert_allclose(as_np(out), j_kernel, atol=tol, rtol=tol)


@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.bfloat16])
def test_flash_matches_jax_at_recurrentgemma_heads(jdtype):
    """recurrentgemma's local attention: 16 query heads on 1 KV head,
    head_dim 256, causal within a window (128 here, so it bites at S
    256), which the CUDA kernel runs at D 256 on the card."""
    (jq, jk, jv), (q, k, v) = make_inputs(1, 16, 1, 256, 256, 256, jdtype)
    kw = dict(causal=True, window=128)
    j_ref = as_np(jax_attention_ref(jq, jk, jv, **kw))
    j_kernel = as_np(jax_flash_op(jq, jk, jv, block_q=128, block_k=128,
                                  impl="interpret", **kw))
    tol = TOLS[q.dtype]
    assert 256 in kernel.HEAD_DIMS
    out = flash_attention_op(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(as_np(out), j_ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(as_np(out), j_kernel, atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_flash_right_aligns_queries_when_sq_lt_sk(causal, window):
    """Sq < Sk: query row i sits at position i + Sk - Sq, as in the JAX
    ``attention_ref`` (the Pallas kernel counts from 0 and agrees only at
    Sq == Sk, so it is not compared here)."""
    (jq, jk, jv), (q, k, v) = make_inputs(2, 6, 2, 40, 136, 64, jnp.float32)
    kw = dict(causal=causal, window=window)
    want = as_np(jax_attention_ref(jq, jk, jv, **kw))
    got = as_np(flash_attention_op(q, k, v, **kw))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    """The kernel wrapper never runs a plain version: a CPU tensor is an
    error there, and only a launch adds to its count."""
    _, (q, k, v) = make_inputs(1, 2, 1, 64, 64, 64, jnp.float32)
    before = kernel.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention(q, k, v)
    assert kernel.flash_attention.launches == before


def test_flash_op_rejects_unknown_impl():
    _, (q, k, v) = make_inputs(1, 2, 1, 64, 64, 64, jnp.float32)
    with pytest.raises(ValueError, match="impl"):
        flash_attention_op(q, k, v, impl="pallas")


@pytest.mark.parametrize("b,h,s,d", [(4, 9, 512, 64), (4, 16, 512, 256),
                                     (1, 3, 1000, 32)])
def test_kernel_output_buffer_is_the_models_layout(b, h, s, d):
    """The kernel writes its (B, H, S, D) output through strides into a
    (B, S, H, D) buffer: transposed back, as the model does, it is
    contiguous, so the o-projection's reshape copies nothing."""
    q = torch.empty((b, h, s, d), dtype=torch.bfloat16)
    out = kernel.output_buffer(q)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.stride() == (s * h * d, d, h * d, 1)
    model_view = out.transpose(1, 2)
    assert model_view.is_contiguous()
    assert model_view.reshape(b, s, h * d).data_ptr() == out.data_ptr()
    # TMA: every stride of the buffer is a multiple of 16 bytes
    assert all(st * out.element_size() % 16 == 0 for st in out.stride()[:3])


# -- the backward -----------------------------------------------------------------

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_lse)

# (b, h, kv, sq, sk, d, causal, window, softcap): test_kernels' FLASH_CASES
# (all in fp32 here), and right-aligned queries with Sq < Sk, a window
# without the causal mask, and a ragged S
BWD_CASES = [case[:4] + (case[3],) + case[4:8] for case in FLASH_CASES] + [
    (2, 6, 2, 40, 136, 64, True, None, None),
    (1, 4, 2, 100, 260, 64, False, 70, None),
    (1, 3, 1, 100, 100, 32, True, 30, 20.0),
]
# fp32 on both sides, sums in another order: max-normalised per gradient
BWD_TOL = 1e-5


def bwd_inputs(b, h, kv, sq, sk, d, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d),
                          (b, h, sq, d))]


def max_norm_err(got, want):
    return float(np.abs(as_np(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window,softcap", BWD_CASES)
def test_attention_bwd_matches_jax_grad(b, h, kv, sq, sk, d, causal, window,
                                        softcap):
    """dq, dk and dv three ways against ``jax.vjp`` of the reference's
    ``attention_ref``: torch autograd of the port's ``attention_ref``, the
    dispatching op under autograd (the plain path on the CPU), and
    ``attention_bwd_ref``'s decomposition (P from the log-sum-exp, delta =
    rowsum(dO * O)), which the backward kernel follows."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, do = bwd_inputs(b, h, kv, sq, sk, d)
    _, vjp = jax.vjp(lambda q, k, v: jax_attention_ref(q, k, v, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    for fn in (attention_ref, flash_attention_op):
        leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
        out = fn(*leaves, **kw)
        got = torch.autograd.grad(out, leaves, tdo)
        for g, w in zip(got, want):
            assert max_norm_err(g, w) < BWD_TOL
    out = attention_ref(tq, tk, tv, **kw)
    lse = attention_lse(tq, tk, **kw)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    got = attention_bwd_ref(tq, tk, tv, out, lse, tdo, **kw)
    for g, w, x in zip(got, want, (tq, tk, tv)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert max_norm_err(g, w) < BWD_TOL


def test_attention_lse_is_the_rows_logsumexp():
    """The log-sum-exp the forward kernel writes: log sum_j exp(s_ij) over
    the keys row i sees, of the scaled, capped scores, here against numpy
    on the same inputs (float64)."""
    q, k, _, _ = bwd_inputs(1, 4, 2, 50, 70, 32)
    softcap, window = 5.0, 20
    s = np.einsum("bkgqd,bksd->bkgqs", q.reshape(1, 2, 2, 50, 32).astype(
        np.float64), k.astype(np.float64)) / np.sqrt(32)
    s = softcap * np.tanh(s / softcap)
    qpos = np.arange(50)[:, None] + 20
    kpos = np.arange(70)[None, :]
    seen = (qpos >= kpos) & (qpos - kpos < window)
    s = np.where(seen, s, -np.inf)
    want = np.log(np.exp(s).sum(-1)).reshape(1, 4, 50)
    got = attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                        causal=True, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_flash_op_autograd_function_wires_both_kernels(monkeypatch):
    """The ``flash_attention_fwd`` op (what a CUDA tensor under autograd
    goes through): it asks the forward kernel for the log-sum-exp and saves
    what the backward kernel takes; its registered gradient passes the
    options on to the ``flash_attention_bwd`` op and returns the three
    gradients. The kernels are stood in for by the plain
    versions here (they run only on the card), and the gradients equal
    autograd of ``attention_ref``."""
    calls = []

    def fake_fwd(q, k, v, *, return_lse, **kw):
        calls.append(("fwd", return_lse, kw))
        return attention_ref(q, k, v, **kw), attention_lse(q, k, **kw)

    def fake_bwd(q, k, v, o, lse, do, **kw):
        calls.append(("bwd", kw))
        return attention_bwd_ref(q, k, v, o, lse, do, **kw)

    monkeypatch.setattr(ops, "flash_attention", fake_fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd", fake_bwd)
    kw = dict(causal=True, window=40, softcap=30.0)
    q, k, v, do = (torch.from_numpy(x) for x in
                   bwd_inputs(2, 6, 2, 64, 64, 32))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_fwd_op(*leaves, kw["causal"], kw["window"],
                           kw["softcap"], True)[0]
    # a non-contiguous output gradient, as the model's transposes give
    got = torch.autograd.grad(out, leaves, do.transpose(1, 2).contiguous()
                              .transpose(1, 2))
    assert calls == [("fwd", True, kw), ("bwd", kw)]
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref_leaves, **kw), ref_leaves,
                               do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_backward_wrapper_refuses_cpu_tensors_and_counts_nothing():
    q, k, v, do = (torch.from_numpy(x) for x in bwd_inputs(1, 2, 1, 64, 64,
                                                           64))
    lse = attention_lse(q, k)
    before = kernel.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention_bwd(q, k, v, attention_ref(q, k, v), lse, do)
    assert kernel.flash_attention_bwd.launches == before
