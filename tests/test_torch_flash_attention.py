"""The port's flash attention (plain version and dispatching wrapper) against
the JAX reference: ``attention_ref`` and the Pallas kernel in interpret
mode, on the same numpy inputs.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
