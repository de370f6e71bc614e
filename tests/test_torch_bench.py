"""CPU checks of the kernel bench's arithmetic and interface tables.

The bench (``repro_torch.kernels.bench``) times the kernels on the card; what
it computes without one is checked here: the bounds at the recorded shapes,
the C interface versions and argument counts it calls older libraries by,
the backward's workspace size, and how it reports a row.
"""
import ctypes
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bench, work  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.kernels.reshard import kernel as box  # noqa: E402
from repro_torch.kernels.rglru import kernel as rglru  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd  # noqa: E402

CSRC = Path(flash.__file__).resolve().parents[1]


def test_backward_bound_at_the_train_shape():
    """B8 H9 KV3 S2048 D64 bf16 causal: five products of 2 D flops per
    visible (query, key) pair, 9.67e10 flop, bound by operations at 989
    TFLOP/s: 0.0978 ms."""
    b, h, kv, s, d, _, window, softcap = bench.BWD_SHAPES["train-2048"]
    assert window is None and softcap is None
    ms, by, flops = bench.attention_bwd_bound(b, h, kv, s, s, d,
                                              torch.bfloat16)
    pairs = s * (s + 1) // 2
    assert flops == 5 * 2 * d * b * h * pairs
    assert flops == pytest.approx(9.67e10, rel=1e-3)
    assert by == "operations"
    assert ms == pytest.approx(0.0978, abs=5e-5)
    # the bytes it must move (q, k, v, o, do read, dq, dk, dv written, the
    # fp32 lse, 101 MB) would take under a third of that
    nbytes = 2 * (4 * b * h * s * d + 4 * b * kv * s * d) + 4 * b * h * s
    assert 1e3 * nbytes / bench.PEAK_BYTES < ms / 3


def test_backward_bound_at_qwen3_train_shape():
    """qwen3-4b's bf16 train step, B2 H32 KV8 S4096 D128 causal: 6.87e11
    flop, bound by operations at 989 TFLOP/s: 0.695 ms; the 672 MB it
    must move would take 0.20 ms."""
    b, h, kv, s, d, _, window, softcap = bench.BWD_SHAPES["qwen3-4096"]
    assert (b, h, kv, s, d, window, softcap) == (2, 32, 8, 4096, 128, None,
                                                 None)
    ms, by, flops = bench.attention_bwd_bound(b, h, kv, s, s, d,
                                              torch.bfloat16)
    assert flops == 5 * 2 * d * b * h * (s * (s + 1) // 2)
    assert flops == pytest.approx(6.874e11, rel=1e-3)
    assert by == "operations"
    assert ms == pytest.approx(0.6950, abs=5e-5)
    nbytes = 2 * (4 * b * h * s * d + 4 * b * kv * s * d) + 4 * b * h * s
    assert nbytes == pytest.approx(336.6e6, rel=1e-3)

@pytest.mark.parametrize("label,want_ms", [("qwen3-4096", 0.2780),
                                           ("qwen3-tp2-4096", 0.1390),
                                           ("recurrentgemma-4096", 0.1042)])
def test_forward_bound_at_the_train_calls(label, want_ms):
    """The flash forward at the two train steps' calls, beside the
    backward's cells: qwen3-4b's B2 H32 KV8 S4096 D128 causal (2.75e11
    flop) and recurrentgemma-9b's B1 H16 KV1 S4096 D256 within its window
    of 2048 (1.03e11), each bound by operations at 989 TFLOP/s. The window
    bites there, so the library call takes it as an explicit mask."""
    b, h, kv, s, d, layout, window, softcap = bench.SHAPES[label]
    assert (b, h, kv, s, d, window, softcap) == bench.BWD_SHAPES[label][:5] \
        + bench.BWD_SHAPES[label][6:]
    assert bench.flash_call(label) == (b, h, kv, s, s, d, layout, True,
                                       window, softcap)
    ms, by, flops = bench.attention_bound(b, h, kv, s, s, d, torch.bfloat16,
                                          window=window)
    lags = torch.arange(s)[:, None] - torch.arange(s)[None, :]
    seen = (lags >= 0) & (lags < (window or s))
    assert flops == 4 * d * b * h * int(seen.sum())
    assert flops * 2.5 == bench.attention_bwd_bound(
        b, h, kv, s, s, d, torch.bfloat16, window=window)[2]
    assert by == "operations"
    assert ms == pytest.approx(want_ms, abs=5e-5)
    row = dict(label=label, ms=2 * ms, tflops=1.0, plain_ms=1.0,
               library_ms=ms, bound_ms=ms, bound_by=by, eager_ms=1.0,
               library_backend="CUDNN_ATTENTION")
    text = bench.describe(row)
    assert "kernel/bound 2.00x" in text and "kernel/library 2.00x" in text
    assert ("explicit mask" in text) == (window is not None)


@pytest.mark.parametrize("label,fwd_ms,bwd_ms,by", [
    ("gemma2-4352", 0.1564, 0.3909, "operations"),
    ("paligemma-train-512", 0.0113, 0.0226, "bytes"),
    ("granite-4096", 0.1390, 0.3475, "operations")])
def test_bounds_at_the_zoo_train_calls(label, fwd_ms, bwd_ms, by):
    """The flash calls of gemma2-27b's, paligemma-3b's and granite-3-2b's
    train steps: gemma2's local layer B1 H32 KV16 S4352 D128 within its
    window of 4096 (9,439,232 pairs a head) with its scores capped at 50,
    paligemma's B8 H8 KV1 S512 D256 (bound by its 37.7 MB of bytes: one KV
    head for 8 query heads), granite's B2 H32 KV8 S4096 D64. The softcap's
    fp32 operations (3 a pair and head forward, 5 backward: 9.06e8, 0.0135
    ms at 67 TFLOP/s) stay under the products' time, so the products bound
    gemma2's call; forward and backward take the same shape."""
    b, h, kv, s, d, layout, window, softcap = bench.SHAPES[label]
    assert bench.BWD_SHAPES[label] == bench.SHAPES[label]
    assert layout == "bshd"
    ms, got_by, flops = bench.attention_bound(
        b, h, kv, s, s, d, torch.bfloat16, window=window, softcap=softcap)
    bms, bwd_by, _ = bench.attention_bwd_bound(
        b, h, kv, s, s, d, torch.bfloat16, window=window, softcap=softcap)
    assert ms == pytest.approx(fwd_ms, abs=5e-5)
    assert bms == pytest.approx(bwd_ms, abs=5e-5)
    assert got_by == bwd_by == by
    pairs = work.attention_pairs(s, s, True, window)
    assert flops == 4 * d * b * h * pairs
    if softcap is None:
        assert bench.attention_bound(b, h, kv, s, s, d, torch.bfloat16,
                                     window=window)[0] == ms
        return
    assert (window, softcap) == (4096, 50.0)
    assert pairs == 9_439_232
    cap = work.softcap_ops(b, h, s, s, True, window)
    assert cap == 3 * b * h * pairs
    assert work.softcap_ops(b, h, s, s, True, window, backward=True) == \
        5 * b * h * pairs
    assert 1e3 * cap / bench.PEAK_FP32_FLOPS == pytest.approx(0.0135,
                                                              abs=5e-5)
    # a cap that took longer than the products would bound the call
    assert bench.capped(0.001, "bytes", cap) == (
        1e3 * cap / bench.PEAK_FP32_FLOPS, "operations")


def test_describe_names_flex_attention_for_a_softcapped_call():
    """With a softcap the library column is flex_attention's time, its
    distance from the plain version beside it, and kernel / library is
    taken from it."""
    row = dict(label="gemma2-4352", ms=0.3, tflops=515.0, plain_ms=30.0,
               library_ms=0.6, library_backend="flex_attention",
               library_err=3.9e-3, bound_ms=0.1564,
               bound_by="operations", eager_ms=0.35)
    text = bench.describe(row)
    assert "window 4096 softcap 50" in text
    assert "flex_attention (torch.compile, the softcap its score_mod; " \
        "3.900e-03 from plain, max-normalised) 0.6000 ms" in text
    assert "kernel/bound 1.92x" in text and "kernel/library 0.50x" in text
    row.update(library_eager_ms=0.7, bound_ms=0.3909)
    text = bench.describe_bwd(row)
    assert "causal window 4096 softcap 50" in text
    assert "the backward of flex_attention" in text
    assert "kernel/library 0.50x" in text and "library 0.7000 ms" in text


@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window,softcap", [
    (2, 4, 2, 40, 40, 16, True, 8, 5.0),
    (1, 4, 2, 136, 136, 16, True, 100, 50.0),
    (1, 4, 1, 24, 40, 32, True, None, 3.0),
    (1, 2, 2, 24, 40, 16, False, None, 2.0)])
def test_flex_library_computes_the_kernels_function(b, h, kv, sq, sk, d,
                                                    causal, window,
                                                    softcap):
    """The softcapped calls' library yardstick computes what the kernel
    does (attention_ref): the cap as a score_mod, the causal and window
    mask with the query rows right-aligned to the keys, GQA; and a window
    one key narrower does not."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, h, sq, d, generator=gen)
    k, v = (torch.randn(b, kv, sk, d, generator=gen) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = attention_ref(q, k, v, **kw)
    got = bench.flex_library(q, k, v, **kw)(q, k, v)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    if window is not None:
        kw["window"] = window - 1
        assert (bench.flex_library(q, k, v, **kw)(q, k, v)
                - want).abs().max() > 1e-3


def test_rglru_bound_at_the_prefill_shape():
    """B4 S512 W4096 fp32: a and b read, h written, 100.7 MB, bound by
    bytes at 3.35 TB/s: 0.030 ms."""
    b, s, w = bench.RGLRU_SHAPES["prefill-512"]
    ms, by, flops = bench.rglru_bound(b, s, w)
    nbytes = 3 * 4 * b * s * w
    assert nbytes == pytest.approx(100.7e6, rel=1e-3)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / bench.PEAK_BYTES)
    assert ms == pytest.approx(0.0300, abs=1e-4)
    assert flops == 2 * b * s * w


def test_windowed_backward_bound_counts_the_window():
    """recurrentgemma-9b's local layers at B1 S4096, window 2048: each
    query sees at most 2048 keys, so the pairs are the causal triangle's
    less the (2048 x 2049 / 2) the window cuts off."""
    b, h, kv, s, d, _, window, _ = bench.BWD_SHAPES["recurrentgemma-4096"]
    assert window == 2048 and s == 2 * window
    _, _, flops = bench.attention_bwd_bound(b, h, kv, s, s, d,
                                            torch.bfloat16, window=window)
    pairs = s * (s + 1) // 2 - (s - window) * (s - window + 1) // 2
    assert flops == 5 * 2 * d * b * h * pairs


def test_ssd_bwd_bound_at_the_train_shape():
    """B8 S2048 H24 P64 N128 bf16: x, dy and dx, B, C, dB and dC, dt and
    ddt once, 170.9 MB, 0.0510 ms at 3.35 TB/s; its least products (45.1
    GFLOP) take 0.0456 ms at 989 TFLOP/s: bound by bytes."""
    b, s, h, p, n, chunk, layout = bench.SSD_BWD_SHAPES["train-2048"]
    assert layout == "view"
    ms, by, flops = bench.ssd_bwd_bound(b, s, h, p, n, chunk,
                                        torch.bfloat16)
    nbytes = 2 * (3 * b * s * h * p + 4 * b * s * n) + 4 * (2 * b * s * h
                                                            + 2 * h)
    assert nbytes == 170_918_080
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / bench.PEAK_BYTES)
    assert flops == pytest.approx(45.1e9, rel=1e-3)


def test_rglru_bwd_bound_at_the_train_shape():
    """B1 S4096 W4096 fp32: a, h and dh read, da and db written, 335.5 MB,
    bound by bytes: 0.1002 ms."""
    b, s, w = bench.RGLRU_BWD_SHAPES["train-4096"]
    ms, by, flops = bench.rglru_bwd_bound(b, s, w)
    assert 5 * 4 * b * s * w == pytest.approx(335.5e6, rel=1e-3)
    assert by == "bytes" and flops == 3 * b * s * w
    assert ms == pytest.approx(0.1002, abs=1e-4)


@pytest.mark.parametrize("s, chunk, dtype", [
    (2048, 128, torch.bfloat16), (2048, 128, torch.float32),
    (500, 128, torch.float32), (1, 128, torch.bfloat16)])
def test_ssd_bwd_workspace_holds_the_backward_buffers(s, chunk, dtype):
    """Per (batch, chunk, head) a P x N fp32 state-gradient share and an
    fp64 da_log share; for bf16 dh_out in bf16 besides and nothing per row
    (dB and dC are summed over the heads on chip); for fp32 per (batch, row,
    head) an fp64 row less column sum of M, the carried term and the
    per-head dB and dC rows. The version-1 source's (bench.py's
    old_ssd_bwd_workspace_numel) held an fp32 incoming state and the rows
    for bf16 too."""
    b, h, p, n = 8, 24, 64, 128
    slots = b * math.ceil(s / chunk) * h
    rows = b * s * h
    per_row = 2 * rows + rows + 2 * rows * n
    want = slots * p * n + 2 * slots
    if dtype == torch.bfloat16:
        want += slots * p * n // 2
    else:
        want += per_row
    assert ssd.bwd_workspace_numel(b, s, h, p, n, chunk, dtype) == want
    old_states = slots * p * n * (2 if dtype == torch.bfloat16 else 1)
    assert bench.old_ssd_bwd_workspace_numel(b, s, h, p, n, chunk, dtype) \
        == old_states + 2 * slots + per_row
    if dtype == torch.float32:  # the fp32 route's layout is version 1's
        assert want == bench.old_ssd_bwd_workspace_numel(b, s, h, p, n,
                                                         chunk, dtype)


def test_describe_scan_backwards_compare_with_their_bounds():
    row = dict(label="train-2048", ms=2.0, tflops=0.02, cuda_kernels=7,
               plain_ms=900.0, library_ms=None, bound_ms=0.0510,
               bound_by="bytes", eager_ms=2.1,
               passes=[("chunk_db", 0.8, 1), ("chunk_dc", 0.7, 1)])
    text = bench.describe_ssd_bwd(row)
    assert "7 CUDA kernels a call" in text and "library call none" in text
    assert "kernel/bound 39.22x" in text
    assert text.endswith("chunk_db 0.8000 ms x1; chunk_dc 0.7000 ms x1")
    row = dict(label="train-4096", ms=0.2, gbps=1677.0, plain_ms=300.0,
               library_ms=None, bound_ms=0.1002, bound_by="bytes",
               eager_ms=0.25)
    assert "kernel/bound 2.00x" in bench.describe_rglru_bwd(row)


@pytest.mark.parametrize("key, count", [
    (("flash_attention", 1), 25),
    (("flash_attention", 2), 28),
    (("ssd_scan", 1), 25),
    (("flash_attention_bwd", 1), 46),
    (("flash_attention_bwd", 2), 46),
    (("ssd_scan_bwd", 1), 35),
    (("rglru_scan_bwd", 1), 15),
])
def test_old_interface_argument_counts(key, count):
    assert len(bench.OLD_ARGTYPES[key]) == count


@pytest.mark.parametrize("name, argtypes, count", [
    ("flash_attention", flash._ARGTYPES, 29),
    ("flash_attention_bwd", flash._BWD_ARGTYPES, 47),
    ("ssd_scan", ssd._ARGTYPES, None),
    ("rglru_scan", rglru._ARGTYPES, 12),
    ("ssd_scan_bwd", ssd._BWD_ARGTYPES, 35),
    ("rglru_scan_bwd", rglru._BWD_ARGTYPES, 16),
])
def test_current_interfaces_are_newer_than_every_old_one(name, argtypes,
                                                         count):
    """The wrappers call version CURRENT[name] (1 for a source that exports
    no version); every entry of OLD_ARGTYPES is older. The SSD backward's
    version 1 takes the same arguments as version 2 (only its workspace
    changed); the flash backward's versions 1 and 2 take those of version 3
    less ``splits`` (an int before the stream); the RG-LRU backward's
    version 1 those of version 2 less the workspace (after dh0)."""
    current = bench.CURRENT.get(name, 1)
    assert all(v < current for n, v in bench.OLD_ARGTYPES if n == name)
    if count is not None:
        assert len(argtypes) == count
    old = bench.OLD_ARGTYPES
    if name == "ssd_scan_bwd":
        assert old[name, 1] == tuple(argtypes)
    if name == "flash_attention_bwd":
        assert argtypes[-2] is ctypes.c_int
        assert old[name, 1] == old[name, 2] == (*argtypes[:-2], argtypes[-1])
    if name == "rglru_scan_bwd":
        assert argtypes[7] is ctypes.c_void_p
        assert old[name, 1] == (*argtypes[:7], *argtypes[8:])
    assert name in bench.ENTRY


@pytest.mark.parametrize("source, name", [
    ("flash_attention/csrc/flash_attention.cu", "flash_attention"),
    ("flash_attention/csrc/flash_attention_bwd.cu", "flash_attention_bwd"),
    ("ssd/csrc/ssd_scan.cu", "ssd_scan"),
    ("ssd/csrc/ssd_scan_bwd.cu", "ssd_scan_bwd"),
    ("rglru/csrc/rglru_scan.cu", "rglru_scan_bwd"),
])
def test_sources_export_the_versions_the_bench_expects(source, name):
    text = (CSRC / source).read_text()
    found = re.search(rf"int {name}_abi\(void\) {{ return (\d+); }}", text)
    assert found and int(found.group(1)) == bench.CURRENT[name]
    assert f"{bench.ENTRY[name]}(" in text


class _Library:
    """A stand-in for a loaded library: the C entry points as attributes."""

    def __init__(self, *entries, abi=None):
        for entry in entries:
            setattr(self, entry, lambda *args: 0)
        if abi is not None:
            name, version = abi
            setattr(self, f"{name}_abi", lambda: version)


@pytest.mark.parametrize("entries, name", [
    (("ssd_scan_fwd", "ssd_scan_error_string"), "ssd_scan"),
    (("ssd_scan_bwd", "ssd_scan_bwd_error_string"), "ssd_scan_bwd"),
    (("rglru_scan_fwd", "rglru_scan_bwd"), "rglru_scan"),
    (("flash_attention_bwd",), "flash_attention_bwd"),
    (("flash_attention_fwd",), "flash_attention"),
])
def test_compare_dispatches_on_the_exported_entry(entries, name):
    """``--against`` names the kernel of a library by its entry point: a
    library built from ssd_scan_bwd.cu exports none of the forward's or the
    flash backward's and is the SSD backward, not the flash forward."""
    assert bench.kernel_of(_Library(*entries)) == name


@pytest.mark.parametrize("version, current", [(1, False), (2, True)])
def test_ssd_backward_versions_are_told_apart(version, current):
    """The version-1 source (fp32 rows per head) is called with its own
    workspace; the current one, version 2, through the wrapper's."""
    lib = _Library("ssd_scan_bwd", abi=("ssd_scan_bwd", version))
    assert bench.kernel_of(lib) == "ssd_scan_bwd"
    assert bench.interface_version(lib, "ssd_scan_bwd") == version
    assert (version == bench.CURRENT["ssd_scan_bwd"]) == current
    assert current or ("ssd_scan_bwd", version) in bench.OLD_ARGTYPES


def test_rglru_source_exports_no_version():
    text = (CSRC / "rglru/csrc/rglru_scan.cu").read_text()
    assert "rglru_scan_abi" not in text
    assert "int rglru_scan_fwd(" in text


@pytest.mark.parametrize("source, entry, count", [
    ("ssd/csrc/ssd_scan_bwd.cu", "ssd_scan_bwd", 35),
    ("rglru/csrc/rglru_scan.cu", "rglru_scan_bwd", 16),
    ("flash_attention/csrc/flash_attention_bwd.cu", "flash_attention_bwd",
     47),
])
def test_backward_entries_take_what_the_wrappers_pass(source, entry, count):
    """The C signature of each backward has as many parameters as its
    wrapper declares argument types."""
    text = (CSRC / source).read_text()
    sig = re.search(rf"int {entry}\(([^)]*)\)", text).group(1)
    assert len(sig.split(",")) == count


@pytest.mark.parametrize("b, h, sq, d", [
    (8, 9, 2048, 64), (1, 3, 1000, 64), (2, 6, 300, 128), (1, 16, 37, 256),
    (1, 1, 1, 32)])
def test_bwd_workspace_holds_tiles_of_sums_and_records(b, h, sq, d):
    """Per 64-row query tile (rows past Sq included): 64 x D fp32 sums of
    dQ and a record of 64 lse and 64 delta."""
    tiles = b * h * math.ceil(sq / 64)
    assert flash.bwd_workspace_numel(b, h, sq, d) == tiles * (64 * d + 128)
    assert bench.old_bwd_workspace_numel(b, h, sq, d) == b * h * sq * (d + 1)


def test_bwd_workspace_at_the_train_shape():
    assert flash.bwd_workspace_numel(8, 9, 2048, 64) == 9_732_096


def test_describe_bwd_compares_device_times():
    """kernel / library is taken from the two device times; the eager
    library call is reported beside it, named as eager."""
    row = dict(label="train-2048", ms=0.3, tflops=322.3, plain_ms=8.2,
               library_ms=0.4, library_eager_ms=0.5,
               library_backend="FLASH_ATTENTION", bound_ms=0.0978,
               bound_by="operations", eager_ms=0.35)
    text = bench.describe_bwd(row)
    assert "kernel/library 0.75x (device times)" in text
    assert "library 0.5000 ms" in text and "FLASH_ATTENTION" in text
    assert "kernel/bound 3.07x" in text


def test_ptxas_report_reads_registers_spills_and_wgmma_notes():
    log = """ptxas info    : Compiling entry function '_Z3fooi' for 'sm_90a'
ptxas info    : Function properties for _Z3fooi
    8 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized
ptxas info    : Used 40 registers
"""
    report = bench.ptxas_report(log)
    assert report[:2] == ["_Z3fooi: 168 registers, 16 bytes spill stores",
                          "_Z3barv: 40 registers, 0 bytes spill stores"]
    assert len(report) == 3 and "wgmma.mma_async" in report[2]


@pytest.mark.parametrize("b, h, kv, sk, d, dtype, want", [
    # recurrentgemma-9b's train call: 64 key tiles, 7 blocks each (448)
    (1, 16, 1, 4096, 256, torch.bfloat16, 7),
    # paligemma-3b's prefill shape: 4 x 8 key tiles; 8 query heads at most
    (4, 8, 1, 512, 256, torch.bfloat16, 8),
    # enough key tiles already: one block each
    (8, 16, 2, 4096, 256, torch.bfloat16, 1),
    # a ragged Sk rounds its key tiles up
    (2, 16, 1, 1000, 256, torch.bfloat16, 13),
    # the other routes take no splits
    (1, 16, 1, 4096, 256, torch.float32, 1),
    (1, 16, 1, 4096, 128, torch.bfloat16, 1),
    (8, 9, 3, 2048, 64, torch.bfloat16, 1),
])
def test_bwd_splits_fill_the_card_at_d256(b, h, kv, sk, d, dtype, want):
    """The D 256 route shares a key tile's items between enough blocks for
    about three an SM (one block fits an SM at a time), at most the group's
    heads."""
    got = flash.bwd_splits(b, h, kv, sk, d, dtype)
    assert got == want
    tiles = b * kv * math.ceil(sk / 64)
    if got > 1:
        assert got <= h // kv
        assert tiles * got >= flash.BWD_BLOCKS or got == h // kv
        assert tiles * (got - 1) < flash.BWD_BLOCKS


def test_bwd_workspace_grows_by_the_partials_of_the_splits():
    """At recurrentgemma's train call the workspace holds dQ's sums and the
    records, then 7 splits' fp32 dK and dV partials, 58.7 MB; one split
    adds nothing."""
    b, h, kv, s, d = 1, 16, 1, 4096, 256
    splits = flash.bwd_splits(b, h, kv, s, d, torch.bfloat16)
    assert flash.bwd_partials_numel(splits, b, kv, s, d) == \
        2 * 7 * 4096 * 256
    assert 4 * flash.bwd_partials_numel(splits, b, kv, s, d) == 58_720_256
    assert flash.bwd_partials_numel(1, b, kv, s, d) == 0
    assert flash.bwd_workspace_numel(b, h, s, d) == 16 * 64 * 64 * 258


@pytest.mark.parametrize("b, s, w", [
    (1, 4096, 4096), (4, 512, 4096), (2, 37, 1000), (2, 1, 4096),
    (1, 129, 3)])
def test_rglru_bwd_workspace_holds_flagged_chunk_records(b, s, w):
    """Per (batch, chunk of 128 steps, channel) the aggregate's two values
    and the inclusive carry, each a 64-bit word with its flag."""
    chunks = math.ceil(s / 128)
    assert rglru.BWD_CHUNK == 128
    assert rglru.bwd_workspace_numel(b, s, w) == 6 * b * chunks * w


def test_rglru_bound_at_the_train_shape():
    """recurrentgemma-9b's train step calls the RG-LRU forward at B1 S4096
    W4096: a and b read, h written, 201.3 MB, 0.0601 ms at 3.35 TB/s."""
    b, s, w = bench.RGLRU_SHAPES["train-4096"]
    assert (b, s, w) == bench.RGLRU_BWD_SHAPES["train-4096"]
    ms, by, _ = bench.rglru_bound(b, s, w)
    assert by == "bytes"
    assert ms == pytest.approx(0.0601, abs=1e-4)


@pytest.mark.parametrize("exports, version", [
    ((), 1), ((("rglru_scan_bwd", 2),), 2)])
def test_rglru_backward_versions_are_told_apart(exports, version):
    """An RG-LRU library is the forward's (``kernel_of``); its backward's
    version is read from ``rglru_scan_bwd_abi`` (none: version 1, called by
    ``launch_old`` without a workspace)."""
    lib = _Library("rglru_scan_fwd", "rglru_scan_bwd",
                   abi=exports[0] if exports else None)
    assert bench.kernel_of(lib) == "rglru_scan"
    assert bench.interface_version(lib, "rglru_scan") == 1
    assert bench.interface_version(lib, "rglru_scan_bwd") == version
    current = version == bench.CURRENT["rglru_scan_bwd"]
    assert current or ("rglru_scan_bwd", version) in bench.OLD_ARGTYPES
    assert bench.ERROR_STRING["rglru_scan_bwd"] == "rglru_scan_error_string"


@pytest.mark.parametrize("top,ok", [
    ([("chunk_dstate_bf16", 0.1, 1), ("state_pass", 0.02, 1),
      ("chunk_bwd_bf16", 0.5, 1), ("reduce_alog", 0.01, 1),
      ("Memcpy DtoD (Device -> Device)", 0.01, 1)], True),
    # a kernel the profiler listed without its device time
    ([("chunk_dstate_bf16", 0.0, 1), ("state_pass", 0.02, 1),
      ("chunk_bwd_bf16", 0.5, 1), ("reduce_alog", 0.01, 1)], False),
    # a kernel it did not list at all (3 of the route's 4)
    ([("state_pass", 0.02, 1), ("chunk_bwd_bf16", 0.5, 1),
      ("reduce_alog", 0.01, 1)], False)])
def test_split_kernels_fails_on_a_partly_blank_profile(monkeypatch, top, ok):
    """A phase that splits a call into its CUDA kernels takes the route's
    count (the SSD backward's four in bf16) and fails where one comes back
    without device time, or not at all; copies do not count."""
    monkeypatch.setattr(bench, "device_profile",
                        lambda fn, top_=None, **kw: {"top": top})
    want = bench.SSD_BWD_KERNELS
    if ok:
        assert len(bench.split_kernels(lambda: None, want, "ssd_scan_bwd")) \
            == want
    else:
        with pytest.raises(RuntimeError, match="route launches 4"):
            bench.split_kernels(lambda: None, want, "ssd_scan_bwd")


# -- every busy reading holds its interval to the wrappers' launches --------

# CUDA kernel names as the profiler lists them
FWD = ("void (anonymous namespace)::flash_fwd_bf16<64>((anonymous "
       "namespace)::Maps, (anonymous namespace)::Params)")
BWD = tuple(f"void (anonymous namespace)::{name}<__nv_bfloat16, 64>"
            f"((anonymous namespace)::Params)"
            for name in ("flash_bwd_delta", "flash_bwd_dq")) + (
    "void (anonymous namespace)::flash_bwd_wgmma<64>((anonymous "
    "namespace)::Maps, (anonymous namespace)::Params)",)
OTHERS = ("Memcpy DtoD (Device -> Device)",
          "void at::native::vectorized_elementwise_kernel<4, at::native::"
          "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
          "FillFunctor<float>, std::array<char*, 1ul>)")


def step_launches():
    """What a bf16 D 64 forward and backward put on the stream."""
    return bench.Counter(flash.cuda_kernels(torch.bfloat16)
                         + flash.bwd_cuda_kernels(torch.bfloat16, 64, 1))


@pytest.mark.parametrize("events,match", [
    # every counted launch listed, each with device time; copies and
    # PyTorch's kernels beside them
    ([(FWD, 0.14), *((n, 0.1) for n in BWD), *((n, 0.01) for n in OTHERS)],
     None),
    # a counted launch missing (the backward's delta)
    ([(FWD, 0.14), *((n, 0.1) for n in BWD[1:]), (OTHERS[0], 0.01)],
     "lists the port's CUDA kernels"),
    # one listed without device time
    ([(FWD, 0.0), *((n, 0.1) for n in BWD)], "1 of them without device"),
    # one listed more often than the wrappers launched it (a stale event)
    ([(FWD, 0.14), (FWD, 0.14), *((n, 0.1) for n in BWD)],
     "lists the port's CUDA kernels"),
    # an interval without any device event
    ([], "holds no device event")])
def test_check_profile_holds_an_interval_to_its_launches(events, match):
    """A busy reading's interval must list each CUDA kernel the wrappers
    launched in it, by name and as often, each with device time, and hold
    at least one device event; anything else fails the reading."""
    if match is None:
        bench.check_profile(events, step_launches(), "a step")
    else:
        with pytest.raises(RuntimeError, match=match):
            bench.check_profile(events, step_launches(), "a step")


def test_check_profile_counts_a_name_two_routes_share():
    """The SSD forward's and backward's ``state_pass`` share a name: a step
    that runs both lists it twice."""
    launched = bench.Counter(ssd.cuda_kernels(torch.bfloat16)
                             + ssd.bwd_cuda_kernels(torch.bfloat16))
    names = [*ssd.cuda_kernels(torch.bfloat16),
             *ssd.bwd_cuda_kernels(torch.bfloat16)]
    events = [(f"(anonymous namespace)::{n}((anonymous namespace)::Params)",
               0.05) for n in names]
    bench.check_profile(events, launched, "an SSD step")
    with pytest.raises(RuntimeError, match="state_pass"):
        bench.check_profile(events[:-1], launched + bench.Counter(
            ["state_pass"]), "an SSD step")


def test_base_name_of_the_profilers_names():
    assert [bench.base_name(n) for n in (FWD, *BWD, *OTHERS)] == [
        "flash_fwd_bf16", "flash_bwd_delta", "flash_bwd_dq",
        "flash_bwd_wgmma", "Memcpy", "vectorized_elementwise_kernel"]


def _globals(source):
    text = Path(source).read_text()
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*"
                          r"\)\s*)?(\w+)\s*\(", text))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routes_name_their_sources_kernels(dtype):
    """Each wrapper's route names CUDA kernels its source defines, as many
    as the split of a call takes (bench's counts), and bench's set of the
    port's kernels holds them all."""
    fwd = _globals(flash.SOURCE)
    bwd = _globals(flash.BWD_SOURCE)
    assert set(flash.cuda_kernels(dtype)) <= fwd
    for d in flash.HEAD_DIMS:
        for splits in (1, 2):
            route = flash.bwd_cuda_kernels(dtype, d, splits)
            assert set(route) <= bwd
            wide = dtype == torch.bfloat16 and d == 256 and splits > 1
            assert len(route) == 3 + wide
    assert flash.bwd_cuda_kernels(torch.bfloat16, 64, 1)[1] == \
        "flash_bwd_wgmma"
    assert set(ssd.cuda_kernels(dtype)) <= _globals(ssd.SOURCE)
    assert set(ssd.bwd_cuda_kernels(dtype)) <= _globals(ssd.BWD_SOURCE)
    assert len(ssd.cuda_kernels(dtype)) == bench.SSD_KERNELS
    assert len(ssd.bwd_cuda_kernels(dtype)) == (
        bench.SSD_BWD_KERNELS if dtype == torch.bfloat16 else 7)
    assert set(rglru.CUDA_KERNEL + rglru.BWD_CUDA_KERNEL) <= \
        _globals(rglru.SOURCE)
    assert set(box.CUDA_KERNEL) == _globals(box.SOURCE)
    assert bench.port_kernels() == (
        fwd | bwd | _globals(ssd.SOURCE) | _globals(ssd.BWD_SOURCE)
        | _globals(rglru.SOURCE) | _globals(box.SOURCE))


def test_wrappers_count_no_kernel_they_do_not_launch():
    """On meta tensors (the dry-run's count) a wrapper launches nothing and
    adds nothing to CUDA_KERNELS."""
    from repro_torch.kernels import CUDA_KERNELS
    before = bench.Counter(CUDA_KERNELS)
    q = torch.empty((1, 2, 64, 64), device="meta", dtype=torch.bfloat16)
    out, lse = flash.flash_attention(q, q, q, return_lse=True)
    flash.flash_attention_bwd(q, q, q, out, lse, q)
    assert CUDA_KERNELS == before


def fake_session(intervals):
    """A stand-in for bench.session returning ``intervals`` [(events,
    launched)] whatever it is given."""
    def session(fns):
        assert len(fns) == len(intervals)
        for fn in fns:
            fn()
        return intervals
    return session


@pytest.mark.parametrize("ok", [True, False])
def test_device_profile_passes_its_interval_through_the_check(monkeypatch,
                                                              ok):
    events = [(FWD, 0.14), *((n, 0.1) for n in BWD), (OTHERS[0], 0.02)]
    if not ok:
        events = events[1:]
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(bench, "session",
                        fake_session([(events, step_launches())]))
    if not ok:
        with pytest.raises(RuntimeError, match="flash_fwd_bf16"):
            bench.device_profile(lambda: None, what="a step")
        return
    prof = bench.device_profile(lambda: None, what="a step")
    assert prof["busy_ms"] == pytest.approx(0.46)
    assert (prof["launches"], prof["kernels"]) == (5, 4)
    assert prof["top"][0] == (FWD[:60], 0.14, 1)


def test_session_splits_a_profile_at_its_marks(monkeypatch):
    """The real profiler on the CPU: one interval a callable, each with the
    CUDA kernels the wrappers counted in it; no device event here, so the
    check refuses every interval."""
    from repro_torch.kernels import CUDA_KERNELS
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def launches(n):
        def fn():
            torch.ones(4).sum()
            CUDA_KERNELS.update(["flash_fwd_bf16"] * n)
        return fn
    before = bench.Counter(CUDA_KERNELS)
    try:
        out = bench.session([launches(1), launches(2)])
        assert [dict(launched) for _, launched in out] == [
            {"flash_fwd_bf16": 1}, {"flash_fwd_bf16": 2}]
        assert [events for events, _ in out] == [[], []]
        with pytest.raises(RuntimeError, match="holds no device event"):
            bench.profiled([launches(1)], ["an interval"])
    finally:
        CUDA_KERNELS.clear()
        CUDA_KERNELS.update(before)


def chip_smoke():
    """chip_smoke.py at the root of the checkout, imported (its main does
    not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CSRC.parents[2] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_profile_split_checks_each_interval(monkeypatch):
    """chip_smoke's busy readings of several steps in one session: each
    step's interval is held on its own, and a blank one fails the reading,
    whichever it is."""
    cs = chip_smoke()
    whole = [(FWD, 0.14), *((n, 0.1) for n in BWD), (OTHERS[0], 0.02)]
    steps = {"a": lambda: None, "b": lambda: None}
    monkeypatch.setattr(bench, "session", fake_session(
        [(whole, step_launches()), (whole, step_launches())]))
    out = cs.profile_split(steps)
    assert out["b"][:2] == (pytest.approx(0.46), 5)
    assert out["a"][3][FWD[:60]] == (0.14, 1)
    for blank in range(2):
        intervals = [(whole, step_launches()), (whole, step_launches())]
        intervals[blank] = ([e for e in whole if "delta" not in e[0]],
                            step_launches())
        monkeypatch.setattr(bench, "session", fake_session(intervals))
        with pytest.raises(RuntimeError, match=f"profile of {'ab'[blank]} "):
            cs.profile_split(steps)
