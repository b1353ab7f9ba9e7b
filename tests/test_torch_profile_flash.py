"""The arithmetic of the flash-backward timing command (profile_flash): its
bounds, the ptxas figures it reads from a build log, and the occupancy it
derives. Nothing here needs a card."""

import pytest

from distributed_llm_training_and_inference_system_tpu_torch import (
    profile_flash as pf)

LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124flash_bwd_dq_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiS5_S5_S5_S3_PKfS7_PS1_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124flash_bwd_dq_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiS5_S5_S5_S3_PKfS7_PS1_iiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_bwd_dq_kernelIfLi64EEEvPKT_S3_S3_PKiS5_S5_S5_S3_PKfS7_PS1_iiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125flash_bwd_dkv_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PKiS5_S5_S5_S3_PKfS7_PS1_S8_iiif' for 'sm_90a'
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 488 bytes cmem[0]
"""


def test_bounds_at_the_training_shape():
    """gpt-1b, B=4 x 2048, 16/16 heads, D=128: operations bound both
    kernels (causal pairs x 2 D flops x 3 or 4 products over 989 TF/s)."""
    w = pf.bwd_work(4, 2048, 16, 16, 128)
    pairs = 4 * 16 * 2048 * 2049 // 2
    assert w["flash_bwd_dq"]["ops"] == 6 * 128 * pairs
    assert w["flash_bwd_dkv"]["ops"] == 8 * 128 * pairs
    for name in w:
        assert w[name]["bound_by"] == "operations"
    assert w["flash_bwd_dq"]["bound_ms"] == pytest.approx(0.10428, rel=1e-4)
    assert w["flash_bwd_dkv"]["bound_ms"] == pytest.approx(0.13904, rel=1e-4)
    # bytes: q, k, v, dO, lse, delta, segments and positions read once;
    # dq (resp. dk and dv) written once
    elems = 4 * 2048 * 16 * 128
    rows = 4 * 2048 * 16
    assert w["flash_bwd_dq"]["bytes"] == 2 * 5 * elems + 4 * 6 * rows
    assert w["flash_bwd_dkv"]["bytes"] == 2 * 6 * elems + 4 * 6 * rows


def test_bounds_turn_to_bytes_for_short_rows():
    w = pf.bwd_work(64, 8, 4, 1, 64)
    assert all(r["bound_by"] == "bytes" for r in w.values())


def test_ptxas_figures_of_the_bf16_backward_kernels():
    figs = pf.ptxas_figures(LOG)
    assert figs == {
        "flash_bwd_dq_bf16_kernel<128>": {"spill_stores": 0, "spill_loads": 0,
                                          "registers": 168},
        "flash_bwd_dkv_bf16_kernel<64>": {"spill_stores": 12,
                                          "spill_loads": 16,
                                          "registers": 255}}
    assert pf.ptxas_figures("") == {}


@pytest.mark.parametrize("D,ints,rows,want", [
    (128, 2, 2048, 6 * 64 * 136 * 2 + 2 * 2 * 64 * 4 + 32),
    (128, 4, 2048, 6 * 64 * 136 * 2 + 2 * 4 * 64 * 4 + 32),
    (64, 4, 1, 6 * 64 * 72 * 2 + 2 * 4 * 64 * 4 + 16),
])
def test_shared_memory_of_a_block(D, ints, rows, want):
    assert pf.bwd_smem_bytes(D, ints, rows) == want


@pytest.mark.parametrize("regs,smem,want", [
    (168, 106_528, 2),      # shared memory holds two blocks
    (255, 50_000, 2),       # registers: 256 x 128 = half the file
    (128, 50_000, 4),
    (64, 10_000, 8),
    (32, 1_000, 16),        # 2048 threads an SM
])
def test_resident_blocks(regs, smem, want):
    assert pf.resident_blocks(regs, smem) == want


def test_bwd_ptxas_adds_shared_memory_and_residency():
    figs = pf.bwd_ptxas(LOG, 2048)
    dq = figs["flash_bwd_dq_bf16_kernel<128>"]
    assert dq["smem_bytes"] == pf.bwd_smem_bytes(128, 2, 2048)
    assert dq["resident_blocks"] == 2
    dkv = figs["flash_bwd_dkv_bf16_kernel<64>"]
    assert dkv["smem_bytes"] == pf.bwd_smem_bytes(64, 4, 2048)
    assert dkv["resident_blocks"] == pf.resident_blocks(255,
                                                        dkv["smem_bytes"])
