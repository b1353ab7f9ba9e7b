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


FWD_LOG = LOG + """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiS5_S5_S5_PS1_Pfiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiS5_S5_S5_PS1_Pfiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 252 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvPKT_S3_S3_PKiS5_S5_S5_PS1_Pfiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, 468 bytes cmem[0]
"""


def test_forward_bound_at_the_training_shape():
    """gpt-1b, B=4 x 2048, 16/16 heads, D=128: q.k and p.v over the causal
    pairs bound the forward by operations."""
    w = pf.fwd_work(4, 2048, 16, 16, 128)
    pairs = 4 * 16 * 2048 * 2049 // 2
    assert w["ops"] == 4 * 128 * pairs
    assert w["bound_by"] == "operations"
    assert w["bound_ms"] == pytest.approx(0.069518, rel=1e-4)
    # q, k, v read and out written once (bf16); lse written once; the
    # segments and positions of q and k read once (int32)
    elems = 4 * 2048 * 16 * 128
    rows = 4 * 2048 * 16
    assert w["bytes"] == 2 * 4 * elems + 4 * rows + 4 * 4 * rows
    assert pf.fwd_work(64, 8, 4, 1, 64)["bound_by"] == "bytes"


@pytest.mark.parametrize("B,S,Nq,Nkv,D", [
    (4, 2048, 16, 16, 128),     # gpt-1b
    (2, 96, 8, 2, 64),          # a GQA fold of 4
])
def test_forward_bytes_count_the_folded_tensors(B, S, Nq, Nkv, D):
    """The forward's bytes are what phase 9 of chip_smoke.py gives it:
    q, k, v and out at 2 bytes, lse and the four int32 row arrays at 4, as
    fold_gqa lays them out for the kernel."""
    import torch
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        attention as fa)
    segs = torch.ones(B, S, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    _, _, _, sq, pq, sk, pk, _ = fa.fold_gqa(
        torch.zeros(B, S, Nq, 1), torch.zeros(B, S, Nkv, 1),
        torch.zeros(B, S, Nkv, 1), segs, pos)
    want = ((2 * B * S * Nq * D + 2 * B * S * Nkv * D) * 2 + B * Nq * S * 4
            + (sq.numel() + pq.numel() + sk.numel() + pk.numel()) * 4)
    assert pf.fwd_work(B, S, Nq, Nkv, D)["bytes"] == want


@pytest.mark.parametrize("D,rows,want", [
    # the Q tile of 128 rows and 2 stages of K and V tiles of 64, rows of
    # D + 8 bf16; 2 stages of kpos/kseg and the rows' qpos/qseg, int32;
    # class bytes rounded up to 16
    (128, 2048, (128 + 4 * 64) * 136 * 2 + (4 * 64 + 2 * 128) * 4 + 32),
    (128, 65, (128 + 4 * 64) * 136 * 2 + (4 * 64 + 2 * 128) * 4 + 16),
    (64, 1, (128 + 4 * 64) * 72 * 2 + (4 * 64 + 2 * 128) * 4 + 16),
    (64, 0, (128 + 4 * 64) * 72 * 2 + (4 * 64 + 2 * 128) * 4),
])
def test_forward_shared_memory_of_a_block(D, rows, want):
    assert pf.fwd_smem_bytes(D, rows) == want


def test_ptxas_parse_holds_the_forward_entry():
    """The bf16 forward is parsed beside the backward pair and gets its own
    shared memory; the fp32 kernels are left out; the backward's figures
    are as without it."""
    figs = pf.ptxas_figures(FWD_LOG)
    assert figs["flash_fwd_bf16_kernel<128>"] == {
        "spill_stores": 0, "spill_loads": 0, "registers": 252}
    assert set(figs) == {"flash_bwd_dq_bf16_kernel<128>",
                         "flash_bwd_dkv_bf16_kernel<64>",
                         "flash_fwd_bf16_kernel<128>"}
    fwd = pf.fwd_ptxas(FWD_LOG, 2048)
    assert list(fwd) == ["flash_fwd_bf16_kernel<128>"]
    f = fwd["flash_fwd_bf16_kernel<128>"]
    assert f["smem_bytes"] == pf.fwd_smem_bytes(128, 2048) == 106_528
    assert f["resident_blocks"] == 2
    assert pf.bwd_ptxas(FWD_LOG, 2048) == pf.bwd_ptxas(LOG, 2048)


def test_ptxas_names_inside_a_namespace_named_after_the_file():
    """nvcc may name the anonymous namespace after the source file
    (flash_attention.cu): the kernel's stem is still its own name."""
    log = ("ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__"
           "b9a6a1a5_18_flash_attention_cu_b2d1c7a421flash_fwd_bf16_kernel"
           "ILi64EEEvPK13__nv_bfloat16S3_S3_PKiS5_S5_S5_PS1_Pfiiif' for "
           "'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 "
           "bytes spill loads\nptxas info    : Used 128 registers\n")
    assert pf.ptxas_figures(log) == {"flash_fwd_bf16_kernel<64>": {
        "spill_stores": 0, "spill_loads": 0, "registers": 128}}
