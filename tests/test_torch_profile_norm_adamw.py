"""The arithmetic of the RMSNorm/AdamW timing command (profile_norm_adamw):
its byte and operation counts and bounds, the gpt-1b leaves it updates,
and the ptxas figures it reads from a build log. Nothing here needs a
card."""

import pytest

from distributed_llm_training_and_inference_system_tpu_torch import (
    profile_norm_adamw as pn)

LOG = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__1b2c3d4e_10_rmsnorm_cu_5a6b7c8d19rmsnorm_warp_kernelI13__nv_bfloat16S1_Li8EEEvPKT_PKT0_PS2_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__1b2c3d4e_10_rmsnorm_cu_5a6b7c8d19rmsnorm_warp_kernelI13__nv_bfloat16S1_Li8EEEvPKT_PKT0_PS2_iiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__1b2c3d4e_10_rmsnorm_cu_5a6b7c8d19rmsnorm_warp_kernelIf13__nv_bfloat16Li16EEEvPKT_PKT0_PS2_iiiif' for 'sm_90a'
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__1b2c3d4e_10_rmsnorm_cu_5a6b7c8d20rmsnorm_block_kernelIffEEvPKT_PKT0_PS2_if' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__9f8e7d6c_8_adamw_cu_1a2b3c4d12adamw_kernelI13__nv_bfloat16fEEvNS_5TableENS_5HyperEPKf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__9f8e7d6c_8_adamw_cu_1a2b3c4d14rmsnorm_kernelI13__nv_bfloat16EEvPKT_PKfPS1_if' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__286105eb_18_flash_attention_cu_b294bfd021flash_fwd_bf16_kernelILi128EEEvPK13__nv_bfloat16' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


@pytest.mark.parametrize("shape,nbytes,bound_ms", [
    ((1024, 2048), 8_392_704, 0.0025053),      # the entry forward's norm
    ((8192, 4096), 134_225_920, 0.0400674),
    ((8, 4096), 139_264, 0.00004157)])
def test_rmsnorm_bytes_and_bound(shape, nbytes, bound_ms):
    """x read and written once in bf16, the bf16 scale once; bytes bound
    it (4 flops an element are far below fp32's ridge)."""
    w = pn.rmsnorm_work(*shape)
    assert w["bytes"] == nbytes
    assert w["ops"] == 4 * shape[0] * shape[1]
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert w["bound_ms"] == pytest.approx(bound_ms, rel=1e-4)


def test_rmsnorm_fp32_counts_four_bytes_an_element():
    assert (pn.rmsnorm_work(8, 4096, item=4, scale_item=4)["bytes"]
            == 2 * 8 * 4096 * 4 + 4096 * 4)


@pytest.mark.parametrize("mu_item,nu_item,per_element", [
    (4, 4, 28), (2, 4, 24), (2, 2, 20)])
def test_adamw_bytes_an_element(mu_item, nu_item, per_element):
    """p, g read and p written in fp32; each moment read and written in
    its own dtype."""
    assert pn.adamw_work(1000, mu_item, nu_item)["bytes"] == 1000 * per_element


def test_adamw_bound_over_the_gpt1b_leaves():
    """The 170 eligible gpt-1b leaves: 1.4393e9 elements, 28 B each at fp32
    moments, ~12.03 ms at 3.35 TB/s; 20 flops an element take 0.43 ms of
    fp32's 67 TF/s, so bytes bound it."""
    shapes = pn.gpt1b_leaf_shapes()
    n = sum(a * b for a, b in shapes)
    assert len(shapes) == 170
    assert n == pytest.approx(1.4393e9, rel=1e-4)
    w = pn.adamw_work(n)
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(12.029, rel=1e-3)
    assert w["ops"] / 67e12 * 1e3 < 0.05 * w["bound_ms"]


def test_ptxas_figures_of_both_kernels_by_template():
    figs = pn.kernel_ptxas(LOG)
    assert figs == {
        "rmsnorm_warp_kernel<bf16, bf16, 8>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 72},
        "rmsnorm_warp_kernel<fp32, bf16, 16>": {
            "spill_stores": 8, "spill_loads": 4, "registers": 255},
        "rmsnorm_block_kernel<fp32, fp32>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 40},
        "adamw_kernel<bf16, fp32>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 96},
        "rmsnorm_kernel<bf16>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 32}}


@pytest.mark.parametrize("mangled,args", [
    ("IffEEv", ["fp32", "fp32"]), ("I13__nv_bfloat16S0_Li16EEEv",
                                   ["bf16", "bf16", "16"]),
    ("If13__nv_bfloat16Li1EEEv", ["fp32", "bf16", "1"]), ("EEv", [])])
def test_template_arguments_read_up_to_the_lists_end(mangled, args):
    assert pn._template_args(mangled[1:] if mangled[0] == "I"
                             else mangled) == args
