"""The arithmetic of the W4/W8 timing command (profile_matmul): its byte
and operation counts and bounds, the launch-weighted decode step, and the
ptxas figures it reads from a build log. Nothing here needs a card."""

import pytest

from distributed_llm_training_and_inference_system_tpu_torch import (
    profile_matmul as pm)

LOG = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5633914e_14_int4_matmul_cu_5443f69318int4_matmul_kernelILi64ELb0E13__nv_bfloat16EEvPKT1_PKfPKhS6_PS2_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__5633914e_14_int4_matmul_cu_5443f69318int4_matmul_kernelILi64ELb0E13__nv_bfloat16EEvPKT1_PKfPKhS6_PS2_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5633914e_14_int4_matmul_cu_5443f69318int4_matmul_kernelILi8ELb1EfEEvPKT1_PKfPKhS5_PS1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__5633914e_14_int4_matmul_cu_5443f69318int4_matmul_kernelILi8ELb1EfEEvPKT1_PKfPKhS5_PS1_iiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__6f0c2a1e_14_int8_matmul_cu_9d4b1c2018int8_matmul_kernelILi8E13__nv_bfloat16EEvPKT0_PKfPKaPS2_iiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__6f0c2a1e_14_int8_matmul_cu_9d4b1c2018int8_matmul_kernelILi8E13__nv_bfloat16EEvPKT0_PKfPKaPS2_iiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__6f0c2a1e_14_int8_matmul_cu_9d4b1c2018int8_matmul_kernelILi64EfEEvPKT0_PKfPKaPS0_iiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__6f0c2a1e_14_int8_matmul_cu_9d4b1c2018int8_matmul_kernelILi64EfEEvPKT0_PKfPKaPS0_iiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__286105eb_18_flash_attention_cu_b294bfd021flash_fwd_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiS5_S5_S5_PS1_Pfiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_bytes_and_bound_of_the_down_projection():
    """llama-8b-gqa's down projection at 8 rows: half a byte a weight, fp32
    group scales (group 128) and channel scales, bf16 x read and y written
    once; bytes bound it, at ~9.4 us on an H100's 3.35 TB/s."""
    w = pm.w4_work(8, 14336, 4096)
    want = (14336 * 4096 // 2 + (14336 // 128) * 4096 * 4 + 14336 * 4
            + 8 * 14336 * 2 + 8 * 4096 * 2)
    assert w["bytes"] == want == 31_547_392
    assert w["ops"] == 2 * 8 * 14336 * 4096
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(want / 3.35e12 * 1e3)
    assert w["bound_ms"] == pytest.approx(0.0094171, rel=1e-4)


@pytest.mark.parametrize("rows,by", [(1, "bytes"), (64, "bytes"),
                                     (256, "operations")])
def test_bound_turns_to_operations_only_past_the_ridge(rows, by):
    """4 flops a stored byte a row: at <= 64 rows (what the kernel takes)
    the bound is bytes; 256 rows would pass the ~295 flop/byte ridge."""
    w = pm.w4_work(rows, 4096, 4096)
    assert w["bound_by"] == by
    assert w["bound_ms"] == pytest.approx(max(
        w["ops"] / 989e12, w["bytes"] / 3.35e12) * 1e3)


def test_fp32_activations_count_four_bytes():
    b2 = pm.w4_work(8, 4096, 1024)["bytes"]
    b4 = pm.w4_work(8, 4096, 1024, item=4)["bytes"]
    assert b4 - b2 == 8 * (4096 + 1024) * 2


def test_decode_step_weights_each_projection_by_its_launches():
    """7 W4 launches a layer (q, k, v, o, gate, up, down), 32 layers: 224 a
    decode step."""
    assert sum(pm.PROJECTIONS.values()) * pm.LAYERS == 224
    ms = {(4096, 4096): 1.0, (4096, 1024): 10.0, (4096, 14336): 100.0,
          (14336, 4096): 1000.0}
    assert pm.decode_step_ms(ms) == pytest.approx(32 * (2 + 20 + 200 + 1000))
    bound = pm.decode_step_ms({s: pm.w4_work(8, *s)["bound_ms"]
                               for s in pm.PROJECTIONS})
    assert bound == pytest.approx(1.121, abs=1e-3)


def test_ptxas_figures_of_the_w4_templates():
    """Each template by rows, scale path and dtype; other kernels in the
    log are left out."""
    assert pm.w4_ptxas(LOG) == {
        "int4_matmul_kernel<64, any, bf16>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 122},
        "int4_matmul_kernel<8, group16, fp32>": {
            "spill_stores": 4, "spill_loads": 4, "registers": 128}}
    assert pm.w4_ptxas("") == {}


def test_w8_bytes_and_bound_of_the_gate_projection():
    """llama-8b-gqa's gate/up projection at 8 rows: one byte a weight, an
    fp32 scale a row, bf16 x read and y written once; bytes bound it, at
    ~17.6 us on an H100's 3.35 TB/s."""
    w = pm.w8_work(8, 4096, 14336)
    want = 4096 * 14336 + 4096 * 4 + 8 * 4096 * 2 + 8 * 14336 * 2
    assert w["bytes"] == want == 59_031_552
    assert w["ops"] == 2 * 8 * 4096 * 14336
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(want / 3.35e12 * 1e3)
    assert w["bound_ms"] == pytest.approx(0.0176213, rel=1e-4)
    # the down projection moves the same bytes but for x and y
    d = pm.w8_work(8, 14336, 4096)
    assert d["bytes"] - w["bytes"] == (14336 - 4096) * 4


@pytest.mark.parametrize("rows,by", [(1, "bytes"), (64, "bytes"),
                                     (256, "operations")])
def test_w8_bound_turns_to_operations_only_past_the_ridge(rows, by):
    """2 flops a stored byte a row: at <= 64 rows the bound is bytes; 256
    rows would pass the ~295 flop/byte ridge."""
    w = pm.w8_work(rows, 4096, 4096)
    assert w["bound_by"] == by
    assert w["bound_ms"] == pytest.approx(max(
        w["ops"] / 989e12, w["bytes"] / 3.35e12) * 1e3)


def test_w8_fp32_activations_count_four_bytes():
    b2 = pm.w8_work(8, 4096, 1024)["bytes"]
    b4 = pm.w8_work(8, 4096, 1024, item=4)["bytes"]
    assert b4 - b2 == 8 * (4096 + 1024) * 2


def test_w8_decode_step_is_six_whole_k_and_one_k_split_a_layer():
    """The W8 route of each projection: q, o, k, v, gate and up take the
    whole-K entry point, down the k-split one; 192 + 32 launches a step."""
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int8_matmul as w8)
    routes = {}
    for shape, n in pm.PROJECTIONS.items():
        r = w8.w8_route(*shape)
        routes[r] = routes.get(r, 0) + n * pm.LAYERS
    assert routes == {"whole_k": 192, "ksplit": 32}
    bound = pm.decode_step_ms({s: pm.w8_work(8, *s)["bound_ms"]
                               for s in pm.PROJECTIONS})
    assert bound == pytest.approx(2.097, abs=1e-3)


def test_ptxas_figures_of_the_w8_templates():
    """Each template by rows and dtype; the W4 and flash kernels in the
    log are left out, and the W4 parse leaves the W8 kernels out."""
    assert pm.w8_ptxas(LOG) == {
        "int8_matmul_kernel<8, bf16>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 60},
        "int8_matmul_kernel<64, fp32>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 127}}
    assert len(pm.w4_ptxas(LOG)) == 2
    assert pm.w8_ptxas("") == {}


def test_both_kernels_have_an_entry():
    assert sorted(pm.KERNELS) == ["w4", "w8"]
