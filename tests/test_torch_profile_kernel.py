"""The arithmetic of the paged-attention timing command (profile_kernel):
its byte and operation counts and bound for fp, int8 and int4 pages, the
split plan's live blocks for a set of lengths, and the ptxas figures it
reads from a build log. Nothing here needs a card."""

import pytest

from distributed_llm_training_and_inference_system_tpu_torch import (
    profile_kernel as pk)

RAGGED = [2048, 1, 64, 65, 777, 1500, 130, 2000]      # chip_smoke phase 4

LOG = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__9f1c2a3b_18_paged_attention_cu_4b2e7a1c25paged_attention_tc_kernelILi0ELi8EEEvPK13__nv_bfloat16PKhS5_PKfS7_PKiS9_PS2_PfSB_iiiiiiifNS_4PlanE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__9f1c2a3b_18_paged_attention_cu_4b2e7a1c25paged_attention_tc_kernelILi0ELi8EEEvPK13__nv_bfloat16PKhS5_PKfS7_PKiS9_PS2_PfSB_iiiiiiifNS_4PlanE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__9f1c2a3b_18_paged_attention_cu_4b2e7a1c22paged_attention_kernelILi2ELi8EEEvPKfPKhS4_S2_S2_PKiS6_PfS7_S7_iiiiiiifiNS_4PlanE' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5633914e_14_int4_matmul_cu_5443f69318int4_matmul_kernelILi64ELb0E13__nv_bfloat16EEvPKT1_PKfPKhS6_PS2_iiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers
"""


def test_bytes_and_bound_at_the_decode_shape():
    """Phase 4 of chip_smoke: 6585 live keys, each K and V row of 8 kv
    heads read once in bf16, q read and out written once, the 8 x 32 table
    and the starts: 27.1 MB, bound by bytes at ~8.09 us on 3.35 TB/s."""
    w = pk.paged_work(RAGGED)
    live = sum(RAGGED)
    want = 2 * 8 * 32 * 128 * 2 + 2 * live * 8 * 128 * 2 + 8 * 32 * 4 + 8 * 4
    assert live == 6585 and w["bytes"] == want == 27_104_288
    assert w["ops"] == 4 * 32 * 128 * live
    assert w["bound_by"] == "bytes"
    assert w["bound_ms"] == pytest.approx(want / 3.35e12 * 1e3)
    assert w["bound_ms"] == pytest.approx(0.0080908, rel=1e-4)


@pytest.mark.parametrize("kind,row,bound", [("int8", 132, 0.0041909),
                                            ("int4", 68, 0.0021781)])
def test_quantized_pages_count_their_stored_bytes_and_scales(kind, row,
                                                             bound):
    """int8: a byte a value and a 4-byte scale a row; int4: half a byte."""
    assert pk.row_bytes(kind) == row
    w = pk.paged_work(RAGGED, kind)
    assert w["bytes"] - pk.paged_work(RAGGED)["bytes"] == (
        2 * sum(RAGGED) * 8 * (row - 256))
    assert w["bound_ms"] == pytest.approx(bound, rel=1e-4)


def test_a_window_counts_the_keys_each_query_sees():
    """T = 2 over a slot of 10 keys: its two queries see 9 and 10."""
    w = pk.paged_work([10], T=2, nq=4, nkv=2, d=16, maxp=1)
    assert w["ops"] == 4 * 4 * 16 * (9 + 10)
    assert w["bytes"] == 2 * 2 * 4 * 16 * 2 + 2 * 10 * 2 * 32 + 4 + 4


def test_split_report_at_the_decode_shape():
    """8 splits of 256 keys: phase 4's lengths leave 30 live splits, 240
    of the grid's 512 blocks."""
    r = pk.split_report(RAGGED)
    assert (r["keys_per_split"], r["n_splits"]) == (256, 8)
    assert (r["live_splits"], r["live_blocks"], r["grid_blocks"]) == (
        30, 240, 512)
    r = pk.split_report([2048] * 8)
    assert r["live_blocks"] == r["grid_blocks"] == 512
    assert pk.split_report([64] * 8)["live_blocks"] == 64


def test_ptxas_figures_of_the_paged_templates():
    """The bf16 body by page kind and k-steps, the fp32 body by page kind
    and columns a lane; other kernels in the log are left out."""
    assert pk.paged_ptxas(LOG) == {
        "paged_attention_tc_kernel<fp, NT=8>": {
            "spill_stores": 0, "spill_loads": 0, "registers": 96},
        "paged_attention_kernel<int4, CW=8>": {
            "spill_stores": 4, "spill_loads": 8, "registers": 128}}
    assert pk.paged_ptxas("") == {}
