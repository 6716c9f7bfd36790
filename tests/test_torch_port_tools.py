"""The port's K3 bench tool (automoe_tpu_torch/tools/bench_stem.py): its
reading of nvcc's `-Xptxas -v` report, on the CPU."""
from __future__ import annotations

import pytest

from automoe_tpu_torch.tools.bench_stem import ptxas_usage

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z24maxpool3x3s2_int8_kernelPKaPaiiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z24maxpool3x3s2_int8_kernelPKaPaiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z25s2d_stem_pool_int8_kernelPK13__nv_bfloat16S1_PKfS3_Paiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z25s2d_stem_pool_int8_kernelPK13__nv_bfloat16S1_PKfS3_Paiiiiiii
    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 254 registers, used 3 barriers, 15360 bytes smem, 424 bytes cmem[0]
"""


def test_ptxas_usage_reads_the_named_kernel():
    assert ptxas_usage(LOG) == {"regs": 254, "stack_bytes": 8, "spill_store_bytes": 16,
                                "spill_load_bytes": 12, "static_smem_bytes": 15360}
    assert ptxas_usage(LOG, "maxpool3x3s2_int8_kernel") == {
        "regs": 30, "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
        "static_smem_bytes": 0}


def test_ptxas_usage_raises_without_the_kernel():
    with pytest.raises(ValueError, match="no ptxas report"):
        ptxas_usage(LOG, "auction_kernel")
