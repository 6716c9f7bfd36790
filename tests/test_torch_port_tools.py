"""The port's kernel bench tools (automoe_tpu_torch/tools/bench_stem.py,
bench_auction.py), on the CPU: their reading of nvcc's `-Xptxas -v`
report, of a `cuobjdump -sass` listing and of an auction source's entry
point."""
from __future__ import annotations

from pathlib import Path

import pytest

from automoe_tpu_torch.tools.bench_auction import has_escalate
from automoe_tpu_torch.tools.bench_stem import count_sass, ptxas_usage

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


# two instantiations of a template kernel; the second calls a function
# that was not inlined, whose own report comes first
AUCTION_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114auction_kernelILi1EEEvPKfPKiS2_Piiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114auction_kernelILi1EEEvPKfPKiS2_Piiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 408 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114auction_kernelILi2EEEvPKfPKiS2_Piiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115jv_exact_sharedERKNS_4SmemEiii
    24 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Function properties for _ZN12_GLOBAL__N_114auction_kernelILi2EEEvPKfPKiS2_Piiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 408 bytes cmem[0]
"""


@pytest.mark.parametrize("log,kernel,want", [
    (LOG, None, {"regs": 254, "stack_bytes": 8, "spill_store_bytes": 16,
                 "spill_load_bytes": 12, "static_smem_bytes": 15360}),
    (LOG, "maxpool3x3s2_int8_kernel", {"regs": 30, "stack_bytes": 0, "spill_store_bytes": 0,
                                       "spill_load_bytes": 0, "static_smem_bytes": 0}),
    (AUCTION_LOG, "auction_kernelILi2E", {"regs": 48, "stack_bytes": 0, "spill_store_bytes": 0,
                                          "spill_load_bytes": 0, "static_smem_bytes": 0}),
], ids=["stem-default", "pool", "auction"])
def test_ptxas_usage_reads_the_named_kernel(log, kernel, want):
    assert (ptxas_usage(log) if kernel is None else ptxas_usage(log, kernel)) == want


def test_ptxas_usage_raises_without_the_kernel():
    with pytest.raises(ValueError, match="no ptxas report"):
        ptxas_usage(LOG, "auction_kernel")


def test_has_escalate_reads_the_entry_point(tmp_path):
    from automoe_tpu_torch.ops import auction_kernel

    src = Path(auction_kernel.__file__).resolve().parents[1] / "csrc" / "auction.cu"
    assert has_escalate(src)
    old = tmp_path / "old.cu"
    old.write_text('extern "C" int automoe_auction_solve(const void* benefit, const void* valid,\n'
                   "    const void* eps, void* out, int B, int N, int Q, int max_iters,\n"
                   "    void* stream) {\n  // escalate is not a parameter here\n}\n")
    assert not has_escalate(old)
    (tmp_path / "none.cu").write_text("int f() { return 0; }\n")
    with pytest.raises(ValueError, match="no automoe_auction_solve"):
        has_escalate(tmp_path / "none.cu")


# two kernels of one library as cuobjdump -sass lists them; the f32 one's
# name contains the other's only with "_f32" inside it
SASS = """\

Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_129s2d_stem_pool_int8_f32_kernelEPKfS1_S1_S1_Paiiiiii
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HGMMA.64x64x8.F32.TF32 R24, R88, gdesc[UR4], RZ, !UPT ;
        /*0020*/                   HGMMA.64x64x8.F32.TF32 R24, R92, gdesc[UR8], R24 ;
        /*0030*/                   HGMMA.64x64x8.F32.TF32 R24, R96, gdesc[UR4], R24, gsb0 ;
        /*0040*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
\t\t..........


\t\tFunction : _ZN12_GLOBAL__N_125s2d_stem_pool_int8_kernelEPK13__nv_bfloat16S2_PKfS4_Paiiiiii
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   HGMMA.64x128x16.F32.BF16 R24, R88, gdesc[UR4], R24 ;
        /*0010*/                   FFMA R2, R3, R4, R2 ;
\t\t..........
"""


@pytest.mark.parametrize("kernel,opcode,want", [
    ("s2d_stem_pool_int8_f32_kernel", "HGMMA", 3),
    ("s2d_stem_pool_int8_kernel", "HGMMA", 1),
    ("s2d_stem_pool_int8_kernel", "FFMA", 1),
    ("s2d_stem_pool_int8_f32_kernel", "FFMA", 0),
], ids=["f32-hgmma", "bf16-hgmma", "bf16-ffma", "f32-ffma"])
def test_count_sass_counts_in_the_named_kernel(kernel, opcode, want):
    assert count_sass(SASS, kernel, opcode) == want


def test_count_sass_raises_without_the_kernel():
    with pytest.raises(ValueError, match="no SASS"):
        count_sass(SASS, "maxpool3x3s2_int8_kernel")
