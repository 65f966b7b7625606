"""The parsers of ops/measure.py on text in the formats of the CUDA
toolkit's `cuobjdump -sass` and `ptxas -v`: the SASS instruction
classes of a kernel and of its main loop, and its registers and spills
(chip_smoke.py and ops/kp_ab.py print them from the card's build)."""

from galileo_sdr_sim_tpu_torch.ops import measure

KERNEL = "_ZN12_GLOBAL__N_118synth_kp_v5_kernelILb1ELb0ELb0EEEvPKfS2_S2_"
OTHER = "_ZN12_GLOBAL__N_116kp_planes_kernelEPKf"

SASS = f"""
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]

	code for sm_90a
		Function : {KERNEL}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0020*/                   I2FP.F32.S32 R2, R0 ;
        /*0030*/                   LDS R9, [R3] ;
        /*0040*/                   FFMA R3, R2, R2, R2 ;
        /*0050*/                   FRND.FLOOR R4, R3 ;
        /*0060*/                   PRMT R7, R9, 0x7540, R8 ;
        /*0070*/                   FFMA R5, R4, R4, R3 ;
        /*0080*/               @!P0 BRA 0x40 ;
        /*0090*/                   FFMA R5, R5, R5, R5 ;
        /*00a0*/              @P1 BRA 0x30 ;
        /*00b0*/                   F2I.TRUNC.NTZ R6, R5 ;
        /*00c0*/                   STG.E [R8.64], R6 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
		Function : {OTHER}
        /*0000*/                   MUFU.SIN R1, R2 ;
        /*0010*/                   EXIT ;
"""

PTXAS = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{KERNEL}' for 'sm_90a'
ptxas info    : Function properties for {KERNEL}
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '{OTHER}' for 'sm_90a'
ptxas info    : Function properties for {OTHER}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 400 bytes cmem[0]
"""


def test_parse_sass_functions_and_opcodes():
    funcs = measure.parse_sass(SASS)
    assert list(funcs) == [KERNEL, OTHER]
    ops = [op for _, op, _ in funcs[KERNEL]]
    assert ops == ["LDC", "S2R", "I2FP", "LDS", "FFMA", "FRND", "PRMT", "FFMA", "BRA", "FFMA",
                   "BRA", "F2I", "STG", "EXIT", "BRA"]
    assert funcs[KERNEL][8][0] == 0x80


def test_main_loop_is_the_innermost_loop():
    """The loop 0x40..0x80 nests in 0x30..0xa0; the self-branch at 0xe0
    is no loop; a function without a backward branch has none."""
    funcs = measure.parse_sass(SASS)
    loop = measure.main_loop(funcs[KERNEL])
    assert [a for a, _, _ in loop] == [0x40, 0x50, 0x60, 0x70, 0x80]
    assert measure.main_loop(funcs[OTHER]) == []


def test_class_counts():
    funcs = measure.parse_sass(SASS)
    whole = measure._count(funcs[KERNEL])
    assert (whole["FFMA"], whole["I2FP"], whole["F2I"], whole["FRND"], whole["total"]) == (3, 1, 1, 1, 15)
    loop = measure._count(measure.main_loop(funcs[KERNEL]))
    assert (loop["FFMA"], loop["FRND"], loop["PRMT"], loop["I2FP"], loop["F2I"]) == (2, 1, 1, 0, 0)
    assert set(measure.CONVERSIONS) <= set(measure.SASS_CLASSES)


def test_ptxas_summary_and_names():
    got = measure.ptxas_summary(PTXAS)
    assert got == {KERNEL: "56 registers, 8 B spill stores, 4 B spill loads",
                   OTHER: "40 registers, 0 B spill stores, 0 B spill loads"}
    assert measure.kp_function(KERNEL) == "synth_kp_v5_cboc"
    assert measure.kp_function(KERNEL.replace("ILb1ELb0ELb0E", "ILb0ELb1ELb0E")) == "synth_kp_v5_gain"
    assert measure.kp_function(KERNEL.replace("ILb1ELb0ELb0E", "ILb1ELb0ELb1E")) == "synth_kp_v5_cboc_f32"
    assert measure.kp_function(OTHER) == "synth_kp_v5_planes"
    assert measure.kp_function("_Z6gatherPKiS0_Pii") == "_Z6gatherPKiS0_Pii"
