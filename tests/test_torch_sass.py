"""tungsten_tpu_torch/kernels/sass.py: pipe classes of SASS instructions,
and per-class instruction counts along the paths of a lattice kernel's
loops, on a small hand-written listing in the form `cuobjdump -sass`
prints.  The counts are exact integers (or their products with the given
expected hits), so they are compared for equality."""
import pytest

from tungsten_tpu_torch.kernels import sass

# One kernel: an early exit, a cell loop (header 0x30) around an impulse
# loop (header 0x60) whose long path (0xa0, with MUFU.EX2) the branch at
# 0x90 skips, a store, and the padding after EXIT that nothing reaches.
LISTING = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_112fake_lattice_kernelEPf
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   S2R R0, SR_TID.X ;           /* 0x0 */
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/                   MOV R1, RZ ;
        /*0040*/                   IMAD R2, R1, 0x3, RZ ;
        /*0050*/                   LOP3.LUT R2, R2, R1, RZ, 0x3c, !PT ;
        /*0060*/                   IADD3 R3, RZ, RZ, RZ ;
        /*0070*/                   FADD R4, R4, 1 ;
        /*0080*/                   FSETP.GEU.AND P1, PT, R4, 1, PT ;
        /*0090*/               @P1 BRA 0xd0 ;
        /*00a0*/                   IMAD R5, R3, 0x2, RZ ;
        /*00b0*/                   MUFU.EX2 R6, R4 ;
        /*00c0*/                   FMUL R7, R6, R5 ;
        /*00d0*/                   IADD3 R3, R3, 0x1, RZ ;
        /*00e0*/                   ISETP.GE.AND P2, PT, R3, 0x3, PT ;
        /*00f0*/              @!P2 BRA 0x60 ;
        /*0100*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0110*/                   ISETP.GE.AND P3, PT, R1, 0x3, PT ;
        /*0120*/              @!P3 BRA 0x30 ;
        /*0130*/                   STG.E desc[UR6][R8.64], R7 ;
        /*0140*/                   EXIT ;
        /*0150*/                   BRA 0x150;
        /*0160*/                   NOP;
"""


@pytest.mark.parametrize("op,classes", [
    ("FFMA.SAT", ("issue", "fma")),
    ("FMUL", ("issue", "fma")),
    ("IMAD.MOV.U32", ("issue", "fma", "fmaheavy")),
    ("LOP3.LUT", ("issue", "alu")),
    ("SHF.L.W.U32.HI", ("issue", "alu")),
    ("I2FP.F32.U32", ("issue",)),
    ("I2F.U32", ("issue", "xu")),
    ("MUFU.EX2", ("issue", "xu")),
    ("VIADD", ("issue",)),
    ("NOP", ()),
])
def test_pipes(op, classes):
    assert sass.pipes(op) == classes


def test_cfg_loops():
    instrs = sass.parse(LISTING)["_ZN12_GLOBAL__N_112fake_lattice_kernelEPf"]
    assert len(instrs) == 23
    cfg = sass.Cfg(instrs)
    assert 0x150 not in cfg.blocks  # padding after EXIT
    assert {h: (sorted(b), sorted(l)) for h, (b, l) in cfg.loops.items()} == {
        0x30: ([0x30, 0x60, 0xa0, 0xd0, 0x100], [0x100]),
        0x60: ([0x60, 0xa0, 0xd0], [0xd0])}
    assert cfg.parent(0x60) == 0x30
    assert cfg.innermost("MUFU.EX2") == [0x60]


def test_lattice_counts_with_cells():
    # per impulse, short path 0x60 + 0xd0: issue 7, fma 1, alu 4; the long
    # path adds 0xa0: issue 3, fma 2, fmaheavy 1, xu 1; per cell, 0x30 and
    # 0x100: issue 6, fma 1, fmaheavy 1, alu 3
    got = sass.lattice_counts(LISTING, "fake_lattice", 6, 2.5, cells=2)
    assert got == {"issue": 6 * 7 + 2.5 * 3 + 2 * 6, "fma": 6 + 5.0 + 2,
                   "fmaheavy": 2.5 + 2, "alu": 6 * 4 + 2 * 3, "xu": 2.5}


def test_lattice_counts_one_iteration_per_point():
    got = sass.lattice_counts(LISTING, "fake_lattice", 1, 2.0)
    assert got == {"issue": 7 + 6.0, "fma": 1 + 4.0, "fmaheavy": 2.0,
                   "alu": 4 + 0.0, "xu": 2.0}


def test_lattice_counts_unknown_kernel():
    with pytest.raises(ValueError):
        sass.lattice_counts(LISTING, "no_such_kernel", 1, 1.0)


# One kernel with a split walk: a cell loop (header 0x30, its hash at 0x30
# and its tail at 0x120) around a test loop (header 0x50) that appends an
# impulse within reach to the ring (STS at 0x90, skipped by the branch at
# 0x80) and drains the ring when it is full (the loop at 0xc0, skipped by
# the branch at 0xb0); after the walk, the final drain (the loop at 0x150).
SPLIT_LISTING = """
        code for sm_90a
                Function : _Z17fake_split_kernelPf
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/                   MOV R1, RZ ;
        /*0040*/                   IMAD R2, R1, 0x3, RZ ;
        /*0050*/                   IADD3 R3, RZ, RZ, RZ ;
        /*0060*/                   FADD R4, R4, 1 ;
        /*0070*/                   FSETP.GEU.AND P1, PT, R4, 1, PT ;
        /*0080*/               @P1 BRA 0xa0 ;
        /*0090*/                   STS.128 [R5], R8 ;
        /*00a0*/                   ISETP.GE.AND P2, PT, R3, 0x4, PT ;
        /*00b0*/              @!P2 BRA 0x110 ;
        /*00c0*/                   LDS.128 R8, [R5] ;
        /*00d0*/                   MUFU.EX2 R6, R8 ;
        /*00e0*/                   FMUL R7, R6, R9 ;
        /*00f0*/                   ISETP.GE.AND P3, PT, R6, 0x4, PT ;
        /*0100*/              @!P3 BRA 0xc0 ;
        /*0110*/                   IADD3 R3, R3, 0x1, RZ ;
        /*0120*/                   ISETP.GE.AND P4, PT, R3, 0x3, PT ;
        /*0130*/              @!P4 BRA 0x50 ;
        /*0140*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0150*/                   ISETP.GE.AND P5, PT, R1, 0x3, PT ;
        /*0160*/              @!P5 BRA 0x30 ;
        /*0170*/                   LDS.128 R8, [R5] ;
        /*0180*/                   MUFU.EX2 R6, R8 ;
        /*0190*/                   FMUL R7, R6, R9 ;
        /*01a0*/                   FADD R7, R7, R9 ;
        /*01b0*/                   ISETP.GE.AND P6, PT, R6, 0x4, PT ;
        /*01c0*/              @!P6 BRA 0x170 ;
        /*01d0*/                   STG.E desc[UR6][R10.64], R7 ;
        /*01e0*/                   EXIT ;
        /*01f0*/                   BRA 0x1f0;
"""


def test_split_cfg_loops():
    cfg = sass.Cfg(sass.parse(SPLIT_LISTING)["_Z17fake_split_kernelPf"])
    assert {h: sorted(b) for h, (b, _) in cfg.loops.items()} == {
        0x30: [0x30, 0x50, 0x90, 0xa0, 0xc0, 0x110, 0x140],
        0x50: [0x50, 0x90, 0xa0, 0xc0, 0x110], 0xc0: [0xc0],
        0x170: [0x170]}
    assert sorted(cfg.innermost("MUFU.EX2")) == [0xc0, 0x170]
    assert cfg.parent(0xc0) == 0x50 and cfg.parent(0x170) is None


def test_split_counts():
    # test loop's short path 0x50 + 0xa0 + 0x110: issue 9, fma 1, alu 5;
    # the append 0x90: issue 1; a drained entry, the cheaper of the drain
    # loops per class (0xc0; 0x170): issue 5, fma 1, alu 1, xu 1;
    # the cell loop around the test loop, 0x30 and 0x140: issue 5, fma 1,
    # fmaheavy 1, alu 2
    got = sass.split_counts(SPLIT_LISTING, "fake_split", 6, 2.5, around=2)
    assert got == {"issue": 6 * 9 + 2.5 * (1 + 5) + 2 * 5,
                   "fma": 6 * 1 + 2.5 * 1 + 2 * 1, "fmaheavy": 2 * 1,
                   "alu": 6 * 5 + 2.5 * 1 + 2 * 2, "xu": 2.5 * 1}
    alone = sass.split_counts(SPLIT_LISTING, "fake_split", 1, 1.0)
    assert alone == {"issue": 9 + 6.0, "fma": 1 + 1.0, "fmaheavy": 0.0,
                     "alu": 5 + 1.0, "xu": 1.0}


def test_split_counts_needs_the_loops_it_is_given():
    # the fake lattice kernel's innermost expf loop (its impulse loop) has
    # a cell loop around it, but the cell loop has none around it
    with pytest.raises(ValueError, match="no loop around"):
        sass.split_counts(LISTING, "fake_lattice", 6, 2.5, around=1)
    with pytest.raises(ValueError, match="no drain loop"):
        sass.split_counts(SPLIT_LISTING.replace("@!P5 BRA 0x30", "NOP")
                          .replace("@!P4 BRA 0x50", "NOP"), "fake_split",
                          1, 1.0)
    with pytest.raises(ValueError, match="kernels match"):
        sass.split_counts(SPLIT_LISTING, "no_such_kernel", 1, 1.0)


# K8's shape: a load loop (LDG, STS, FMUL); the round loop: the rotation's
# step (LDS, MUFU.RCP64H, DMUL, F2F, STS), a barrier, an A block's body
# (LDS, FMUL, FADD, STS) and a V unit's body (LDS.64, DMUL, DADD, STS.64),
# each behind a guard, and a barrier; a reduction loop without a store; and
# an output loop (STG).
JACOBI = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_118jacobi_eigh_kernelILi34ELi128EEEvPKfPfS3_Pii
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDG.E R1, desc[UR4][R2.64] ;
        /*0010*/                   FMUL R1, R1, 0.5 ;
        /*0020*/                   STS [R3], R1 ;
        /*0030*/                   ISETP.GE.AND P0, PT, R3, 0x10, PT ;
        /*0040*/              @!P0 BRA 0x0 ;
        /*0050*/                   ISETP.GT.AND P1, PT, R0, 0x10, PT ;
        /*0060*/               @P1 BRA 0xb0 ;
        /*0070*/                   LDS R4, [R5] ;
        /*0080*/                   MUFU.RCP64H R7, R5 ;
        /*0090*/                   DMUL R8, R6, R6 ;
        /*00a0*/                   F2F.F32.F64 R9, R8 ;
        /*00b0*/                   STS [R5], R9 ;
        /*00c0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00d0*/               @P1 BRA 0x130 ;
        /*00e0*/                   LDS R4, [R5] ;
        /*00f0*/                   FMUL R6, R4, R7 ;
        /*0100*/                   IMAD R10, R4, 0x29, R6 ;
        /*0110*/                   FADD R6, R6, R8 ;
        /*0120*/                   STS [R5], R6 ;
        /*0130*/               @P1 BRA 0x190 ;
        /*0140*/                   LDS.64 R10, [R5] ;
        /*0150*/                   DMUL R12, R10, R14 ;
        /*0160*/                   DADD R12, R12, R16 ;
        /*0170*/                   LEA R5, R5, R9, 0x3 ;
        /*0180*/                   STS.64 [R5], R12 ;
        /*0190*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*01a0*/                   ISETP.GE.AND P2, PT, R5, R9, PT ;
        /*01b0*/              @!P2 BRA 0x50 ;
        /*01c0*/                   LDS R4, [R5] ;
        /*01d0*/                   FMUL R6, R4, R4 ;
        /*01e0*/                   ISETP.GE.AND P3, PT, R5, R9, PT ;
        /*01f0*/              @!P3 BRA 0x1c0 ;
        /*0200*/                   LDS R4, [R5] ;
        /*0210*/                   STG.E desc[UR4][R2.64], R4 ;
        /*0220*/                   ISETP.GE.AND P4, PT, R5, R9, PT ;
        /*0230*/              @!P4 BRA 0x200 ;
        /*0240*/                   EXIT ;
"""


def test_jacobi_counts():
    a_block, v_unit = sass.jacobi_counts(JACOBI, "jacobi_eigh_kernelILi34")
    assert a_block == {"issue": 5, "fma": 3, "fmaheavy": 1, "alu": 0,
                       "xu": 0}
    assert v_unit == {"issue": 5, "fma": 0, "fmaheavy": 0, "alu": 1,
                      "xu": 0}
    with pytest.raises(ValueError, match="round loops"):
        sass.jacobi_counts(JACOBI.replace("BAR.SYNC.DEFER_BLOCKING 0x0",
                                          "NOP"), "jacobi_eigh_kernelILi34")
    with pytest.raises(ValueError, match="V unit"):
        sass.jacobi_counts(JACOBI.replace("DADD R12, R12, R16", "F2F R12, R12"),
                           "jacobi_eigh_kernelILi34")


# JACOBI with a second A block's body in the round loop (LDS, FMUL, three
# ALU instructions, STS: more issued and fewer FMA-pipe instructions than
# the first)
JACOBI_TWO_BODIES = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_118jacobi_eigh_kernelILi34ELi128EEEvPKfPfS3_Pii
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDG.E R1, desc[UR4][R2.64] ;
        /*0010*/                   FMUL R1, R1, 0.5 ;
        /*0020*/                   STS [R3], R1 ;
        /*0030*/                   ISETP.GE.AND P0, PT, R3, 0x10, PT ;
        /*0040*/              @!P0 BRA 0x0 ;
        /*0050*/                   ISETP.GT.AND P1, PT, R0, 0x10, PT ;
        /*0060*/               @P1 BRA 0xb0 ;
        /*0070*/                   LDS R4, [R5] ;
        /*0080*/                   MUFU.RCP64H R7, R5 ;
        /*0090*/                   DMUL R8, R6, R6 ;
        /*00a0*/                   F2F.F32.F64 R9, R8 ;
        /*00b0*/                   STS [R5], R9 ;
        /*00c0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00d0*/               @P1 BRA 0x130 ;
        /*00e0*/                   LDS R4, [R5] ;
        /*00f0*/                   FMUL R6, R4, R7 ;
        /*0100*/                   IMAD R10, R4, 0x29, R6 ;
        /*0110*/                   FADD R6, R6, R8 ;
        /*0120*/                   STS [R5], R6 ;
        /*0130*/               @P1 BRA 0x1a0 ;
        /*0140*/                   LDS R4, [R5] ;
        /*0150*/                   FMUL R6, R4, R7 ;
        /*0160*/                   LOP3.LUT R10, R4, 0xff, RZ, 0xc0, !PT ;
        /*0170*/                   SHF.R.U32.HI R11, RZ, 0x8, R4 ;
        /*0180*/                   IADD3 R10, R10, R11, RZ ;
        /*0190*/                   STS [R10], R6 ;
        /*01a0*/               @P1 BRA 0x200 ;
        /*01b0*/                   LDS.64 R10, [R5] ;
        /*01c0*/                   DMUL R12, R10, R14 ;
        /*01d0*/                   DADD R12, R12, R16 ;
        /*01e0*/                   LEA R5, R5, R9, 0x3 ;
        /*01f0*/                   STS.64 [R5], R12 ;
        /*0200*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0210*/                   ISETP.GE.AND P2, PT, R5, R9, PT ;
        /*0220*/              @!P2 BRA 0x50 ;
        /*0230*/                   LDS R4, [R5] ;
        /*0240*/                   STG.E desc[UR4][R2.64], R4 ;
        /*0250*/                   ISETP.GE.AND P4, PT, R5, R9, PT ;
        /*0260*/              @!P4 BRA 0x230 ;
        /*0270*/                   EXIT ;
"""


def test_jacobi_counts_are_one_body():
    # the counts are the first A body's, the one that issues fewer, not a
    # mix of the two bodies' smallest counts by class (fma 1, alu 0)
    a_block, _ = sass.jacobi_counts(JACOBI_TWO_BODIES,
                                    "jacobi_eigh_kernelILi34")
    assert a_block == {"issue": 5, "fma": 3, "fmaheavy": 1, "alu": 0,
                       "xu": 0}
    # two more IMADs in the first body: the second now issues fewer
    longer = JACOBI_TWO_BODIES.replace(
        "IMAD R10, R4, 0x29, R6", "IMAD R10, R4, 0x29, R6 ;\n"
        "        /*0104*/                   IMAD R10, R4, 0x29, R6 ;\n"
        "        /*0108*/                   IMAD R10, R4, 0x29, R6")
    assert sass.jacobi_counts(longer, "jacobi_eigh_kernelILi34")[0] == {
        "issue": 6, "fma": 1, "fmaheavy": 0, "alu": 3, "xu": 0}
