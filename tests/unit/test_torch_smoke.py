"""``bhr_tpu_torch.bench.parse_sass_loops`` (which ``chip_smoke.py``
reads the built library with): the ray-march loop's instruction
counts, read from ``cuobjdump -sass`` text, on which the kernel's issue
bound rests.

The SASS below is written by hand in ``cuobjdump``'s format: a loop from
0x10 to its back-branch at 0xd0, with a break out of the loop, the fast
and slow (CALL) paths of a correctly rounded operation, and a crossing
block that a step can skip; one branch target is a label.
"""

from bhr_tpu_torch import bench

SASS = """
        Function : _ZN45_GLOBAL__N__0_ray_march_cu_09ray_marchILb0ELb1ELb0EEEvNS_6ParamsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   MUFU.RSQ R2, R3 ;        /* 0x0000000300027308 */
        /*0020*/                   FFMA R4, R2, R2, R4 ;    /* 0x0000000202047223 */
        /*0030*/               @P0 BRA 0xe0 ;               /* 0x000000a000000947 */
        /*0040*/               @P3 BRA 0x70 ;               /* 0x0000002000000947 */
        /*0050*/                   CALL.REL.NOINC 0xf0 ;    /* 0x0000009000007944 */
        /*0060*/                   BRA 0xa0 ;               /* 0x0000003000007947 */
        /*0070*/                   FFMA R5, R2, R4, R5 ;    /* 0x0000000402057223 */
        /*0080*/                   FFMA R5, R2, R5, R5 ;    /* 0x0000000502057223 */
        /*0090*/                   FFMA R5, R4, R5, R2 ;    /* 0x0000000504057223 */
        /*00a0*/              @!P1 BRA `(.L_x_1) ;          /* 0x0000002000008947 */
        /*00b0*/                   FADD R6, R6, R5 ;        /* 0x0000000506067221 */
        /*00c0*/                   FMUL R6, R6, R5 ;        /* 0x0000000506067220 */
.L_x_1:
        /*00d0*/              @!P2 BRA 0x10 ;               /* 0xffffff3000008947 */
        /*00e0*/                   EXIT ;                   /* 0x000000000000794d */
        /*00f0*/                   NOP ;                    /* 0x0000000000007918 */
        /*0100*/                   RET.REL.NODEC R2 0x0 ;   /* 0xffffffc002007950 */
"""


def test_parse_sass_loops_counts_the_loop_and_its_fewest_instructions():
    counts = bench.parse_sass_loops(SASS)
    assert counts == {"ray_march_slim": {
        # 0x10..0xd0: 13 instructions; MUFU.RSQ; FFMA x4, FADD, FMUL.
        "total": 13, "mufu": 1, "fp32": 6,
        # The fast path (3 FFMA) and the crossing skipped: 9. The slow
        # path's stub is shorter (CALL, BRA) but issues its callee too.
        "step": 9, "step_mufu": 1,
        # To the break at 0x30: MUFU, FFMA, BRA.
        "last": 3, "last_mufu": 1,
    }}
