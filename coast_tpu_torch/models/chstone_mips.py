"""CHStone mips: a MIPS interpreter as a torch region (BASELINE config 4).

The counterpart of ``coast_tpu/models/chstone_mips.py``: interpret the
44-word text segment of imem.h (a bubble sort over A[8]) one instruction
a region step until pc == 0, then check ``main_result`` = (n_inst == 611)
+ 8 matches of dmem against outData.  The opcode switch is a set of
masked selects: every class computed, one committed.

The C quirks the reference keeps: ``reg`` is int, so SRL/SRLV are
arithmetic shifts; shift amounts are masked to 5 bits; the fetch and the
load are ``jnp.take(mode="clip")`` on word addresses made with a logical
shift; SLTU/SLTIU compare unsigned; MULT/MULTU take the unsigned high
word (``ops/u32.py`` ``umulhi``) with the signed correction; the register
and store writes are ``.at[].set(mode="drop")``; ``reg[0]`` is forced to
0 after every instruction.  Its basic-block graph (``graph``,
read by CFCSS) is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from coast_tpu_torch.interop import state_from_numpy
from coast_tpu_torch.ir.graph import BlockGraph, pick
from coast_tpu_torch.ir.region import (KIND_CTRL, KIND_MEM, KIND_REG,
                                       KIND_RO, LeafSpec, Region)
from coast_tpu_torch.models.common import Consts
from coast_tpu_torch.ops.indexing import take_clip, update_drop
from coast_tpu_torch.ops.u32 import lsr, mullo, ult, umulhi
from coast_tpu_torch.passes.verification import RegionDataflow

# The 44-word text segment of imem.h (main + compare_swap bubble sort).
IMEM = [
    0x8fa40000, 0x27a50004, 0x24a60004, 0x00041080, 0x00c23021, 0x0c100016,
    0x00000000, 0x3402000a, 0x0000000c, 0x3c011001, 0x34280000, 0x00044880,
    0x01094821, 0x8d2a0000, 0x00055880, 0x010b5821, 0x8d6c0000, 0x018a682a,
    0x11a00003, 0xad2c0000, 0xad6a0000, 0x03e00008, 0x27bdfff4, 0xafbf0008,
    0xafb10004, 0xafb00000, 0x24100000, 0x2a080008, 0x1100000b, 0x26110001,
    0x2a280008, 0x11000006, 0x26040000, 0x26250000, 0x0c100009, 0x26310001,
    0x0810001e, 0x26100001, 0x0810001b, 0x8fbf0008, 0x8fb10004, 0x8fb00000,
    0x27bd000c, 0x03e00008,
]

A_IN = [22, 5, -9, 3, -17, 38, 0, 11]
OUT_DATA = [-17, -9, 0, 3, 5, 11, 22, 38]
N_INST_GOLDEN = 611      # mips.c:297

# Equal to the reference's analyze() (pinned in tests/test_torch_baseline.py).
DATAFLOW = RegionDataflow(
    written=frozenset({"dmem", "hi", "lo", "n_inst", "pc", "regs"}),
    deps={
        "imem": frozenset({"imem"}),
        "a_in": frozenset({"a_in"}),
        "out_data": frozenset({"out_data"}),
        "regs": frozenset({"dmem", "hi", "imem", "lo", "pc", "regs"}),
        "dmem": frozenset({"dmem", "imem", "pc", "regs"}),
        "pc": frozenset({"dmem", "hi", "imem", "lo", "pc", "regs"}),
        "n_inst": frozenset({"n_inst", "pc"}),
        "hi": frozenset({"dmem", "hi", "imem", "lo", "pc", "regs"}),
        "lo": frozenset({"dmem", "hi", "imem", "lo", "pc", "regs"}),
    },
    load_addr=frozenset({"imem", "pc", "regs"}),
    store_addr=frozenset({"imem", "pc", "regs"}))


def _select(cases, default):
    """``jnp.select``: the value of the first case whose condition holds."""
    out = default
    for cond, val in reversed(cases):
        out = torch.where(cond, val, out)
    return out


# The reference's basic-block partition of the program's 44 instructions
# (block number by instruction index): 1 startup, 2 exit_seq, 3 cs_head,
# 4 cs_swap, 5 cs_ret, 6 main_pro, 7 outer_head, 8 outer_body,
# 9 inner_head, 10 call_cs, 11 after_call, 12 outer_inc, 13 main_epi;
# 14 is exit (pc == 0).
_BLK_OF_IDX = np.asarray(
    [1] * 6 + [2] * 3 + [3] * 10 + [4] * 2 + [5] + [6] * 5 + [7] * 2
    + [8] + [9] * 2 + [10] * 3 + [11] * 2 + [12] * 2 + [13] * 5, np.int32)

GRAPH_NAMES = ["entry", "startup", "exit_seq", "cs_head", "cs_swap",
               "cs_ret", "main_pro", "outer_head", "outer_body",
               "inner_head", "call_cs", "after_call", "outer_inc",
               "main_epi", "exit"]
GRAPH_EDGES = [(0, 1), (1, 6),                     # jal main
               (6, 7), (7, 8), (7, 13),            # outer loop head
               (8, 9), (9, 10), (9, 12),           # inner loop head
               (10, 3), (3, 4), (3, 5), (4, 5),    # compare_swap body
               (5, 11), (11, 9),                   # jr $ra -> after jal
               (12, 7), (13, 2), (2, 14),          # epilogue -> halt
               # One step is one instruction: staying inside a
               # multi-instruction block is the self-transition.
               (1, 1), (2, 2), (3, 3), (4, 4), (6, 6), (7, 7), (9, 9),
               (10, 10), (11, 11), (12, 12), (13, 13)]


def make_region() -> Region:
    blocks = Consts(blk=_BLK_OF_IDX)
    regs0 = np.zeros(32, np.int32)
    regs0[29] = 0x7FFFEFFC
    dmem0 = np.zeros(64, np.int32)
    dmem0[:8] = A_IN
    image = {
        "imem": np.asarray(IMEM, np.uint32).view(np.int32),
        "regs": regs0,
        "dmem": dmem0,
        "a_in": np.asarray(A_IN, np.int32),
        "out_data": np.asarray(OUT_DATA, np.int32),
        "pc": np.int32(0x00400000),
        "hi": np.int32(0),
        "lo": np.int32(0),
        "n_inst": np.int32(0),
    }

    def init(device):
        return state_from_numpy(image, device)

    def step(state, t):
        pc, regs, dmem = state["pc"], state["regs"], state["dmem"]
        running = pc != 0
        zero = torch.zeros_like(pc)

        ins = take_clip(state["imem"], lsr(pc & 0xFF, 2))
        op = lsr(ins, 26)
        funct = ins & 0x3F
        shamt = (ins >> 6) & 0x1F
        rd = (ins >> 11) & 0x1F
        rt = (ins >> 16) & 0x1F
        rs = (ins >> 21) & 0x1F
        addr_u = ins & 0xFFFF                       # zero-extended
        addr_s = (addr_u ^ 0x8000) - 0x8000         # sign-extended short
        vrs, vrt = take_clip(regs, torch.stack([rs, rt], dim=1)).unbind(1)
        pc1 = pc + 4

        # R-type (op == 0).
        sh_s = shamt & 31
        sh_r = vrs & 31
        r_vals = [
            (33, vrs + vrt),                        # ADDU
            (35, vrs - vrt),                        # SUBU
            (16, state["hi"]),                      # MFHI
            (18, state["lo"]),                      # MFLO
            (36, vrs & vrt),                        # AND
            (37, vrs | vrt),                        # OR
            (38, vrs ^ vrt),                        # XOR
            (0, vrt << sh_s),                       # SLL
            (2, vrt >> sh_s),                       # SRL (C int >>)
            (4, vrt << sh_r),                       # SLLV
            (6, vrt >> sh_r),                       # SRLV (C int >>)
            (42, (vrs < vrt).to(torch.int32)),      # SLT
            (43, ult(vrs, vrt).to(torch.int32)),    # SLTU
        ]
        r_hits = [funct == f for f, _ in r_vals]
        r_val = _select(list(zip(r_hits, [v for _, v in r_vals])), zero)
        r_reg_write = torch.stack(r_hits).any(dim=0)
        is_mult = (funct == 24) | (funct == 25)
        lo_new = mullo(vrs, vrt)
        hi_u = umulhi(vrs, vrt)
        hi_signed = (hi_u - torch.where(vrs < 0, vrt, zero)
                     - torch.where(vrt < 0, vrs, zero))
        hi_new = torch.where(funct == 24, hi_signed, hi_u)
        is_jr = funct == 8
        r_known = r_reg_write | is_mult | is_jr
        r_pc = torch.where(is_jr, vrs, torch.where(r_known, pc1, zero))

        # J / JAL (op 2, 3).
        tgt = (ins & 0x3FFFFFF) << 2
        # I-type.
        daddr = lsr((vrs + addr_s) & 0xFF, 2)
        lw_val = take_clip(dmem, daddr)
        i_vals = [
            (9, vrs + addr_s),                          # ADDIU
            (12, vrs & addr_u),                         # ANDI
            (13, vrs | addr_u),                         # ORI
            (14, vrs ^ addr_u),                         # XORI
            (35, lw_val),                               # LW
            (15, addr_u << 16),                         # LUI
            (10, (vrs < addr_s).to(torch.int32)),       # SLTI
            (11, ult(vrs, addr_u).to(torch.int32)),     # SLTIU
        ]
        i_hits = [op == o for o, _ in i_vals]
        i_reg_write = torch.stack(i_hits).any(dim=0)
        i_val = _select(list(zip(i_hits, [v for _, v in i_vals])), zero)
        is_sw = op == 43
        is_beq, is_bne, is_bgez = op == 4, op == 5, op == 1
        btaken = _select([(is_beq, vrs == vrt), (is_bne, vrs != vrt),
                          (is_bgez, vrs >= 0)], torch.zeros_like(running))
        is_branch = is_beq | is_bne | is_bgez
        i_known = i_reg_write | is_sw | is_branch
        i_pc = torch.where(is_branch & btaken, pc1 - 4 + (addr_s << 2),
                           torch.where(i_known, pc1, zero))

        is_r, is_j, is_jal = op == 0, op == 2, op == 3

        # Register write: rd for R-type, rt for I-type, $31 for JAL.
        wr_en = torch.where(is_r, r_reg_write,
                            is_jal | (~is_j & i_reg_write))
        wr_idx = torch.where(is_r, rd, torch.where(is_jal, 31, rt))
        # The scalar results (the write-back word, hi, lo and the next pc)
        # are selected as one vector.  (The reference's scalar selects share
        # one traced helper, which its propagation walk reads as one value;
        # this keeps the equivalence partition's modes equal to the
        # reference's.)
        mult = is_r & is_mult
        wr_val, new_hi, new_lo, new_pc = torch.where(
            torch.stack([is_r, mult, mult, is_r]),
            torch.stack([r_val, hi_new, lo_new, r_pc]),
            torch.stack([torch.where(is_jal, pc1, i_val), state["hi"],
                         state["lo"],
                         torch.where(is_j | is_jal, tgt, i_pc)])).unbind(0)
        regs_w = update_drop(regs, wr_idx, wr_val)
        new_regs = torch.where((running & wr_en)[:, None], regs_w, regs)
        new_regs = torch.cat([torch.zeros_like(new_regs[:, :1]),
                              new_regs[:, 1:]], dim=1)   # reg[0] = 0

        dmem_w = update_drop(dmem, daddr, vrt)
        new_dmem = torch.where((running & ~is_r & is_sw)[:, None], dmem_w,
                               dmem)

        return {
            "regs": new_regs,
            "dmem": new_dmem,
            "hi": torch.where(running, new_hi, state["hi"]),
            "lo": torch.where(running, new_lo, state["lo"]),
            "pc": torch.where(running, new_pc, pc),
            "n_inst": state["n_inst"] + torch.where(running, 1, 0).to(
                torch.int32),
        }

    def done(state):
        return state["pc"] == 0

    def check(state):
        main_result = ((state["n_inst"] == N_INST_GOLDEN).to(torch.int32)
                       + (state["dmem"][:, :8] == state["out_data"]
                          ).sum(dim=1).to(torch.int32))
        return 9 - main_result

    def output(state):
        return torch.cat([state["dmem"][:, :8], state["n_inst"][:, None]],
                         dim=1)

    def block_of(state):
        pc = state["pc"]
        idx = (pc & 0xFF) >> 2               # non-negative: a logical shift
        table = blocks.on(pc.device).blk
        return pick(pc == 0, 14,
                    table[torch.clamp(idx, 0, len(table) - 1).long()])

    return Region(
        name="chstone_mips",
        init=init,
        step=step,
        done=done,
        check=check,
        output=output,
        nominal_steps=N_INST_GOLDEN,
        max_steps=1536,
        spec={
            "imem": LeafSpec(KIND_RO),
            "a_in": LeafSpec(KIND_RO),
            "out_data": LeafSpec(KIND_RO),
            # In-SoR local arrays: stores to them are store sync points.
            "regs": LeafSpec(KIND_MEM),
            "dmem": LeafSpec(KIND_MEM),
            "pc": LeafSpec(KIND_CTRL),
            "n_inst": LeafSpec(KIND_CTRL),
            "hi": LeafSpec(KIND_REG),
            "lo": LeafSpec(KIND_REG),
        },
        default_xmr=True,
        graph=BlockGraph(names=GRAPH_NAMES, edges=GRAPH_EDGES,
                         block_of=block_of),
        meta={"oracle": "RESULT: PASS", "dataflow": DATAFLOW},
    )
