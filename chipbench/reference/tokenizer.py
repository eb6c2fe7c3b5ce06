"""The reference's own multi-dimensional tokenizer (paper §III-A-1): a
frozen copy of the rules of the system's tokenizer, with the ISA tables
it needs, so that the reference derives a block's tokens from the block
itself.

A block is anything with `.instrs`, a list of instructions with
`.opcode` and `.operands`, each operand with `.kind` ("reg", "mem",
"imm", "label"), `.reg` and `.index`. Six token dimensions: asm token,
instruction class, operand role, register type, access type, flags.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

GPRS = ["rax", "rbx", "rcx", "rdx", "rsi", "rdi", "r8", "r9", "r10", "r11",
        "r12", "r13", "r14", "r15"]
SP, BP = "rsp", "rbp"
XMMS = [f"xmm{i}" for i in range(16)]
ALL_REGS = GPRS + [SP, BP] + XMMS

# opcode -> (class, latency, sets_flags, reads_flags)
OPCODES: Dict[str, Tuple[str, int, bool, bool]] = {
    "mov": ("mov", 1, False, False), "movzx": ("mov", 1, False, False),
    "add": ("alu", 1, True, False), "sub": ("alu", 1, True, False),
    "and": ("alu", 1, True, False), "or": ("alu", 1, True, False),
    "xor": ("alu", 1, True, False), "shl": ("alu", 1, True, False),
    "shr": ("alu", 1, True, False), "sar": ("alu", 1, True, False),
    "inc": ("alu", 1, True, False), "dec": ("alu", 1, True, False),
    "neg": ("alu", 1, True, False), "imul": ("mul", 3, True, False),
    "idiv": ("div", 24, True, False), "lea": ("lea", 1, False, False),
    "cmp": ("cmp", 1, True, False), "test": ("cmp", 1, True, False),
    "je": ("branch", 1, False, True), "jne": ("branch", 1, False, True),
    "jl": ("branch", 1, False, True), "jle": ("branch", 1, False, True),
    "jg": ("branch", 1, False, True), "jge": ("branch", 1, False, True),
    "jb": ("branch", 1, False, True), "jae": ("branch", 1, False, True),
    "jmp": ("jmp", 1, False, False), "push": ("stack", 1, False, False),
    "pop": ("stack", 1, False, False), "call": ("call", 2, False, False),
    "ret": ("ret", 2, False, False), "nop": ("nop", 1, False, False),
    "addss": ("fpalu", 4, False, False), "subss": ("fpalu", 4, False, False),
    "mulss": ("fpmul", 4, False, False), "divss": ("fpdiv", 14, False, False),
    "addsd": ("fpalu", 4, False, False), "mulsd": ("fpmul", 4, False, False),
    "movss": ("mov", 1, False, False), "sqrtss": ("fpdiv", 12, False, False),
    "cvtsi2ss": ("fpalu", 4, False, False),
}

ITYPES = ["none"] + sorted({v[0] for v in OPCODES.values()})
OTYPES = ["none", "opcode", "reg", "mem", "imm", "label"]
RTYPES = ["none", "gpr", "sp", "bp", "xmm"]
ATYPES = ["none", "read", "write", "readwrite"]
FLAGS = ["none", "sets", "reads", "both"]
SPECIALS = ["<pad>", "<bos>", "<eos>", "<sep>"]
PAD_ID, BOS_ID, EOS_ID, SEP_ID = 0, 1, 2, 3


def register_type(reg: str) -> str:
    if reg == SP:
        return "sp"
    if reg == BP:
        return "bp"
    return "xmm" if reg.startswith("xmm") else "gpr"


def asm_vocab() -> List[str]:
    gpr_like = [r for r in ALL_REGS if not r.startswith("xmm")]
    return (SPECIALS + sorted(OPCODES) + ALL_REGS + ["IMM", "LABEL"]
            + [f"[{r}+IMM]" for r in gpr_like]
            + [f"[{r}+{i}*8+IMM]" for r in gpr_like for i in gpr_like]
            + ["[UNK]"])


ASM = {t: i for i, t in enumerate(asm_vocab())}
DIM_SIZES = (len(ASM), len(ITYPES), len(OTYPES), len(RTYPES), len(ATYPES),
             len(FLAGS))


def _is_store(ins) -> bool:
    if ins.opcode == "push":
        return True
    ops = ins.operands
    return len(ops) >= 1 and ops[0].kind == "mem" and \
        ins.opcode not in ("cmp", "test")


def instruction_tokens(ins) -> List[Tuple[int, ...]]:
    iclass, _, sets_f, reads_f = OPCODES[ins.opcode]
    fl = "both" if (sets_f and reads_f) else "sets" if sets_f \
        else "reads" if reads_f else "none"
    it, fi = ITYPES.index(iclass), FLAGS.index(fl)
    unk = ASM["[UNK]"]
    rows = [(ASM.get(ins.opcode, unk), it, OTYPES.index("opcode"), 0, 0, fi)]
    for oi, op in enumerate(ins.operands):
        if op.kind == "mem":
            acc = "write" if (oi == 0 and _is_store(ins)) else "read"
        elif oi == 0 and iclass not in ("cmp", "branch", "jmp"):
            acc = "write" if iclass in ("mov", "lea") else "readwrite"
        else:
            acc = "read"
        ai = ATYPES.index(acc)
        if op.kind == "reg":
            rows.append((ASM.get(op.reg, unk), it, OTYPES.index("reg"),
                         RTYPES.index(register_type(op.reg)), ai, fi))
        elif op.kind == "imm":
            rows.append((ASM["IMM"], it, OTYPES.index("imm"), 0, ai, fi))
        elif op.kind == "label":
            rows.append((ASM["LABEL"], it, OTYPES.index("label"), 0, ai, fi))
        else:
            t = (f"[{op.reg}+{op.index}*8+IMM]" if op.index is not None
                 else f"[{op.reg}+IMM]")
            rows.append((ASM.get(t, unk), it, OTYPES.index("mem"),
                         RTYPES.index(register_type(op.reg)), ai, fi))
    return rows


def encode_block(block, max_len: int) -> np.ndarray:
    """(max_len, 6) int32: BOS, each instruction's tokens then SEP, EOS;
    cut at max_len, padded with 0."""
    rows = [(BOS_ID, 0, 0, 0, 0, 0)]
    for ins in block.instrs:
        rows.extend(instruction_tokens(ins))
        rows.append((SEP_ID, 0, 0, 0, 0, 0))
    rows.append((EOS_ID, 0, 0, 0, 0, 0))
    rows = rows[:max_len]
    out = np.zeros((max_len, 6), np.int32)
    out[:len(rows)] = np.asarray(rows, np.int32)
    return out


def encode_blocks(blocks: Sequence, max_len: int) -> np.ndarray:
    if not blocks:
        return np.zeros((0, max_len, 6), np.int32)
    return np.stack([encode_block(b, max_len) for b in blocks])
