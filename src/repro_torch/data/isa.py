"""Synthetic x86-64-like ISA.

BinaryCorp (the paper's corpus) is unavailable offline, so the framework
ships a deterministic ISA + program generator that preserves everything
SemanticBBV's methodology depends on: basic blocks with single entry/exit,
register def-use structure, instruction classes with distinct performance
behavior, immediates/addresses that must be IMM-normalized, and
optimization-level variants of the same function.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Registers
# ---------------------------------------------------------------------------

GPRS = ["rax", "rbx", "rcx", "rdx", "rsi", "rdi", "r8", "r9", "r10", "r11",
        "r12", "r13", "r14", "r15"]
SP, BP = "rsp", "rbp"
XMMS = [f"xmm{i}" for i in range(16)]
ALL_REGS = GPRS + [SP, BP] + XMMS


def register_type(reg: str) -> str:
    if reg == SP:
        return "sp"
    if reg == BP:
        return "bp"
    if reg.startswith("xmm"):
        return "xmm"
    return "gpr"


# ---------------------------------------------------------------------------
# Opcodes: name -> (class, latency, sets_flags, reads_flags)
# classes: mov, alu, mul, div, lea, cmp, branch, jmp, load, store, stack,
#          fpalu, fpmul, fpdiv, call, ret, nop
# ---------------------------------------------------------------------------

OPCODES: Dict[str, Tuple[str, int, bool, bool]] = {
    "mov":   ("mov", 1, False, False),
    "movzx": ("mov", 1, False, False),
    "add":   ("alu", 1, True, False),
    "sub":   ("alu", 1, True, False),
    "and":   ("alu", 1, True, False),
    "or":    ("alu", 1, True, False),
    "xor":   ("alu", 1, True, False),
    "shl":   ("alu", 1, True, False),
    "shr":   ("alu", 1, True, False),
    "sar":   ("alu", 1, True, False),
    "inc":   ("alu", 1, True, False),
    "dec":   ("alu", 1, True, False),
    "neg":   ("alu", 1, True, False),
    "imul":  ("mul", 3, True, False),
    "idiv":  ("div", 24, True, False),
    "lea":   ("lea", 1, False, False),
    "cmp":   ("cmp", 1, True, False),
    "test":  ("cmp", 1, True, False),
    "je":    ("branch", 1, False, True),
    "jne":   ("branch", 1, False, True),
    "jl":    ("branch", 1, False, True),
    "jle":   ("branch", 1, False, True),
    "jg":    ("branch", 1, False, True),
    "jge":   ("branch", 1, False, True),
    "jb":    ("branch", 1, False, True),
    "jae":   ("branch", 1, False, True),
    "jmp":   ("jmp", 1, False, False),
    "push":  ("stack", 1, False, False),
    "pop":   ("stack", 1, False, False),
    "call":  ("call", 2, False, False),
    "ret":   ("ret", 2, False, False),
    "nop":   ("nop", 1, False, False),
    "addss": ("fpalu", 4, False, False),
    "subss": ("fpalu", 4, False, False),
    "mulss": ("fpmul", 4, False, False),
    "divss": ("fpdiv", 14, False, False),
    "addsd": ("fpalu", 4, False, False),
    "mulsd": ("fpmul", 4, False, False),
    "movss": ("mov", 1, False, False),
    "sqrtss": ("fpdiv", 12, False, False),
    "cvtsi2ss": ("fpalu", 4, False, False),
}

INSTR_CLASSES = sorted({v[0] for v in OPCODES.values()})
CLASS_INDEX = {c: i for i, c in enumerate(INSTR_CLASSES)}

BRANCH_OPS = [op for op, v in OPCODES.items() if v[0] == "branch"]
TERMINATORS = set(BRANCH_OPS) | {"jmp", "ret"}


# ---------------------------------------------------------------------------
# Operands / instructions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Operand:
    kind: str  # "reg" | "mem" | "imm" | "label"
    reg: Optional[str] = None          # reg kind, or mem base register
    index: Optional[str] = None        # mem index register
    value: int = 0                     # imm value / mem displacement / label id

    def render(self) -> str:
        if self.kind == "reg":
            return self.reg
        if self.kind == "imm":
            return str(self.value)
        if self.kind == "label":
            return f".L{self.value}"
        if self.index is not None:
            return f"[{self.reg}+{self.index}*8+{self.value}]"
        return f"[{self.reg}+{self.value}]"


@dataclass(frozen=True)
class Instruction:
    opcode: str
    operands: Tuple[Operand, ...] = ()

    @property
    def iclass(self) -> str:
        return OPCODES[self.opcode][0]

    @property
    def latency(self) -> int:
        return OPCODES[self.opcode][1]

    def render(self) -> str:
        if not self.operands:
            return self.opcode
        return f"{self.opcode} " + ", ".join(o.render() for o in self.operands)

    def is_load(self) -> bool:
        # memory source operand (2nd operand mem, or pop)
        if self.opcode == "pop":
            return True
        return len(self.operands) >= 2 and self.operands[1].kind == "mem"

    def is_store(self) -> bool:
        if self.opcode == "push":
            return True
        return len(self.operands) >= 1 and self.operands[0].kind == "mem" \
            and self.opcode not in ("cmp", "test")

    def defs_uses(self) -> Tuple[List[str], List[str]]:
        """(defined regs, used regs) — approximate def-use for dep chains."""
        defs: List[str] = []
        uses: List[str] = []
        ops = self.operands
        if self.opcode in ("cmp", "test"):
            for o in ops:
                if o.kind == "reg":
                    uses.append(o.reg)
                elif o.kind == "mem":
                    uses.append(o.reg)
        elif ops:
            dst = ops[0]
            if dst.kind == "reg":
                defs.append(dst.reg)
                if self.opcode not in ("mov", "movzx", "movss", "lea", "pop"):
                    uses.append(dst.reg)  # read-modify-write
            elif dst.kind == "mem":
                uses.append(dst.reg)
                if dst.index:
                    uses.append(dst.index)
            for o in ops[1:]:
                if o.kind == "reg":
                    uses.append(o.reg)
                elif o.kind == "mem":
                    uses.append(o.reg)
                    if o.index:
                        uses.append(o.index)
        return defs, uses


# ---------------------------------------------------------------------------
# Basic blocks
# ---------------------------------------------------------------------------

@dataclass
class BasicBlock:
    """Single-entry single-exit instruction sequence.

    `mem_behavior` is generator metadata consumed by the perf model:
    ("seq" | "stride" | "random", working_set_bytes).
    `branch_bias` is the taken-probability of the terminating branch.
    """
    bid: int
    instrs: List[Instruction]
    mem_behavior: Tuple[str, int] = ("seq", 4096)
    branch_bias: float = 0.5
    _features: Optional[dict] = field(default=None, repr=False)

    def render(self) -> str:
        return "\n".join(i.render() for i in self.instrs)

    @property
    def num_instrs(self) -> int:
        return len(self.instrs)

    def key(self) -> str:
        """Content hash — identical code in different programs collides
        (deliberately: that is what makes blocks cross-program comparable)."""
        return format(zlib.crc32(self.render().encode()) & 0xFFFFFFFF, "08x")

    def features(self) -> dict:
        """Static per-block features used by the performance models."""
        if self._features is not None:
            return self._features
        counts = {c: 0 for c in INSTR_CLASSES}
        loads = stores = 0
        for ins in self.instrs:
            counts[ins.iclass] += 1
            loads += ins.is_load()
            stores += ins.is_store()
        # longest register dependency chain (cycles), greedy scan
        ready: Dict[str, float] = {}
        depth = 0.0
        for ins in self.instrs:
            defs, uses = ins.defs_uses()
            start = max([ready.get(u, 0.0) for u in uses], default=0.0)
            end = start + ins.latency
            for d in defs:
                ready[d] = end
            depth = max(depth, end)
        n = max(1, len(self.instrs))
        self._features = dict(
            n=n,
            counts=counts,
            loads=loads,
            stores=stores,
            dep_depth=depth,
            ilp=(sum(OPCODES[i.opcode][1] for i in self.instrs)) / max(depth, 1.0),
            mem_kind=self.mem_behavior[0],
            working_set=self.mem_behavior[1],
            branch_bias=self.branch_bias,
        )
        return self._features


def stable_hash(*parts) -> int:
    """Deterministic 32-bit hash for seeding (python hash() is salted)."""
    s = "\x1f".join(str(p) for p in parts)
    return zlib.crc32(s.encode()) & 0x7FFFFFFF
