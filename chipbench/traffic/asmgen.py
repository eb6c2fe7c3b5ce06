"""Deterministic synthetic program / function generator.

Produces BinaryCorp-like material: functions compiled at five optimization
levels (O0, O1, O2, O3, Os) where all levels share the function's semantic
skeleton (same computation graph / memory behavior) but differ in register
allocation, scheduling, spills, strength reduction and unrolling — exactly
the variation the paper's triplet objective must become invariant to.

Programs (for tracing / SPEC-like benchmarks) add CFG structure: nested
loops with iteration weights, phases (mixtures over hot loops), and
per-phase memory working sets that drive the performance models.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from chipbench.traffic.isa import (
    BRANCH_OPS, GPRS, SP, XMMS, BasicBlock, Instruction, Operand, stable_hash,
)

OPT_LEVELS = ("O0", "O1", "O2", "O3", "Os")

# Workload profiles (application-type analogues: compiler, browser, crypto,
# media, simulation, compression ...). Each profile fixes the instruction
# mix and memory behavior distribution of generated code.
PROFILES: Dict[str, dict] = {
    "int_compute": dict(fp=0.02, mem=0.25, branchy=0.5, ws=(1 << 14, 1 << 19), mem_kinds=("seq", "stride")),
    "fp_compute": dict(fp=0.55, mem=0.25, branchy=0.2, ws=(1 << 15, 1 << 21), mem_kinds=("seq", "stride")),
    "pointer_chase": dict(fp=0.02, mem=0.45, branchy=0.4, ws=(1 << 20, 1 << 25), mem_kinds=("random",)),
    "streaming": dict(fp=0.25, mem=0.40, branchy=0.15, ws=(1 << 22, 1 << 26), mem_kinds=("seq",)),
    "branchy_int": dict(fp=0.01, mem=0.20, branchy=0.8, ws=(1 << 13, 1 << 17), mem_kinds=("seq", "random")),
    "crypto": dict(fp=0.0, mem=0.10, branchy=0.1, ws=(1 << 12, 1 << 14), mem_kinds=("seq",)),
    "mixed": dict(fp=0.15, mem=0.30, branchy=0.45, ws=(1 << 14, 1 << 23), mem_kinds=("seq", "stride", "random")),
}


# ---------------------------------------------------------------------------
# Semantic skeleton: an abstract dataflow the optimizer variants all realize
# ---------------------------------------------------------------------------

@dataclass
class _AbstractOp:
    kind: str       # "alu" | "mul" | "div" | "load" | "store" | "fp" | "fpdiv" | "cmp"
    op: str         # concrete opcode family chosen at generation
    srcs: Tuple[int, ...]   # indices of producer ops (dataflow)
    imm: Optional[int] = None


def _gen_skeleton(rng: np.random.RandomState, n_ops: int, profile: dict) -> List[_AbstractOp]:
    """Random DAG of abstract ops; shared across optimization levels."""
    ops: List[_AbstractOp] = []
    int_alu = ["add", "sub", "and", "or", "xor", "shl"]
    fp_alu = ["addss", "subss", "mulss", "addsd", "mulsd"]
    for i in range(n_ops):
        r = rng.rand()
        nsrc = min(i, rng.randint(1, 3)) if i else 0
        srcs = tuple(int(rng.randint(0, i)) for _ in range(nsrc)) if i else ()
        if r < profile["fp"]:
            if rng.rand() < 0.12:
                ops.append(_AbstractOp("fpdiv", "divss", srcs))
            else:
                ops.append(_AbstractOp("fp", fp_alu[rng.randint(len(fp_alu))], srcs))
        elif r < profile["fp"] + profile["mem"]:
            if rng.rand() < 0.65:
                ops.append(_AbstractOp("load", "mov", srcs[:1]))
            else:
                ops.append(_AbstractOp("store", "mov", srcs[:1]))
        elif rng.rand() < 0.07:
            ops.append(_AbstractOp("mul", "imul", srcs, imm=int(2 ** rng.randint(1, 4))))
        elif rng.rand() < 0.02:
            ops.append(_AbstractOp("div", "idiv", srcs))
        else:
            ops.append(_AbstractOp("alu", int_alu[rng.randint(len(int_alu))], srcs,
                                   imm=int(rng.randint(1, 255)) if rng.rand() < 0.4 else None))
    return ops


# ---------------------------------------------------------------------------
# Lowering a skeleton to concrete instructions per optimization level
# ---------------------------------------------------------------------------

def _lower(skeleton: List[_AbstractOp], level: str, rng: np.random.RandomState,
           mem_kind: str, working_set: int) -> List[Instruction]:
    """Realize the abstract dataflow at a given optimization level."""
    instrs: List[Instruction] = []
    # register allocation: O0 spills everything to the stack; higher levels
    # allocate rotating register sets (renamed differently per level so the
    # encoder cannot shortcut on exact register names).
    gpr_pool = list(GPRS)
    xmm_pool = list(XMMS)
    if level != "O0":
        rot = rng.randint(1, len(gpr_pool))
        gpr_pool = gpr_pool[rot:] + gpr_pool[:rot]
        rot = rng.randint(1, len(xmm_pool))
        xmm_pool = xmm_pool[rot:] + xmm_pool[:rot]

    def reg_for(i: int, fp: bool) -> str:
        pool = xmm_pool if fp else gpr_pool
        return pool[i % len(pool)]

    def mem_operand(i: int) -> Operand:
        disp = int((i * 8) % max(64, working_set))
        if mem_kind == "random":
            base = gpr_pool[(i * 7 + 3) % len(gpr_pool)]
            return Operand("mem", reg=base, value=disp)
        if mem_kind == "stride":
            return Operand("mem", reg=gpr_pool[0], index=gpr_pool[1], value=disp)
        return Operand("mem", reg=gpr_pool[0], value=disp)

    spill = level == "O0"
    for i, op in enumerate(skeleton):
        fp = op.kind in ("fp", "fpdiv")
        dst = Operand("reg", reg=reg_for(i, fp))
        if spill and op.srcs:
            # O0 reloads sources from stack slots before each use
            for s in op.srcs[:1]:
                instrs.append(Instruction("mov", (Operand("reg", reg=reg_for(s, fp)),
                                                  Operand("mem", reg=SP, value=8 * (s % 16)))))
        if op.kind == "load":
            instrs.append(Instruction("movss" if fp else "mov", (dst, mem_operand(i))))
        elif op.kind == "store":
            src = Operand("reg", reg=reg_for(op.srcs[0] if op.srcs else i, fp))
            instrs.append(Instruction("movss" if fp else "mov", (mem_operand(i), src)))
        elif op.kind == "mul":
            if level in ("O2", "O3") and op.imm and op.imm & (op.imm - 1) == 0:
                # strength reduction: imul by power of two -> shl
                instrs.append(Instruction("shl", (dst, Operand("imm", value=int(op.imm).bit_length() - 1))))
            else:
                src = Operand("reg", reg=reg_for(op.srcs[0] if op.srcs else i, False))
                instrs.append(Instruction("imul", (dst, src)))
        elif op.kind == "div":
            instrs.append(Instruction("idiv", (Operand("reg", reg=reg_for(op.srcs[0] if op.srcs else i, False)),)))
        elif op.kind == "fpdiv":
            src = Operand("reg", reg=reg_for(op.srcs[0] if op.srcs else i, True))
            instrs.append(Instruction("divss", (dst, src)))
        else:  # alu / fp
            if op.imm is not None and not fp:
                instrs.append(Instruction(op.op, (dst, Operand("imm", value=op.imm))))
            else:
                src = Operand("reg", reg=reg_for(op.srcs[0] if op.srcs else i, fp))
                instrs.append(Instruction(op.op, (dst, src)))
        if spill:
            # O0 stores every result back to its stack slot
            instrs.append(Instruction("mov", (Operand("mem", reg=SP, value=8 * (i % 16)),
                                              Operand("reg", reg=dst.reg))))

    if level in ("O2", "O3"):
        # instruction scheduling: deterministic interleave of independent ops
        instrs = _schedule(instrs)
    if level == "O3" and len(instrs) >= 4:
        # partial unroll: duplicate body with shifted registers
        dup = [_rename(ins, 5, gpr_pool, xmm_pool) for ins in instrs]
        instrs = instrs + dup
    if level == "Os":
        # size-optimized: drop every k-th redundant mov
        instrs = [ins for j, ins in enumerate(instrs)
                  if not (ins.opcode == "mov" and j % 4 == 3)]
    return instrs


def _schedule(instrs: List[Instruction]) -> List[Instruction]:
    """Pairwise swap of independent adjacent instructions (list scheduling lite)."""
    out = list(instrs)
    for j in range(0, len(out) - 1, 2):
        a, b = out[j], out[j + 1]
        da, ua = a.defs_uses()
        db, ub = b.defs_uses()
        if not (set(da) & set(ub)) and not (set(db) & set(ua)) and not (set(da) & set(db)):
            out[j], out[j + 1] = b, a
    return out


def _rename(ins: Instruction, shift: int, gprs: List[str], xmms: List[str]) -> Instruction:
    def sub(o: Operand) -> Operand:
        def rr(r):
            if r is None or r == SP:
                return r
            if r in gprs:
                return gprs[(gprs.index(r) + shift) % len(gprs)]
            if r in xmms:
                return xmms[(xmms.index(r) + shift) % len(xmms)]
            return r
        return Operand(o.kind, reg=rr(o.reg), index=rr(o.index), value=o.value)
    return Instruction(ins.opcode, tuple(sub(o) for o in ins.operands))


# ---------------------------------------------------------------------------
# Functions (BCSD corpus unit)
# ---------------------------------------------------------------------------

@dataclass
class Function:
    fid: int
    opt_level: str
    blocks: List[BasicBlock]

    def render(self) -> str:
        return "\n".join(b.render() for b in self.blocks)


def gen_function(fid: int, opt_level: str = "O0", profile_name: str = "mixed",
                 n_blocks: Optional[int] = None) -> Function:
    """Generate a function at a given optimization level.

    All levels of the same `fid` share skeletons (semantics); levels differ
    in lowering. Determinism: everything derives from stable_hash(fid,...).
    """
    profile = PROFILES[profile_name]
    srng = np.random.RandomState(stable_hash("func", fid))
    nb = n_blocks or int(srng.randint(2, 7))
    mem_kinds = profile["mem_kinds"]
    lo, hi = profile["ws"]
    blocks: List[BasicBlock] = []
    lrng = np.random.RandomState(stable_hash("lower", fid, opt_level))
    for b in range(nb):
        brng = np.random.RandomState(stable_hash("blk", fid, b))
        n_ops = int(brng.randint(3, 14))
        skel = _gen_skeleton(brng, n_ops, profile)
        mem_kind = mem_kinds[brng.randint(len(mem_kinds))]
        ws = int(2 ** brng.uniform(np.log2(lo), np.log2(hi)))
        instrs = _lower(skel, opt_level, lrng, mem_kind, ws)
        # terminator
        bias = float(np.clip(brng.beta(2, 2), 0.05, 0.95))
        if b == nb - 1:
            instrs.append(Instruction("ret"))
        elif brng.rand() < profile["branchy"]:
            instrs.append(Instruction("cmp", (Operand("reg", reg=GPRS[brng.randint(len(GPRS))]),
                                              Operand("imm", value=int(brng.randint(0, 255))))))
            instrs.append(Instruction(BRANCH_OPS[brng.randint(len(BRANCH_OPS))],
                                      (Operand("label", value=b + 1),)))
        else:
            instrs.append(Instruction("jmp", (Operand("label", value=b + 1),)))
        blocks.append(BasicBlock(bid=stable_hash("bid", fid, opt_level, b),
                                 instrs=instrs, mem_behavior=(mem_kind, ws),
                                 branch_bias=bias))
    return Function(fid=fid, opt_level=opt_level, blocks=blocks)


# ---------------------------------------------------------------------------
# Programs (SPEC-like benchmark unit, for tracing)
# ---------------------------------------------------------------------------

@dataclass
class Loop:
    """A hot loop: blocks + relative within-loop frequencies."""
    blocks: List[BasicBlock]
    weights: np.ndarray  # relative execution frequency of each block


@dataclass
class Phase:
    """A program phase: mixture over loops + memory pressure scalar."""
    loop_mix: np.ndarray       # prob of each loop
    working_scale: float       # scales block working sets during this phase
    duration: int              # number of intervals this phase lasts


@dataclass
class Program:
    name: str
    pid: int
    profile_name: str
    loops: List[Loop]
    phases: List[Phase]

    @property
    def unique_blocks(self) -> List[BasicBlock]:
        seen, out = set(), []
        for lp in self.loops:
            for b in lp.blocks:
                if b.bid not in seen:
                    seen.add(b.bid)
                    out.append(b)
        return out


def gen_program(pid: int, profile_name: str = "mixed", name: Optional[str] = None,
                n_loops: int = 6, n_phases: int = 5,
                opt_level: str = "O2") -> Program:
    """A benchmark program = hot loops + a phase schedule over them."""
    rng = np.random.RandomState(stable_hash("prog", pid))
    loops: List[Loop] = []
    for li in range(n_loops):
        # each loop reuses function machinery for its body blocks
        f = gen_function(stable_hash("loopfn", pid, li), opt_level=opt_level,
                         profile_name=profile_name,
                         n_blocks=int(rng.randint(2, 6)))
        w = rng.dirichlet(np.ones(len(f.blocks)) * 2.0)
        loops.append(Loop(blocks=f.blocks, weights=w))
    phases: List[Phase] = []
    for ph in range(n_phases):
        prng = np.random.RandomState(stable_hash("phase", pid, ph))
        alpha = np.full(n_loops, 0.3)
        alpha[prng.randint(n_loops)] += 6.0  # one dominant loop per phase
        phases.append(Phase(
            loop_mix=prng.dirichlet(alpha),
            working_scale=float(2 ** prng.uniform(-1.0, 2.0)),
            duration=int(prng.randint(3, 9)),
        ))
    return Program(name=name or f"bench{pid:03d}", pid=pid,
                   profile_name=profile_name, loops=loops, phases=phases)


# The 10 SPEC CPU 2017 integer-suite analogues used in cross-program
# experiments (profile choices mirror each benchmark's well-known behavior).
SPEC_INT_LIKE = [
    ("600.perlbench", "branchy_int"),
    ("602.gcc", "mixed"),
    ("605.mcf", "pointer_chase"),
    ("620.omnetpp", "pointer_chase"),
    ("623.xalancbmk", "branchy_int"),
    ("625.x264", "fp_compute"),
    ("631.deepsjeng", "int_compute"),
    ("641.leela", "int_compute"),
    ("648.exchange2", "crypto"),
    ("657.xz", "streaming"),
]

SPEC_FP_LIKE = [
    ("603.bwaves", "fp_compute"),
    ("607.cactuBSSN", "fp_compute"),
    ("619.lbm", "streaming"),
    ("621.wrf", "mixed"),
    ("627.cam4", "mixed"),
    ("628.pop2", "pointer_chase"),
    ("638.imagick", "fp_compute"),
    ("644.nab", "fp_compute"),
    ("649.fotonik3d", "streaming"),
]


def spec_programs(which: str = "int") -> List[Program]:
    table = SPEC_INT_LIKE if which == "int" else SPEC_FP_LIKE
    return [gen_program(stable_hash("spec", name), profile_name=prof, name=name,
                        n_loops=8, n_phases=6)
            for name, prof in table]
