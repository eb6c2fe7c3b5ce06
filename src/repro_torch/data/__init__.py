# The port's own copies of the numpy-only data modules of `repro.data`
# (isa, asmgen, trace, perfmodel), with imports rewritten: the port
# imports nothing of `repro`. Same seeds give the same programs, blocks,
# intervals and CPIs as the originals (tests/test_torch_service.py).
from repro_torch.data.isa import (
    Instruction,
    BasicBlock,
    Operand,
    INSTR_CLASSES,
    OPCODES,
)
from repro_torch.data.asmgen import gen_function, gen_program, Function, Program, PROFILES, spec_programs
from repro_torch.data.trace import trace_program, Interval
from repro_torch.data.perfmodel import CPUModel, INORDER_CPU, O3_CPU, interval_cpi
