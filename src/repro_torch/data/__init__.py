# The port's own copies of the numpy-only data modules of `repro.data`
# (isa, asmgen, trace, perfmodel, corpus), with imports rewritten, and of
# its loader (torch.distributed's rank where JAX reads its process): the
# port imports nothing of `repro`. Same seeds give the same programs,
# blocks, intervals, CPIs and corpus batches as the originals
# (tests/test_torch_service.py, tests/test_torch_stage1.py).
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
from repro_torch.data.corpus import CorpusExample, SyntheticBinaryCorp
from repro_torch.data.loader import BatchLoader, host_slice
