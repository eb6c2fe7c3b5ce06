"""Multi-dimensional assembly tokenization (paper §III-A-1).

Each assembly token is represented along SIX parallel dimensions whose
embeddings are concatenated by the encoder:

  0. asm    — the token itself (opcode mnemonic, register, `IMM`, or a
              composite memory token like `[rsp+IMM]` kept as ONE token so
              its implicit base-register dependency is preserved)
  1. itype  — class of the parent instruction (alu/mov/load/store/...)
  2. otype  — role of the token (opcode / reg operand / mem operand / imm)
  3. rtype  — register type (none/gpr/sp/bp/xmm)
  4. atype  — access type (none/read/write/readwrite)
  5. flags  — flag behavior of the parent instruction (none/sets/reads)

Immediates and displacements are normalized to `IMM` (no OOV), memory
operands collapse to `[base+IMM]` / `[base+index*8+IMM]` composites.
Boundary punctuation ("[", "]", ",") is never emitted — the structure
lives in the feature dimensions instead, keeping sequences short and the
vocabulary tiny (Table I).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.isa import (
    ALL_REGS, BasicBlock, Instruction, OPCODES, register_type,
)

# dimension vocabularies -----------------------------------------------------

ITYPES = ["none"] + sorted({v[0] for v in OPCODES.values()})
OTYPES = ["none", "opcode", "reg", "mem", "imm", "label"]
RTYPES = ["none", "gpr", "sp", "bp", "xmm"]
ATYPES = ["none", "read", "write", "readwrite"]
FLAGS = ["none", "sets", "reads", "both"]

PAD, BOS, EOS, SEP = "<pad>", "<bos>", "<eos>", "<sep>"
SPECIALS = [PAD, BOS, EOS, SEP]

NUM_DIMS = 6


def _build_asm_vocab() -> List[str]:
    vocab = list(SPECIALS)
    vocab += sorted(OPCODES)
    vocab += ALL_REGS
    vocab += ["IMM", "LABEL"]
    # composite memory tokens: [base+IMM] for all bases, plus every
    # (base, index) combination — still a tiny vocabulary (Table I)
    gpr_like = [r for r in ALL_REGS if not r.startswith("xmm")]
    vocab += [f"[{r}+IMM]" for r in gpr_like]
    vocab += [f"[{r}+{i}*8+IMM]" for r in gpr_like for i in gpr_like]
    vocab += ["[UNK]"]
    return vocab


@dataclass(frozen=True)
class TokenizerSpec:
    asm_vocab: Tuple[str, ...]
    dim_sizes: Tuple[int, ...]

    @property
    def pad_id(self) -> int:
        return 0

    @property
    def bos_id(self) -> int:
        return 1

    @property
    def eos_id(self) -> int:
        return 2

    @property
    def sep_id(self) -> int:
        return 3


class MultiDimTokenizer:
    """Instruction stream -> (T, 6) int32 feature matrix."""

    def __init__(self):
        self.asm_vocab = _build_asm_vocab()
        self.asm_index: Dict[str, int] = {t: i for i, t in enumerate(self.asm_vocab)}
        self.itype_index = {t: i for i, t in enumerate(ITYPES)}
        self.otype_index = {t: i for i, t in enumerate(OTYPES)}
        self.rtype_index = {t: i for i, t in enumerate(RTYPES)}
        self.atype_index = {t: i for i, t in enumerate(ATYPES)}
        self.flags_index = {t: i for i, t in enumerate(FLAGS)}
        self.spec = TokenizerSpec(
            asm_vocab=tuple(self.asm_vocab),
            dim_sizes=(len(self.asm_vocab), len(ITYPES), len(OTYPES),
                       len(RTYPES), len(ATYPES), len(FLAGS)),
        )

    # -- token level ---------------------------------------------------------

    def _asm_id(self, tok: str) -> int:
        return self.asm_index.get(tok, self.asm_index["[UNK]"])

    def _special(self, tok: str) -> Tuple[int, ...]:
        return (self.asm_index[tok], 0, 0, 0, 0, 0)

    def encode_instruction(self, ins: Instruction) -> List[Tuple[int, ...]]:
        iclass, _, sets_f, reads_f = OPCODES[ins.opcode]
        fl = "both" if (sets_f and reads_f) else "sets" if sets_f \
            else "reads" if reads_f else "none"
        it = self.itype_index[iclass]
        fi = self.flags_index[fl]
        toks: List[Tuple[int, ...]] = [(
            self._asm_id(ins.opcode), it, self.otype_index["opcode"],
            0, 0, fi,
        )]
        for oi, op in enumerate(ins.operands):
            # access type: first operand of most ops is written (or RMW)
            if op.kind == "mem":
                acc = "write" if (oi == 0 and ins.is_store()) else "read"
            elif oi == 0 and iclass not in ("cmp", "branch", "jmp"):
                acc = "write" if iclass in ("mov", "lea") else "readwrite"
            else:
                acc = "read"
            ai = self.atype_index[acc]
            if op.kind == "reg":
                toks.append((self._asm_id(op.reg), it, self.otype_index["reg"],
                             self.rtype_index[register_type(op.reg)], ai, fi))
            elif op.kind == "imm":
                toks.append((self._asm_id("IMM"), it, self.otype_index["imm"],
                             0, ai, fi))
            elif op.kind == "label":
                toks.append((self._asm_id("LABEL"), it, self.otype_index["label"],
                             0, ai, fi))
            else:  # memory: normalized composite token
                if op.index is not None:
                    t = f"[{op.reg}+{op.index}*8+IMM]"
                else:
                    t = f"[{op.reg}+IMM]"
                toks.append((self._asm_id(t), it, self.otype_index["mem"],
                             self.rtype_index[register_type(op.reg)], ai, fi))
        return toks

    # -- block level -----------------------------------------------------------

    def encode_block(self, block: BasicBlock, max_len: int = 128,
                     add_special: bool = True) -> np.ndarray:
        """-> (max_len, 6) int32, PAD-padded; row 0 dim0==pad_id marks pad."""
        rows: List[Tuple[int, ...]] = []
        if add_special:
            rows.append(self._special(BOS))
        for ins in block.instrs:
            rows.extend(self.encode_instruction(ins))
            rows.append(self._special(SEP))  # instruction boundary marker
        if add_special:
            rows.append(self._special(EOS))
        rows = rows[:max_len]
        out = np.zeros((max_len, NUM_DIMS), dtype=np.int32)
        out[: len(rows)] = np.asarray(rows, dtype=np.int32)
        return out

    def encode_blocks(self, blocks: Sequence[BasicBlock], max_len: int = 128
                      ) -> np.ndarray:
        return np.stack([self.encode_block(b, max_len) for b in blocks])

    def lengths(self, encoded: np.ndarray) -> np.ndarray:
        """Valid-token counts for a batch encoded by encode_blocks."""
        return (encoded[..., 0] != self.spec.pad_id).sum(-1).astype(np.int32)

    def embedding_param_count(self, dims: Sequence[int]) -> int:
        """Embedding-table parameters given per-dimension embed widths."""
        return int(sum(v * d for v, d in zip(self.spec.dim_sizes, dims)))


_DEFAULT: MultiDimTokenizer = None


def default_tokenizer() -> MultiDimTokenizer:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MultiDimTokenizer()
    return _DEFAULT
