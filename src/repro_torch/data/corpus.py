"""The port's copy of `repro.data.corpus` (imports rewritten, nothing
else changed). BinaryCorp stand-in: functions × optimization levels with official-style
train/test splits, triplet sampling for Stage-1 fine-tuning, and token-batch
iterators for pre-training.

Determinism contract: every sample is a pure function of (split, seed,
step), so a restarted (or elastically re-scaled) job replays the exact
same stream — the fault-tolerance layer relies on this.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.asmgen import OPT_LEVELS, PROFILES, Function, gen_function
from repro_torch.data.isa import stable_hash

# NOTE: repro_torch.core.tokenizer is imported lazily inside the
# constructor — tokenizer.py itself depends on repro_torch.data.isa, and an
# eager import here would close an import cycle through the two packages'
# __init__ modules.

_PROFILE_NAMES = sorted(PROFILES)


@dataclass
class CorpusExample:
    fid: int
    opt_level: str
    tokens: np.ndarray      # (n_blocks, max_len, 6)
    lengths: np.ndarray     # (n_blocks,)


class SyntheticBinaryCorp:
    """Deterministic corpus of `n_functions`, each at 5 optimization levels."""

    def __init__(self, n_functions: int = 2000, max_len: int = 128,
                 train_frac: float = 0.9, seed: int = 0,
                 tokenizer=None):
        from repro_torch.core.tokenizer import default_tokenizer
        self.n_functions = n_functions
        self.max_len = max_len
        self.seed = seed
        self.tok = tokenizer or default_tokenizer()
        rng = np.random.RandomState(stable_hash("corpus-split", seed))
        perm = rng.permutation(n_functions)
        n_train = int(n_functions * train_frac)
        self.train_fids = np.sort(perm[:n_train])
        self.test_fids = np.sort(perm[n_train:])

    # ------------------------------------------------------------------ utils

    def _profile_for(self, fid: int) -> str:
        return _PROFILE_NAMES[stable_hash("prof", self.seed, fid) % len(_PROFILE_NAMES)]

    def function(self, fid: int, opt_level: str) -> Function:
        return gen_function(fid, opt_level=opt_level,
                            profile_name=self._profile_for(fid))

    def encode_function(self, fid: int, opt_level: str) -> CorpusExample:
        f = self.function(fid, opt_level)
        toks = self.tok.encode_blocks(f.blocks, self.max_len)
        return CorpusExample(fid=fid, opt_level=opt_level, tokens=toks,
                             lengths=self.tok.lengths(toks))

    # --------------------------------------------------- pre-training batches

    def pretrain_batch(self, step: int, batch_size: int, split: str = "train"
                       ) -> Dict[str, np.ndarray]:
        """Token batches for Next-Token/Next-Instruction prediction.

        Returns tokens (B, L, 6) and targets derived by the task heads.
        """
        fids = self.train_fids if split == "train" else self.test_fids
        rng = np.random.RandomState(stable_hash("pre", self.seed, split, step))
        toks = np.zeros((batch_size, self.max_len, 6), dtype=np.int32)
        for i in range(batch_size):
            fid = int(fids[rng.randint(len(fids))])
            lvl = OPT_LEVELS[rng.randint(len(OPT_LEVELS))]
            f = self.function(fid, lvl)
            b = f.blocks[rng.randint(len(f.blocks))]
            toks[i] = self.tok.encode_block(b, self.max_len)
        return {"tokens": toks, "lengths": self.tok.lengths(toks)}

    # ------------------------------------------------------- triplet batches

    def triplet_batch(self, step: int, batch_size: int, split: str = "train"
                      ) -> Dict[str, np.ndarray]:
        """(anchor, positive, negative) blocks following jTrans methodology:
        anchor/positive = same function, different optimization levels;
        negative = a different function."""
        fids = self.train_fids if split == "train" else self.test_fids
        rng = np.random.RandomState(stable_hash("tri", self.seed, split, step))
        out = {k: np.zeros((batch_size, self.max_len, 6), dtype=np.int32)
               for k in ("anchor", "positive", "negative")}
        for i in range(batch_size):
            fa = int(fids[rng.randint(len(fids))])
            fn = int(fids[rng.randint(len(fids))])
            while fn == fa:
                fn = int(fids[rng.randint(len(fids))])
            la, lp = rng.choice(len(OPT_LEVELS), size=2, replace=False)
            func_a = self.function(fa, OPT_LEVELS[la])
            func_p = self.function(fa, OPT_LEVELS[lp])
            func_n = self.function(fn, OPT_LEVELS[rng.randint(len(OPT_LEVELS))])
            # anchor/positive: corresponding blocks (same index => same skeleton)
            bi = rng.randint(min(len(func_a.blocks), len(func_p.blocks)))
            out["anchor"][i] = self.tok.encode_block(func_a.blocks[bi], self.max_len)
            out["positive"][i] = self.tok.encode_block(func_p.blocks[bi], self.max_len)
            out["negative"][i] = self.tok.encode_block(
                func_n.blocks[rng.randint(len(func_n.blocks))], self.max_len)
        return out

    # ------------------------------------------------------------- BCSD eval

    def bcsd_pool(self, pair: Tuple[str, str], n_queries: int, pool_size: int,
                  seed: int = 0) -> Dict[str, np.ndarray]:
        """Retrieval test set for one optimization pair (e.g. ("O0","O3")).

        Query i (level pair[0]) must retrieve its counterpart (level
        pair[1]) from a pool of `pool_size` candidates (counterpart +
        distractors from other functions).
        """
        rng = np.random.RandomState(stable_hash("bcsd", seed, *pair))
        fids = self.test_fids if len(self.test_fids) >= pool_size else \
            np.arange(self.n_functions)
        chosen = rng.choice(len(fids), size=min(pool_size, len(fids)), replace=False)
        pool_fids = fids[chosen]
        q_idx = rng.choice(len(pool_fids), size=min(n_queries, len(pool_fids)),
                           replace=False)
        return {
            "pool_fids": pool_fids.astype(np.int64),
            "query_positions": q_idx.astype(np.int64),
            "query_level": pair[0],
            "pool_level": pair[1],
        }
