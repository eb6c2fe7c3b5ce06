"""The benchmark's frozen copy of the system's synthetic corpus, the
BinaryCorp stand-in: `n_functions` functions, each compiled at five
optimization levels, with a seeded train/test split and a profile per
function. Every sample is a pure function of the seed.

`pretrain_pool` is the vectorised set-up form of the corpus's
pre-training batches: every basic block of the training functions at
every level, tokenized once, duplicates dropped, so that a step's batch
is a seeded draw of rows from the pool.
"""
from __future__ import annotations

import numpy as np

from chipbench.reference import tokenizer
from chipbench.traffic.asmgen import OPT_LEVELS, PROFILES, Function, gen_function
from chipbench.traffic.isa import stable_hash

_PROFILE_NAMES = sorted(PROFILES)


class SyntheticBinaryCorp:
    """Deterministic corpus of `n_functions`, each at 5 optimization levels."""

    def __init__(self, n_functions: int = 2000, max_len: int = 128,
                 train_frac: float = 0.9, seed: int = 0):
        self.n_functions = n_functions
        self.max_len = max_len
        self.seed = seed
        rng = np.random.RandomState(stable_hash("corpus-split", seed))
        perm = rng.permutation(n_functions)
        n_train = int(n_functions * train_frac)
        self.train_fids = np.sort(perm[:n_train])
        self.test_fids = np.sort(perm[n_train:])

    def _profile_for(self, fid: int) -> str:
        return _PROFILE_NAMES[stable_hash("prof", self.seed, fid) % len(_PROFILE_NAMES)]

    def function(self, fid: int, opt_level: str) -> Function:
        return gen_function(fid, opt_level=opt_level,
                            profile_name=self._profile_for(fid))


def pretrain_pool(corp: SyntheticBinaryCorp) -> np.ndarray:
    """(rows, max_len, 6) int32: every block of every training function at
    every level, tokenized, each distinct row once, in a fixed order."""
    rows = [tokenizer.encode_block(b, corp.max_len)
            for fid in corp.train_fids for lvl in OPT_LEVELS
            for b in corp.function(int(fid), lvl).blocks]
    pool = np.stack(rows)
    _, first = np.unique(pool.reshape(len(pool), -1), axis=0,
                         return_index=True)
    return pool[np.sort(first)]
