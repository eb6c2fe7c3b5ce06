"""The system under test as the drivers build it: the Stage-1 encoder and
the Stage-2 model of a configuration, made without drawing weights
(on the meta device), then given the benchmark's weights on the card
through `load_state_dict`; and the traffic's blocks as the system's
`BasicBlock`s.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from chipbench import weights
from chipbench.traffic.isa import stable_hash


def stage_configs(config: dict):
    from repro_torch.core.bbe import BBEConfig
    from repro_torch.core.signature import SignatureConfig
    s1 = dict(config["stage1"], dim_embeds=tuple(config["stage1"]["dim_embeds"]))
    return BBEConfig(**s1), SignatureConfig(**config["stage2"])


def with_weights(module: torch.nn.Module, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Gives `module` (built on meta) weights drawn from `seed` on
    `device`; returns them, as stored, for the reference."""
    module.to_empty(device=device)
    drawn = weights.draw(module.state_dict(), seed, device)
    module.load_state_dict(drawn)
    return drawn


def encoder(config: dict, seed: int, device):
    from repro_torch.core.bbe import BBEEncoder
    bcfg, _ = stage_configs(config)
    with torch.device("meta"):
        enc = BBEEncoder(bcfg)
    return enc, with_weights(enc, stable_hash("stage1", seed), device)


def signature_model(config: dict, seed: int, device):
    from repro_torch.core.signature import SignatureModel
    _, scfg = stage_configs(config)
    with torch.device("meta"):
        sig = SignatureModel(scfg)
    return sig, with_weights(sig, stable_hash("stage2", seed), device)


class Blocks:
    """The traffic's instructions as the system's, made once each, so a
    block is a slice of a list of the system's instructions."""

    def __init__(self):
        from repro_torch.data import isa
        self.isa = isa
        self._made: Dict[int, object] = {}

    def instruction(self, ins):
        # keyed by identity; the entry holds `ins`, so its id stays its own
        got = self._made.get(id(ins))
        if got is None:
            isa = self.isa
            got = (isa.Instruction(ins.opcode, tuple(
                isa.Operand(o.kind, reg=o.reg, index=o.index, value=o.value)
                for o in ins.operands)), ins)
            self._made[id(ins)] = got
        return got[0]

    def instructions(self, instrs) -> List[object]:
        return [self.instruction(i) for i in instrs]

    def block(self, bid: int, instrs) -> object:
        return self.isa.BasicBlock(bid=bid, instrs=instrs)
