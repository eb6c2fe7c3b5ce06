# repro_torch.api — the service surface of the port.
#   store.py      SignatureStore: signatures on the device + tombstones
#   knowledge.py  KnowledgeBase: build/attach/estimate over archetypes
#   service.py    SemanticBBVService facade + typed ServiceConfig
from repro_torch.api.knowledge import (
    CPIEstimate, KnowledgeBase, assign_signatures,
)
from repro_torch.api.service import SemanticBBVService, ServiceConfig
from repro_torch.api.store import SignatureStore

__all__ = [
    "CPIEstimate", "KnowledgeBase", "SemanticBBVService", "ServiceConfig",
    "SignatureStore", "assign_signatures",
]
