# repro_torch.api — the service surface of the port.
#   store.py      SignatureStore: signatures on the device + lifecycle
#   knowledge.py  KnowledgeBase: build/attach/estimate over archetypes
#   lifecycle.py  EvictionPolicy / vacuum: TTL+LRU eviction, compaction
#   service.py    SemanticBBVService facade + typed ServiceConfig
from repro_torch.api.knowledge import (
    CPIEstimate, KnowledgeBase, assign_signatures,
)
from repro_torch.api.lifecycle import (
    EvictionPolicy, VacuumReport, select_victims, vacuum,
)
from repro_torch.api.service import SemanticBBVService, ServiceConfig
from repro_torch.api.store import SignatureStore

__all__ = [
    "CPIEstimate", "EvictionPolicy", "KnowledgeBase", "SemanticBBVService",
    "ServiceConfig", "SignatureStore", "VacuumReport", "assign_signatures",
    "select_victims", "vacuum",
]
