"""The port's front door: ``System`` / ``Session`` over a ``ServeSpec``."""
from repro_torch.api.events import DoneEvent, RoundEvent, ServeResult, SessionResult, TokenEvent
from repro_torch.api.spec import ModelSpec, ServeSpec, SpecError
from repro_torch.api.system import (
    KitCache,
    ModelBundle,
    Session,
    System,
    build_draft_variant,
    build_models,
)

__all__ = [
    "DoneEvent",
    "KitCache",
    "ModelBundle",
    "ModelSpec",
    "RoundEvent",
    "ServeResult",
    "ServeSpec",
    "Session",
    "SessionResult",
    "SpecError",
    "System",
    "TokenEvent",
    "build_draft_variant",
    "build_models",
]
