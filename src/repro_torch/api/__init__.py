"""The port's front door: ``System`` / ``Session`` over a ``ServeSpec``."""
from repro_torch.api.events import DoneEvent, RoundEvent, ServeResult, SessionResult, TokenEvent
from repro_torch.api.spec import ModelSpec, ServeSpec, SpecError
from repro_torch.api.system import ModelBundle, Session, System, build_models

__all__ = [
    "DoneEvent",
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
    "build_models",
]
