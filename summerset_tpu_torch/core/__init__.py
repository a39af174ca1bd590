"""The batched lockstep engine: protocol SPI, telemetry lanes, quorum
tally, network model and tick engine (counterpart of
``summerset_tpu/core``; the mesh sharding module is not ported yet)."""

from .protocol import ProtocolKernel, StepEffects
from .netmodel import NetConfig, NetModel, ControlInputs
from .engine import Engine

__all__ = [
    "ProtocolKernel",
    "StepEffects",
    "NetConfig",
    "NetModel",
    "ControlInputs",
    "Engine",
]
