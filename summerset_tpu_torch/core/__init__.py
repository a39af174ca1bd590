"""The batched lockstep engine: protocol SPI, telemetry lanes, quorum
tally, network model, tick engine and the device mesh (``sharding``),
counterpart of ``summerset_tpu/core``."""

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
