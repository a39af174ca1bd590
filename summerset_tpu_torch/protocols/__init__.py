"""Vectorized protocol kernels + the protocol factory, counterpart of
``summerset_tpu/protocols/__init__.py``.  Every protocol of the JAX
package is ported; a name the JAX package knows but the port did not run
would be listed in ``NOT_PORTED`` and raise a ``ValueError`` that says so.
"""

from typing import Dict, Type

from ..core.protocol import ProtocolKernel

_REGISTRY: Dict[str, Type[ProtocolKernel]] = {}

#: protocols the JAX package has that this port does not run yet
NOT_PORTED: tuple = ()


def register_protocol(name: str):
    def deco(cls):
        _REGISTRY[name.lower()] = cls
        cls.name = name
        return cls

    return deco


def protocol_names():
    return sorted(_REGISTRY)


def protocol_display_name(name: str) -> str:
    """The registered (cased) protocol name for a lowered registry key."""
    return _REGISTRY[name.lower()].name


def make_protocol(name: str, *args, **kwargs) -> ProtocolKernel:
    """Factory dispatch; ``device=`` (default ``"cuda"``) is passed through
    to the kernel."""
    key = name.lower()
    if key not in _REGISTRY:
        if key in NOT_PORTED:
            raise ValueError(
                f"protocol '{name}' is not ported to summerset_tpu_torch "
                f"yet; ported: {protocol_names()}"
            )
        raise ValueError(
            f"unrecognized protocol name '{name}'; have {protocol_names()}"
        )
    return _REGISTRY[key](*args, **kwargs)


from . import multipaxos  # noqa: E402,F401
from . import rspaxos  # noqa: E402,F401
from . import raft  # noqa: E402,F401
from . import craft  # noqa: E402,F401
from . import crossword  # noqa: E402,F401
from . import quorum_leases  # noqa: E402,F401
from . import bodega  # noqa: E402,F401
from . import chain_rep  # noqa: E402,F401
from . import simple_push  # noqa: E402,F401
from . import rep_nothing  # noqa: E402,F401
from . import epaxos  # noqa: E402,F401
