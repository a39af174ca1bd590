"""Client library, counterpart of ``summerset_tpu/client``: the endpoint,
its data/control stubs and the closed-loop driver."""

from .endpoint import ClientApiStub, ClientCtrlStub, GenericEndpoint  # noqa
from .drivers import DriverClosedLoop  # noqa: F401
