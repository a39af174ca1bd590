"""Client library, counterpart of ``summerset_tpu/client``: the endpoint,
its data/control stubs, the closed- and open-loop drivers, and the bench,
tester and repl utility modes."""

from .endpoint import ClientApiStub, ClientCtrlStub, GenericEndpoint  # noqa
from .drivers import DriverClosedLoop, DriverOpenLoop  # noqa: F401
