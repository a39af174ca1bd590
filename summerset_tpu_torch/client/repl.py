"""ClientRepl / ClientMess: interactive CLI + one-shot perturbations,
counterpart of ``summerset_tpu/client/repl.py``.

Parity: reference ``summerset_client/src/clients/repl.rs`` (get/put/stop
prompt loop) and ``clients/mess.rs:16-45`` (one-shot pause/resume sets,
conf changes, a single write).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from ..host.messages import CtrlRequest
from .drivers import DriverClosedLoop
from .endpoint import GenericEndpoint


class ClientRepl:
    HELP = (
        "commands: get <key> | put <key> <value> | reconnect | help | exit"
    )

    def __init__(self, manager_addr: Tuple[str, int]):
        self.ep = GenericEndpoint(manager_addr)
        self.ep.connect()
        self.drv = DriverClosedLoop(self.ep)

    def run(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        print(self.HELP, file=stdout)
        for line in stdin:
            parts = line.split()
            if not parts:
                continue
            try:
                if parts[0] == "exit":
                    break
                elif parts[0] == "help":
                    print(self.HELP, file=stdout)
                elif parts[0] == "reconnect":
                    self.ep.reconnect()
                    print(f"connected to {self.ep.current}", file=stdout)
                elif parts[0] == "get":
                    rep = self.drv.get(parts[1])
                    val = rep.result.value if rep.result else None
                    print(f"{rep.kind}: {parts[1]} = {val}", file=stdout)
                elif parts[0] == "put":
                    rep = self.drv.put(parts[1], " ".join(parts[2:]))
                    print(f"{rep.kind}: {parts[1]} set", file=stdout)
                else:
                    print(self.HELP, file=stdout)
            except Exception as e:
                print(f"error: {e}", file=stdout)
        self.ep.leave()


class ClientMess:
    """One-shot cluster perturbation (parity: mess.rs:16-45)."""

    def __init__(self, manager_addr: Tuple[str, int]):
        self.manager_addr = manager_addr

    def run(
        self,
        pause: Optional[List[int]] = None,
        resume: Optional[List[int]] = None,
        write: Optional[Tuple[str, str]] = None,
        responders: Optional[List[int]] = None,
        leader: Optional[int] = None,
    ) -> None:
        ep = GenericEndpoint(self.manager_addr)
        if pause is not None:
            ep.ctrl.request(
                CtrlRequest("pause_servers", servers=pause or None)
            )
        if resume is not None:
            ep.ctrl.request(
                CtrlRequest("resume_servers", servers=resume or None)
            )
        if responders is not None or leader is not None:
            # responders-conf change through the data plane (mess.rs
            # conf perturbations -> ConfChange)
            ep.connect()
            delta = {}
            if responders is not None:
                delta["responders"] = responders
            if leader is not None:
                delta["leader"] = leader
            DriverClosedLoop(ep).conf_change(delta)
        if write is not None:
            if ep.api is None:
                ep.connect()
            DriverClosedLoop(ep).checked_put(write[0], write[1])
        ep.leave()
