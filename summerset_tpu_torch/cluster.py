"""An in-process port cluster: a real manager and ``n`` port
``ServerReplica`` loops over localhost TCP, each replica in its own thread
under a crash-restart supervisor (the counterpart of the JAX package's
``tests/test_cluster.py::Cluster``).

The tests, ``chip_smoke.py`` and ``python -m
summerset_tpu_torch.nemesis_soak`` drive it.  The supervisor records
every failed bring-up and every crash out of ``run()``
(``Cluster.faults()``); ``injected_crash`` tells a crash the nemesis
injected (a torn WAL append, a failed fsync, the snapshot crash point:
their errors say "injected") from a real one
(``Cluster.uninjected_faults()``).
"""

from __future__ import annotations

import asyncio
import random
import socket
import threading
import time

from .client.endpoint import GenericEndpoint
from .device import resolve_device
from .host.messages import CtrlRequest
from .host.server import ServerReplica
from .manager import ClusterManager


def _port_window():
    """A window of localhost ports outside this host's ephemeral range
    (``ip_local_port_range``; 32768-60999 by default): client connections
    take their local ports from that range, so a port picked there can be
    taken by a connection before a restarted replica binds it again."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = (int(x) for x in f.read().split())
    except (OSError, ValueError):
        lo, hi = 32768, 60999
    if lo - 1024 >= 4096:
        return max(1024, lo - 12000), lo
    if 65535 - hi >= 4096:
        return hi + 1, 65536
    return 20000, 32000


def free_ports(n):
    """``n`` distinct free localhost ports outside the ephemeral range
    (``_port_window``)."""
    rng = random.Random()
    lo, hi = _port_window()
    ports = []
    while len(ports) < n:
        p = rng.randrange(lo, hi)
        if p in ports:
            continue
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", p))
        except OSError:
            continue
        finally:
            s.close()
        ports.append(p)
    return ports


class Cluster:
    """A manager and ``n`` port replicas, each replica in its own thread
    under a crash-restart supervisor.  ``device`` follows the port's
    rule: the card by default, and with no card the constructor raises
    unless ``device="cpu"`` is passed."""

    def __init__(self, protocol, n, tmpdir, config=None, tick=0.005,
                 num_groups=1, window=32, device=None, settle=1.0,
                 slot_config=None):
        self.protocol = protocol
        self.n = n
        self.tmpdir = str(tmpdir)
        self.config = config or {}
        # per replica slot: config keys overriding ``config`` (a mixed
        # mesh, e.g. one replica with the wire codec off)
        self.slot_config = slot_config or {}
        self.tick = tick
        self.num_groups = num_groups
        self.window = window
        self.device = resolve_device(device)
        ports = free_ports(2 + 2 * n)
        self.srv_port, self.cli_port = ports[0], ports[1]
        self.api_ports = ports[2:2 + n]
        self.p2p_ports = ports[2 + n:]
        self.manager_addr = ("127.0.0.1", self.cli_port)
        self.replicas = {}
        self._threads = []
        self._man_loop = None
        self._stopping = False
        # supervisor records: {me, error} per crash out of run(), and
        # {slot, error} per failed constructor (retried); a durable
        # reset ends run() with True and is neither
        self.crash_reports = []
        self.bringup_failures = []

        man = ClusterManager(
            protocol, ("127.0.0.1", self.srv_port),
            ("127.0.0.1", self.cli_port), n,
        )
        self.manager = man

        def run_man():
            from .utils.loops import drain_and_close

            loop = asyncio.new_event_loop()
            self._man_loop = loop
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(man.run())
            except Exception:
                pass
            finally:
                drain_and_close(loop)

        t = threading.Thread(target=run_man, daemon=True)
        t.start()
        self._threads.append(t)
        time.sleep(0.3)

        # replicas come up concurrently (mesh barrier)
        for r in range(n):
            t = threading.Thread(
                target=self._replica_loop, args=(r,), daemon=True
            )
            t.start()
            self._threads.append(t)
        deadline = time.monotonic() + 120
        while len(self.replicas) < n:
            assert time.monotonic() < deadline, "cluster failed to start"
            time.sleep(0.1)
        time.sleep(settle)  # let the warm-start leader settle

    def _replica_loop(self, slot: int) -> None:
        """Crash-restart loop: an exception out of run() is a crash (for
        example the durability gate refusing to ack past a failed fsync)
        and the replica restarts, recovery replaying what reached disk."""
        while not self._stopping:
            try:
                rep = ServerReplica(
                    self.protocol,
                    ("127.0.0.1", self.api_ports[slot]),
                    ("127.0.0.1", self.p2p_ports[slot]),
                    ("127.0.0.1", self.srv_port),
                    config=dict(self.config,
                                **self.slot_config.get(slot, {})),
                    tick_interval=self.tick,
                    window=self.window,
                    num_groups=self.num_groups,
                    backer_dir=self.tmpdir,
                    device=self.device,
                )
            except Exception as e:
                self.bringup_failures.append({"slot": slot,
                                              "error": repr(e)})
                print(f"replica slot {slot} bring-up failed: {e!r}; "
                      "retrying", flush=True)
                time.sleep(0.5)
                continue
            self.replicas[rep.me] = rep
            try:
                restart = rep.run()
            except Exception as e:
                self.crash_reports.append({"me": rep.me, "error": repr(e)})
                print(f"replica {rep.me} crashed: {e!r}; restarting",
                      flush=True)
                restart = True
            rep.shutdown()
            self.replicas.pop(rep.me, None)
            if not restart or rep.stopping:
                return
            time.sleep(0.2)

    def faults(self):
        """Every failed bring-up and crash so far.  A run that injects
        no fault fails on a non-empty list: the supervisor's restart
        would otherwise hide a replica's error behind the failover."""
        return self.bringup_failures + self.crash_reports

    def uninjected_faults(self):
        """``faults()`` less the crashes the nemesis injected
        (``injected_crash``): a run under a fault plan fails on any."""
        return [f for f in self.faults() if not injected_crash(f)]

    def endpoint(self):
        ep = GenericEndpoint(self.manager_addr)
        ep.connect()
        return ep

    def ctrl(self, kind, servers=None, durable=True, timeout=180):
        """One manager control request through a fresh endpoint."""
        ep = GenericEndpoint(self.manager_addr)
        try:
            return ep.ctrl.request(
                CtrlRequest(kind, servers=servers, durable=durable),
                timeout=timeout,
            )
        finally:
            ep.leave()

    def leader_of(self, g=0):
        """The unpaused replica that currently leads group ``g``, or
        None (a paused replica's leadership flag is frozen)."""
        for me, rep in sorted(self.replicas.items()):
            if not rep.paused and bool(rep._is_leader[g]):
                return me
        return None

    def stop(self):
        self._stopping = True
        for rep in list(self.replicas.values()):
            rep.stopping = True
        deadline = time.monotonic() + 10
        for t in self._threads[1:]:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        for rep in list(self.replicas.values()):
            rep.shutdown()
        if self._man_loop is not None:
            self._man_loop.call_soon_threadsafe(self._man_loop.stop)


def injected_crash(report: dict) -> bool:
    """A crash report the nemesis injected: the WAL's torn append and
    failed fsync and the snapshot crash point raise errors that say
    "injected".  A bring-up failure is never injected."""
    return "me" in report and "injected" in str(report.get("error", ""))
