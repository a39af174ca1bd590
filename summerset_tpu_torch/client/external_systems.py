"""External-system comparison adapters: ZooKeeper and etcd, counterpart
of ``summerset_tpu/client/external_systems.py``.

Parity: reference ``summerset_client/src/zookeeper/session.rs:16-29`` and
``summerset_client/src/etcd/kvclient.rs:12-25`` — thin KV session
wrappers exposing the same get/put surface as the native endpoint so the
bench/tester clients can run unmodified against an external system
(launched by the user; the adapters only speak the client protocol).

Gating: the Python client libraries (``kazoo`` for ZooKeeper, ``etcd3``
or ``grpc`` for etcd) are not part of the pinned environment — the
adapters import them lazily and raise a clear error when absent, so the
rest of the framework carries no dependency.  Command mapping (key ->
znode path, value encoding, sync-on-get / stale-read options) is pure
and unit-testable without a live server.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..host.statemach import Command, CommandResult
from ..utils.errors import SummersetError


def zk_path(prefix: str, key: str) -> str:
    """Key -> znode path (reference session.rs keeps a flat namespace
    under one chroot-style prefix)."""
    safe = key.replace("/", "_")
    return f"{prefix.rstrip('/')}/{safe}"


def encode_value(value: str) -> bytes:
    return value.encode("utf-8")


def decode_value(raw: Optional[bytes]) -> Optional[str]:
    return None if raw is None else raw.decode("utf-8", errors="replace")


class ZooKeeperSession:
    """ZooKeeper KV adapter (parity: zookeeper/session.rs).

    ``sync_on_get``: issue a sync() before reads for linearizable reads
    (the reference's ``sync_on_get`` option; without it ZK reads may be
    stale — the exact asymmetry the comparison benches measure).
    """

    def __init__(self, servers: str, prefix: str = "/summerset",
                 sync_on_get: bool = False, timeout: float = 15.0):
        try:
            from kazoo.client import KazooClient  # type: ignore
        except ImportError as e:
            raise SummersetError(
                "ZooKeeper adapter needs the 'kazoo' client library "
                "(not part of this environment): pip install kazoo"
            ) from e
        self.prefix = prefix
        self.sync_on_get = sync_on_get
        self.zk = KazooClient(hosts=servers, timeout=timeout)
        self.zk.start(timeout=timeout)
        self.zk.ensure_path(prefix)

    def do_cmd(self, cmd: Command) -> CommandResult:
        path = zk_path(self.prefix, cmd.key)
        if cmd.kind == "get":
            if self.sync_on_get:
                self.zk.sync(path)
            if self.zk.exists(path) is None:
                return CommandResult("get", value=None)
            raw, _ = self.zk.get(path)
            return CommandResult("get", value=decode_value(raw))
        old = None
        if self.zk.exists(path) is None:
            self.zk.create(path, encode_value(cmd.value))
        else:
            raw, _ = self.zk.get(path)
            old = decode_value(raw)
            self.zk.set(path, encode_value(cmd.value))
        return CommandResult("put", old_value=old)

    def leave(self) -> None:
        self.zk.stop()
        self.zk.close()


class EtcdKvClient:
    """etcd v3 KV adapter (parity: etcd/kvclient.rs).

    ``stale_reads``: serve reads at serializable (any-member) consistency
    instead of linearizable — the reference's ``stale_reads`` option.
    """

    def __init__(self, endpoint: Tuple[str, int],
                 stale_reads: bool = False, timeout: float = 15.0):
        try:
            import etcd3  # type: ignore
        except ImportError as e:
            raise SummersetError(
                "etcd adapter needs the 'etcd3' client library "
                "(not part of this environment): pip install etcd3"
            ) from e
        self.stale = stale_reads
        self.cli = etcd3.client(
            host=endpoint[0], port=endpoint[1], timeout=timeout
        )

    def do_cmd(self, cmd: Command) -> CommandResult:
        if cmd.kind == "get":
            raw, _ = self.cli.get(
                cmd.key, serializable=self.stale
            )
            return CommandResult("get", value=decode_value(raw))
        old_raw, _ = self.cli.get(cmd.key)
        self.cli.put(cmd.key, encode_value(cmd.value))
        return CommandResult("put", old_value=decode_value(old_raw))

    def leave(self) -> None:
        self.cli.close()
