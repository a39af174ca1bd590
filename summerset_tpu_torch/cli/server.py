"""summerset_server analog of the port (reference
summerset_server/src/main.rs); the flags of ``summerset_tpu/cli/server.py``
plus ``--device`` (default ``cuda``: with no card the replica refuses to
start unless ``--device cpu`` is given).  A ``device_mesh="GxR"`` config
shards the replica's state over the visible cards, or over repeated CPU
handles with ``--device cpu`` (``mesh_devices`` lists them explicitly).

Config strings use ``a=1+b='x'`` with ``+`` -> newline (TOML).  The
replica runs in a crash-restart loop: ``run()`` returning True (a reset)
or raising (a crash, e.g. the durability gate refusing to ack past a
failed fsync) restarts it, and recovery replays the WAL.
"""

from __future__ import annotations

import argparse
import time

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: tomli is API-compatible
    import tomli as tomllib

from ..device import resolve_device
from ..utils.errors import SummersetError
from ..utils.logging import logger_init, pf_info, pf_logger

logger = pf_logger("server_main")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="summerset_tpu_torch server replica"
    )
    ap.add_argument("-p", "--protocol", default="MultiPaxos")
    ap.add_argument("--bind-ip", default="127.0.0.1")
    ap.add_argument("-a", "--api-port", type=int, default=52700)
    ap.add_argument("-i", "--p2p-port", type=int, default=52800)
    ap.add_argument("-m", "--manager", default="127.0.0.1:52600")
    ap.add_argument("-c", "--config", default="")
    ap.add_argument("-g", "--num-groups", type=int, default=1)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--tick-interval", type=float, default=0.002)
    ap.add_argument("--backer-dir", default=None,
                    help="WAL directory (default: summerset_tpu_torch "
                         "under the temp directory)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the kernel state lives on")
    args = ap.parse_args(argv)

    logger_init()
    device = resolve_device(args.device)  # no card: raises here
    mhost, mport = args.manager.rsplit(":", 1)
    cfg = (
        tomllib.loads(args.config.replace("+", "\n"))
        if args.config
        else {}
    )

    mesh_spec = str(cfg.get("device_mesh", "") or "")
    if mesh_spec and device.type == "cpu" and not cfg.get("mesh_devices"):
        # a CPU replica's mesh is made of repeated CPU handles, the
        # counterpart of the JAX CLI's virtual CPU devices; a card's
        # mesh takes the visible cards unless mesh_devices lists them
        from ..core.sharding import parse_mesh

        gs, rs = parse_mesh(mesh_spec)
        cfg["mesh_devices"] = ",".join(["cpu"] * (gs * rs))

    from ..host.server import DEFAULT_BACKER_DIR, ServerReplica

    backer_dir = args.backer_dir or DEFAULT_BACKER_DIR

    boot_fails = 0
    while True:
        try:
            replica = ServerReplica(
                args.protocol,
                (args.bind_ip, args.api_port),
                (args.bind_ip, args.p2p_port),
                (mhost, int(mport)),
                config=cfg,
                num_groups=args.num_groups,
                window=args.window,
                tick_interval=args.tick_interval,
                backer_dir=backer_dir,
                device=device,
            )
        except (OSError, SummersetError) as e:
            # transient bring-up failure (a peer mid-restart, a port
            # still draining): retry a few times before giving up
            boot_fails += 1
            if boot_fails > 5:
                raise
            pf_info(logger, f"bring-up failed: {e!r}; retrying "
                            f"({boot_fails}/5)")
            time.sleep(1.0)
            continue
        boot_fails = 0
        try:
            restart = replica.run()
        except Exception as e:
            pf_info(logger, f"replica crashed: {e!r}")
            restart = True
            time.sleep(0.5)
        replica.shutdown()
        if not restart:
            break
        pf_info(logger, "restarting replica (reset)")


if __name__ == "__main__":
    main()
