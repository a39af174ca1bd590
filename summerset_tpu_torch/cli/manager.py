"""summerset_manager analog of the port (reference
summerset_manager/src/main.rs); the flags of ``summerset_tpu/cli/manager.py``."""

from __future__ import annotations

import argparse
import asyncio

from ..manager import ClusterManager
from ..utils.logging import logger_init


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="summerset_tpu_torch cluster manager"
    )
    ap.add_argument("-p", "--protocol", default="MultiPaxos")
    ap.add_argument("--bind-ip", default="127.0.0.1")
    ap.add_argument("--srv-port", type=int, default=52600)
    ap.add_argument("--cli-port", type=int, default=52601)
    ap.add_argument("-n", "--population", type=int, default=3)
    args = ap.parse_args(argv)

    logger_init()
    man = ClusterManager(
        args.protocol,
        (args.bind_ip, args.srv_port),
        (args.bind_ip, args.cli_port),
        args.population,
    )
    asyncio.run(man.run())


if __name__ == "__main__":
    main()
