"""Ingress-proxy process entry (serving-plane split, host/ingress.py),
counterpart of ``summerset_tpu/cli/proxy.py``.

Runs ONE stateless ingress proxy (+ optional learner read tier) as its
own OS process: registers with the manager, serves clients on the api
port, forwards batched ops to the owner shards.  The proxy never
touches an accelerator — a proxy host needs sockets and pickle, nothing
else, and this process imports no ``torch`` — which is exactly the
compartmentalization claim: the client-facing tier scales on cheap
frontend boxes while the replica shards keep the card.

Usage:
    python -m summerset_tpu_torch.cli.proxy -m 127.0.0.1:52600 -a 52900 \
        [--forward-batch 64] [--no-read-tier]
"""

from __future__ import annotations

import argparse
import signal
import threading

from ..utils.logging import logger_init, pf_info, pf_logger

logger = pf_logger("proxy_main")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="summerset_tpu_torch ingress proxy"
    )
    ap.add_argument("--bind-ip", default="127.0.0.1")
    ap.add_argument("-a", "--api-port", type=int, default=52900)
    ap.add_argument("-m", "--manager", default="127.0.0.1:52600")
    ap.add_argument("--max-batch", type=int, default=4096)
    ap.add_argument("--max-pending", type=int, default=1024)
    ap.add_argument("--forward-batch", type=int, default=64)
    ap.add_argument("--upstream-window", type=int, default=4)
    ap.add_argument("--backlog-limit", type=int, default=None)
    ap.add_argument("--tick-interval", type=float, default=0.001)
    ap.add_argument("--no-read-tier", action="store_true")
    args = ap.parse_args(argv)

    logger_init()
    mhost, mport = args.manager.rsplit(":", 1)

    from ..host.ingress import IngressProxy

    proxy = IngressProxy(
        (mhost, int(mport)),
        (args.bind_ip, args.api_port),
        max_batch=args.max_batch,
        max_pending=args.max_pending,
        forward_batch=args.forward_batch,
        upstream_window=args.upstream_window,
        backlog_limit=args.backlog_limit,
        tick_interval=args.tick_interval,
        read_tier=not args.no_read_tier,
    )
    pf_info(logger, f"proxy {proxy.cid} up @ "
                    f"{args.bind_ip}:{args.api_port}")
    done = threading.Event()

    def _stop(_sig, _frm) -> None:
        done.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    done.wait()
    proxy.stop()


if __name__ == "__main__":
    main()
