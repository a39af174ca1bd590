"""summerset_client analog of the port (reference
summerset_client/src/main.rs); the flags of ``summerset_tpu/cli/client.py``:
utility mode dispatch repl | bench | tester | mess."""

from __future__ import annotations

import argparse
import json

from ..client.bench import ClientBench
from ..client.endpoint import GenericEndpoint
from ..client.repl import ClientMess, ClientRepl
from ..client.tester import ClientTester
from ..utils.logging import logger_init


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="summerset_tpu_torch client")
    ap.add_argument("-u", "--utility", default="repl",
                    choices=["repl", "bench", "tester", "mess"])
    ap.add_argument("-m", "--manager", default="127.0.0.1:52601")
    # bench knobs (parity: bench.rs CLI surface)
    ap.add_argument("--secs", type=float, default=10.0)
    ap.add_argument("--freq", type=float, default=0.0)
    ap.add_argument("--put-ratio", type=float, default=0.5)
    ap.add_argument("--value-size", default="128")
    ap.add_argument("--num-keys", type=int, default=5)
    ap.add_argument("--trace-file", default=None)  # YCSB run log replay
    # tester knobs
    ap.add_argument("--tests", default="")
    # mess knobs
    ap.add_argument("--pause", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--write", default=None)  # key=value
    ap.add_argument("--responders", default=None)  # comma ids (conf)
    ap.add_argument("--leader", type=int, default=None)  # conf leader
    args = ap.parse_args(argv)

    logger_init()
    mhost, mport = args.manager.rsplit(":", 1)
    addr = (mhost, int(mport))

    if args.utility == "repl":
        ClientRepl(addr).run()
    elif args.utility == "bench":
        from ..client.bench import load_ycsb_trace

        ep = GenericEndpoint(addr)
        ep.connect()
        summary = ClientBench(
            ep,
            secs=args.secs,
            freq=args.freq,
            put_ratio=args.put_ratio,
            value_size=args.value_size,
            num_keys=args.num_keys,
            trace=(
                load_ycsb_trace(args.trace_file)
                if args.trace_file else None
            ),
        ).run()
        ep.leave()
        print(json.dumps(summary))
    elif args.utility == "tester":
        names = [t for t in args.tests.split(",") if t] or None
        results = ClientTester(addr).run_tests(names)
        print(json.dumps(results))
        if any(v != "PASS" for v in results.values()):
            raise SystemExit(1)
    elif args.utility == "mess":
        def parse_ids(s):
            if s is None:
                return None
            return [int(x) for x in s.split(",") if x] or []

        write = None
        if args.write:
            k, v = args.write.split("=", 1)
            write = (k, v)
        ClientMess(addr).run(
            pause=parse_ids(args.pause),
            resume=parse_ids(args.resume),
            write=write,
            responders=parse_ids(args.responders),
            leader=args.leader,
        )


if __name__ == "__main__":
    main()
