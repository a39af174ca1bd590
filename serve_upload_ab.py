"""Inbox upload A/B on the card: the serving loop's host->device lanes
(the inbox and the step inputs of every tick) sent as the server sends
them, one pinned ``non_blocking`` copy per lane (``ServerReplica._upload``),
against all lanes packed into one pinned staging buffer and sent in one
copy (``upload_packed`` below).

One MultiPaxos replica alone (a 1-replica cluster of
``tests/test_torch_cluster.py``, no clients: every tick assembles and
uploads the same lanes), 1024 groups, W=64, tick 0.002 s, pipelined, as
phase 12 of ``chip_smoke.py`` runs it.  The variants take turns, A B B A
A B ..., each on a fresh cluster for ``--secs`` seconds after a warm-up.
Each run prints one JSON line (ticks/s, mean ``inbox`` and ``dispatch``
stages in µs: ``inbox`` holds the inbox upload, ``dispatch`` the inputs'
upload and the step launch); the last lines are the card's name and
power limit and one JSON line with each variant's runs.

    python3 serve_upload_ab.py [--rounds 3] [--secs 6] [--device cuda]
"""

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

_TORCH_DTYPE = {"<i4": torch.int32, "|b1": torch.bool, "<f4": torch.float32}


def upload_packed(self, arrays):
    """Every lane packed into one pinned staging buffer (one per layout,
    two used in turn: a buffer is refilled only after the step that read
    it was drained), one ``non_blocking`` copy, typed views of the device
    buffer."""
    if self._stream is None:
        return {k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in arrays.items()}
    layouts = self.__dict__.setdefault("_ab_layouts", {})
    sig = tuple((k, a.shape, a.dtype.str) for k, a in arrays.items())
    lay = layouts.get(sig)
    if lay is None:
        offs, off = {}, 0
        for k, a in arrays.items():
            offs[k] = off
            off += -(-a.nbytes // 8) * 8  # 8-byte aligned lanes
        bufs = [torch.empty(max(off, 8), dtype=torch.uint8,
                            pin_memory=True) for _ in range(2)]
        lay = {"offs": offs, "bufs": bufs, "slot": 0}
        layouts[sig] = lay
    lay["slot"] ^= 1
    buf = lay["bufs"][lay["slot"]]
    host = buf.numpy()
    for k, a in arrays.items():
        o = lay["offs"][k]
        host[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    with self._on_stream():
        dev = buf.to(self.device, non_blocking=True)
    return {k: dev[lay["offs"][k]:lay["offs"][k] + a.nbytes]
            .view(_TORCH_DTYPE[a.dtype.str]).view(a.shape)
            for k, a in arrays.items()}


def one_run(harness, variant, device, secs, warm):
    from summerset_tpu_torch.host.server import ServerReplica

    sh = cs.SERVE_SHAPE
    saved = ServerReplica._upload
    if variant == "packed":
        ServerReplica._upload = upload_packed
    tmp = tempfile.mkdtemp(prefix="upload_ab_")
    cluster = None
    try:
        cluster = harness.Cluster(
            "MultiPaxos", 1, tmp, tick=sh["tick"], num_groups=sh["G"],
            window=sh["W"], device=device, settle=warm,
        )
        reps = dict(cluster.replicas)
        rep = reps[0]
        tick0, marks = rep.tick, cs._stage_marks(reps)
        t0 = time.monotonic()
        time.sleep(secs)
        t1 = time.monotonic()
        stages = cs._stage_means(reps, marks)
        if cluster.faults():
            raise SystemExit(f"{variant}: replica faults {cluster.faults()}")
        return {
            "variant": variant, "groups": sh["G"], "window": sh["W"],
            "secs": round(t1 - t0, 3),
            "ticks_per_s": round((rep.tick - tick0) / (t1 - t0), 1),
            "inbox_us": stages.get("inbox"),
            "dispatch_us": stages.get("dispatch"),
            "device_wait_us": stages.get("device_wait"),
        }
    finally:
        if cluster is not None:
            cluster.stop()
        ServerReplica._upload = saved
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--secs", type=float, default=6.0)
    ap.add_argument("--warm", type=float, default=2.0)
    ap.add_argument("--groups", type=int, default=cs.SERVE_SHAPE["G"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card (pass --device cpu to rehearse)", file=sys.stderr)
        return 2
    cs.SERVE_SHAPE["G"] = args.groups
    harness = cs._serve_harness()
    order = []
    for r in range(args.rounds):
        pair = ["per_lane", "packed"]
        order += pair if r % 2 == 0 else pair[::-1]
    runs = {"per_lane": [], "packed": []}
    for v in order:
        line = one_run(harness, v, args.device, args.secs, args.warm)
        print(json.dumps(line), flush=True)
        runs[v].append(line)
    card = cs.card_label() if args.device == "cuda" else "cpu"
    print(card, flush=True)
    print(json.dumps({"upload_ab": {
        v: {k: [r[k] for r in rs] for k in
            ("ticks_per_s", "inbox_us", "dispatch_us")}
        for v, rs in runs.items()}, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
