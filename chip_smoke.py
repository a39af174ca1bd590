#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``summerset_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); with no card it exits non-zero
before printing any result.  Phases, each printed as it runs:

1. build   — compile ``summerset_tpu_torch/csrc/bitslice.cu`` from the
             checkout (``nvcc``, sm_90a) and print the build time.
2. kernel  — the GF(2^8) kernel against its plain PyTorch version on the
             card, bit for bit, for the RS(3,2), RS(2,1) and RS(5,3)
             parity tables and the ten 3-of-5 decode tables, at 1024
             values of 4 KiB, single values of 4 KiB..4 MiB and an odd
             lane count; kernel time (CUDA events) beside its bound.
3. multipaxos — the engine at the bench shape (4096 groups x 5, W=128,
             P=32) for a window of ticks: commits must advance, and the
             first 64 groups must equal a CPU run of the port at G=64;
             then a short ``torch.profiler`` window: device busy time,
             idle share, kernels per tick and device time per phase.
4. rspaxos — RSPaxos at 1024 groups x 5 with RS(3,2) (the main path the
             kernel serves): the engine window, the same CPU check, then
             the codeword plane: every leader's last-tick values encoded
             in one batched kernel call, decoded from rotating 3-of-5
             shard subsets, and a few values through ``CodewordStore``.
             Kernel launch counts are read over this phase only.  The
             same profile window follows.

The last two lines are a JSON object ``{"kernels": [...]}`` and the card's
``nvidia-smi`` name and power limit, then ``{"ok": true, "device": ...}``.
Any mismatch or exception exits non-zero.
"""

import itertools
import json
import subprocess
import sys
import time

SEED = 20261016
MP_SHAPE = dict(G=4096, R=5, W=128, P=32)
RS_SHAPE = dict(G=1024, R=5, W=128, P=32)
CPU_GROUPS = 64
MP_TICKS = 64
RS_TICKS = 48
PROFILE_TICKS = 8
PAYLOAD = 4096
#: the card every phase runs on (a rehearsal on the CPU may override it)
DEV = "cuda"

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 3.35 TB/s;
# int32 ALU rate = 132 SMs x 64 INT32 lanes x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# ------------------------------------------------------------- kernel math --
def bitslice_work(rows, cols, B, L):
    """(bytes, int32 ops) the GF product must move and do: each input word
    read once, each output word written once; per lane and (c, i) one
    shift and one mask, per row one multiply and one XOR."""
    nbytes = 4 * (B * cols * L + B * rows * L + rows * cols * 8)
    ops = B * L * cols * 8 * (2 + 2 * rows)
    return nbytes, ops


def bound_ms(rows, cols, B, L):
    nbytes, ops = bitslice_work(rows, cols, B, L)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def lanes_for(nbytes, d):
    """Lane count of one value at the kernel geometry (128-lane multiple),
    as ``pack_bytes(..., lane_multiple=128)`` gives it."""
    shard = -(-nbytes // d)
    return -(-shard // 512) * 128


def pack_batch(np, payloads, d, lanes):
    """[B, n] uint8 payloads -> [B, d, lanes] int32, each row exactly what
    ``pack_bytes(payload, d, lane_multiple=128)`` gives."""
    B, n = payloads.shape
    buf = np.zeros((B, d * lanes * 4), np.uint8)
    buf[:, :n] = payloads
    return buf.view("<i4").reshape(B, d, lanes).astype(np.int32)


# ---------------------------------------------------------- engine helpers --
def drive(torch, eng, ticks, P):
    """A window of saturating synthetic load: ``run_synthetic`` for all but
    the last tick, then one ``tick`` so its effects can be read."""
    G, R = eng.kernel.G, eng.kernel.R
    state, ns = eng.init()
    state, ns = eng.run_synthetic(state, ns, ticks - 1, P)
    dev = eng.device
    state, ns, fx = eng.tick(state, ns, {
        "n_proposals": torch.full((G,), P, dtype=torch.int32, device=dev),
        "value_base": torch.full((G,), (ticks - 1) * P, dtype=torch.int32,
                                 device=dev),
        "exec_floor": torch.full((G, R), 1 << 30, dtype=torch.int32,
                                 device=dev),
    })
    return state, ns, fx


def compare_groups(torch, card, cpu, n, what):
    """The first ``n`` groups of a card run equal a CPU run of ``n``
    groups, leaf for leaf (state and netstate)."""
    st_c, ns_c = card
    st_h, ns_h = cpu
    if sorted(st_c) != sorted(st_h):
        fail(f"{what}: state leaves differ")
    for k in st_c:
        a = st_c[k][:n].cpu()
        if a.dtype != st_h[k].dtype or not torch.equal(a, st_h[k]):
            fail(f"{what}: state leaf {k!r} differs between card and CPU")
    for k in ("rng", "last_due"):
        if not torch.equal(ns_c[k][:n].cpu(), ns_h[k]):
            fail(f"{what}: netstate {k!r} differs")
    for k in ("cursor", "tick"):
        if int(ns_c[k]) != int(ns_h[k]):
            fail(f"{what}: netstate {k!r} differs")
    for k, b in ns_c["bufs"].items():
        gax = 2 if k in ("__pair__", "__bcast__") else 1
        a = b.narrow(gax, 0, n).cpu()
        if not torch.equal(a, ns_h["bufs"][k]):
            fail(f"{what}: netstate buffer {k!r} differs")
    return len(st_c)


def committed(state):
    return int(state["commit_bar"].amax(dim=1).sum())


def _union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_ticks(torch, eng, state, ns, ticks, P, what, card):
    """Where a tick's time goes: ``ticks`` synthetic ticks timed on the
    host clock without the profiler, then the same number of ticks under
    ``torch.profiler`` for the device busy time (the union of kernel
    intervals), kernel launches per tick and device time per phase.  The
    idle share is one less busy time over the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, ns = eng.run_synthetic(state, ns, ticks, P)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, ns = eng.run_synthetic(state, ns, ticks, P)
        torch.cuda.synchronize()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # device events minus the phase ranges mirrored onto the device
    # timeline (those span idle gaps too)
    kernels = [e for e in prof.events() if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log(f"profile {what}: wall {wall_us / ticks / 1e3:.3f} ms/tick; the "
            f"profiler saw no device activity, so device busy time and idle "
            f"share are not measured | {card}")
        return
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    log(f"profile {what}: {ticks} ticks, wall {wall_us / ticks / 1e3:.3f} "
        f"ms/tick, device busy {busy_us / ticks / 1e3:.3f} ms/tick, idle "
        f"share {1 - busy_us / wall_us:.3f}, {len(kernels) / ticks:.1f} "
        f"kernel launches/tick | {card}")
    # the host-side phase ranges: device time of the kernels each launched
    phases = sorted(
        ((e.key[len("graftphase__"):], e.device_time_total, e.cpu_time_total)
         for e in prof.key_averages()
         if e.key.startswith("graftphase__") and e.device_type == cpu),
        key=lambda r: -r[1])
    for name, dev_us, cpu_us in phases:
        log(f"  phase {name:<22} device {dev_us / ticks / 1e3:.4f} ms/tick, "
            f"host {cpu_us / ticks / 1e3:.4f} ms/tick (profiled)")


# ------------------------------------------------------------------ phases --
def phase_build():
    from summerset_tpu_torch.ops import native

    log("== phase 1: build")
    t0 = time.perf_counter()
    path = native.build("bitslice")
    native.load("bitslice")
    log(f"built {path} in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {native.build_seconds.get('bitslice', 0.0):.3f} s)")
    for line in native.build_log.get("bitslice", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels(torch, np, card):
    from summerset_tpu_torch.ops import rscoding as rs

    log("== phase 2: kernel vs plain on the card (bit-exact)")
    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED)
    codes = {(d, p): rs.RSCode(d, p, device=dev)
             for d, p in ((3, 2), (2, 1), (5, 3))}
    tables = [(f"enc({d},{p})", code._parity_tbl)
              for (d, p), code in codes.items()]
    subsets = list(itertools.combinations(range(5), 3))
    tables += [(f"dec(3,2){s}", codes[(3, 2)]._decode_tbl(s))
               for s in subsets]
    shape_defs = [("1024x4KiB", 1024, 4096), ("1x4KiB", 1, 4096),
                  ("1x64KiB", 1, 65536), ("1x1MiB", 1, 1 << 20),
                  ("1x4MiB", 1, 4 << 20), ("3xL1000", 3, None)]
    max_err = 0
    checked = 0
    for sname, B, nbytes in shape_defs:
        for tname, tbl in tables:
            rows, cols = int(tbl.shape[0]), int(tbl.shape[1])
            L = 1000 if nbytes is None else lanes_for(nbytes, cols)
            x = torch.from_numpy(rng.integers(
                -2**31, 2**31, size=(B, cols, L), dtype=np.int32)).to(dev)
            got = rs.bitslice_gf256(tbl, x)
            want = rs._bitslice_matmul_plain(tbl, x)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                fail(f"kernel != plain for {tname} at {sname} [{B},{cols},{L}]")
            checked += 1
            if tname in ("enc(3,2)", "dec(3,2)(2, 3, 4)"):
                iters = 20 if B * L > 1 << 18 else 100
                k_ms = time_ms(torch, lambda: rs.bitslice_gf256(tbl, x), iters)
                p_ms = time_ms(torch, lambda: rs._bitslice_matmul_plain(tbl, x),
                               max(iters // 10, 3))
                b_ms, b_by = bound_ms(rows, cols, B, L)
                log(f"{tname:>18} {sname:>10} [{B},{cols},{L}] kernel "
                    f"{k_ms:.4f} ms plain {p_ms:.4f} ms bound {b_ms:.4f} ms "
                    f"({b_by}) share {b_ms / k_ms:.3f} | {card}")
    log(f"{checked} (table, shape) pairs bit-exact, max_abs_err {max_err}")
    log('kernels: ["bitslice_gf256"]')
    return max_err


def phase_multipaxos(torch, card):
    from summerset_tpu_torch.core import Engine
    from summerset_tpu_torch.protocols import make_protocol
    from summerset_tpu_torch.protocols.multipaxos import (
        ReplicaConfigMultiPaxos,
    )

    log("== phase 3: MultiPaxos at the bench shape")
    sh = MP_SHAPE
    cfg = ReplicaConfigMultiPaxos(
        max_proposals_per_tick=sh["P"], chunk_size=2 * sh["P"],
        exec_follows_commit=False,
    )

    def engine(G, device):
        k = make_protocol("multipaxos", G, sh["R"], sh["W"], cfg,
                          device=device)
        return Engine(k, device=device)

    eng = engine(sh["G"], DEV)
    st, ns = eng.init()
    st, ns = eng.run_synthetic(st, ns, 8, sh["P"])  # warm-up
    torch.cuda.synchronize()
    c0 = committed(st)
    t0 = time.perf_counter()
    st, ns = eng.run_synthetic(st, ns, MP_TICKS, sh["P"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = (committed(st) - c0) / dt
    if committed(st) <= c0:
        fail("multipaxos: commits did not advance")
    log(f"multipaxos G={sh['G']} R={sh['R']} W={sh['W']} P={sh['P']}: "
        f"{MP_TICKS} ticks in {dt:.3f} s ({dt / MP_TICKS * 1e3:.3f} ms/tick), "
        f"{rate:.1f} committed slots/s | {card}")
    profile_ticks(torch, eng, st, ns, PROFILE_TICKS, sh["P"], "multipaxos",
                  card)

    card_run = drive(torch, engine(sh["G"], DEV), MP_TICKS, sh["P"])
    cpu_run = drive(torch, engine(CPU_GROUPS, "cpu"), MP_TICKS, sh["P"])
    n = compare_groups(torch, card_run[:2], cpu_run[:2], CPU_GROUPS,
                       "multipaxos")
    if committed(card_run[0]) <= 0:
        fail("multipaxos: nothing committed in the compared window")
    log(f"multipaxos: first {CPU_GROUPS} groups equal the CPU run over "
        f"{MP_TICKS} ticks ({n} state leaves + netstate)")


def phase_rspaxos(torch, np, card):
    from summerset_tpu_torch.core import Engine
    from summerset_tpu_torch.host.codeword import CodewordStore
    from summerset_tpu_torch.ops import rscoding as rs
    from summerset_tpu_torch.protocols import make_protocol
    from summerset_tpu_torch.protocols.rspaxos import ReplicaConfigRSPaxos

    log("== phase 4: RSPaxos + RS(3,2) codeword plane (main path)")
    sh = RS_SHAPE
    cfg = ReplicaConfigRSPaxos(
        max_proposals_per_tick=sh["P"], chunk_size=2 * sh["P"],
        exec_follows_commit=False, fault_tolerance=1,
    )

    def engine(G, device):
        k = make_protocol("rspaxos", G, sh["R"], sh["W"], cfg, device=device)
        return Engine(k, device=device)

    eng = engine(sh["G"], DEV)
    rs.bitslice_gf256.launches = 0
    t0 = time.perf_counter()
    st, ns, fx = drive(torch, eng, RS_TICKS, sh["P"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cb = st["commit_bar"].amax(dim=1)
    fb_follow = st["full_bar"][:, 1:].amin(dim=1)
    if int(cb.min()) <= 0 or int(fb_follow.min()) <= 0:
        fail("rspaxos: commit_bar / follower full_bar did not advance")
    log(f"rspaxos G={sh['G']} R={sh['R']} W={sh['W']} P={sh['P']} ft=1: "
        f"{RS_TICKS} ticks in {dt:.3f} s, commit_bar min {int(cb.min())}, "
        f"follower full_bar min {int(fb_follow.min())}, "
        f"{committed(st) / dt:.1f} committed slots/s | {card}")

    # the codeword plane over the window's last tick: each group's leader
    # proposed n_accepted values with ids value_base + i
    code = rs.RSCode(3, 2, device=DEV)
    n_acc = fx.extra["n_accepted"].amax(dim=1).cpu().numpy()
    B = int(n_acc.sum())
    if B == 0:
        fail("rspaxos: no values proposed in the last tick")
    groups = np.repeat(np.arange(sh["G"]), n_acc)
    rng = np.random.default_rng(SEED + 4)
    payloads = rng.integers(0, 256, size=(B, PAYLOAD), dtype=np.uint8)
    L = lanes_for(PAYLOAD, 3)
    host = pack_batch(np, payloads, 3, L)
    ref = rs.pack_bytes(payloads[0].tobytes(), 3, lane_multiple=128)
    if not np.array_equal(host[0], ref):
        fail("batched packing differs from pack_bytes")
    data = torch.from_numpy(host).to(DEV)
    parity = code.compute_parity(data)                      # one launch
    want = rs._bitslice_matmul_plain(code._parity_tbl, data)
    main_err = int((parity.long() - want.long()).abs().max())
    if not torch.equal(parity, want):
        fail("main-path encode: kernel != plain")
    cw = torch.cat([data, parity], dim=1)                   # [B, 5, L]
    subsets = list(itertools.combinations(range(5), 3))
    which = torch.from_numpy(groups % len(subsets)).to(DEV)
    decoded = torch.empty_like(data)
    for i, sub in enumerate(subsets):
        idx = torch.nonzero(which == i).flatten()
        if idx.numel():
            shards = cw.index_select(0, idx)[:, list(sub)].contiguous()
            decoded[idx] = code.reconstruct_data(shards, sub)
    torch.cuda.synchronize()
    back = decoded.cpu().numpy().view(np.uint8).reshape(B, -1)[:, :PAYLOAD]
    if not np.array_equal(back, payloads):
        fail("rspaxos: decoded payload bytes differ")
    log(f"codeword plane: {B} values x {PAYLOAD} B encoded in one "
        f"[{B}, 3, {L}] call, decoded from all ten 3-of-5 subsets "
        f"by group, bytes round-trip")

    store = CodewordStore(sh["G"], code, total=5, device=DEV)
    peer = CodewordStore(sh["G"], code, total=5, device=DEV)
    for j in range(4):
        g, vid = int(groups[j]), 1000 + j
        batch = payloads[j].tobytes()
        dlen, rows = store.encode(g, vid, batch, spr=1)
        sub = subsets[(j * 3 + 5) % len(subsets)]
        peer.add_shards(g, vid, dlen, {s: rows[s] for s in sub})
        if peer.reconstruct_batch(g, vid) != batch:
            fail(f"CodewordStore round-trip failed for value {j}")
        if peer.have_mask(g, vid) != 0b11111:
            fail("CodewordStore did not restore the full codeword")
    torch.cuda.synchronize()
    launches = rs.bitslice_gf256.launches
    if launches == 0:
        fail("the main path never launched bitslice_gf256")
    log(f"CodewordStore: 4 values encode -> add_shards -> reconstruct_batch "
        f"round-trip; bitslice_gf256 launches on the main path: {launches}")

    cpu = drive(torch, engine(CPU_GROUPS, "cpu"), RS_TICKS, sh["P"])
    n = compare_groups(torch, (st, ns), cpu[:2], CPU_GROUPS, "rspaxos")
    log(f"rspaxos: first {CPU_GROUPS} groups equal the CPU run over "
        f"{RS_TICKS} ticks ({n} state leaves + netstate)")
    profile_ticks(torch, eng, st, ns, PROFILE_TICKS, sh["P"], "rspaxos", card)

    # the kernel's numbers at the main path's encode shape
    k_ms = time_ms(torch, lambda: code.compute_parity(data), 20)
    p_ms = time_ms(torch, lambda: rs._bitslice_matmul_plain(
        code._parity_tbl, data), 3)
    b_ms, b_by = bound_ms(2, 3, B, L)
    log(f"main-path encode [{B},3,{L}]: kernel {k_ms:.4f} ms plain "
        f"{p_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}) share "
        f"{b_ms / k_ms:.3f} | {card}")
    return {"launches": launches, "max_abs_err": main_err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        import numpy as np
        import summerset_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"summerset_tpu_torch is not importable here: {e}",
              file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    card = card_label()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build()
    max_err = phase_kernels(torch, np, card)
    phase_multipaxos(torch, card)
    main_path = phase_rspaxos(torch, np, card)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "bitslice_gf256",
        "route": "cuda",
        "source": "summerset_tpu_torch/csrc/bitslice.cu",
        "replaces": "summerset_tpu/ops/rscoding.py:176",
        "launches": main_path["launches"],
        "max_abs_err": max(max_err, main_path["max_abs_err"]),
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
