"""EPaxos host-side execution: exact Tarjan SCC ordering over the
committed dependency graph, producing the ``exec_floor_rows`` kernel input
(the authoritative execution path; the in-kernel row-frontier heuristic is
the device-only approximation, ``protocols/epaxos.py``).

The port's own copy of ``summerset_tpu/host/epaxos_exec.py`` (the port
imports nothing of the JAX package): the same Tarjan order, the same
``lost_rows`` and the same ``payload_ok`` blocking.  Numpy and plain
Python; it reads the replica's 2-D window as numpy arrays.

Parity: reference ``src/protocols/epaxos/execution.rs:11-87`` — build the
dependency graph over committed-but-unexecuted instances, Tarjan SCCs,
execute SCCs in reverse topological order, ordering within an SCC by
sequence number.

Adaptation to the kernel's frontier dependency encoding: an instance's
``deps`` vector stores, per row, the highest interfering column bar — the
dependency set is the whole prefix of each row below that bar.  Because
the kernel consumes execution progress as a per-row contiguous *frontier*
(``exec_row``), instances additionally chain on their own-row
predecessor, which linearizes execution within a row without changing the
cross-row SCC order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

COMMITTED = 3  # protocols/epaxos.py status code


class EPaxosExecutor:
    """Per-group incremental Tarjan applier.

    ``advance(...)`` consumes the replica's own view of the 2-D window
    arrays and returns the new per-row exec floors after applying every
    instance whose full dependency closure is committed.  ``apply_fn``
    receives ``(row, col, vid, is_noop)`` in the exact execution order.
    """

    def __init__(self, num_rows: int, window: int,
                 apply_fn: Callable[[int, int, int, bool], None]):
        self.R = num_rows
        self.W = window
        self.apply_fn = apply_fn
        self.floor = [0] * num_rows  # contiguous executed frontier
        self.lost_rows: List[int] = []  # rows needing install-snapshot

    # ------------------------------------------------------------ advance
    def advance(
        self,
        abs2: np.ndarray,    # [R, W] absolute column at window pos (-1 =
        st2: np.ndarray,     # [R, W] status                      empty)
        seq2: np.ndarray,    # [R, W]
        val2: np.ndarray,    # [R, W]
        noop2: np.ndarray,   # [R, W]
        deps2: np.ndarray,   # [R, W, R] per-row interference frontier
        cmt_row: np.ndarray,  # [R] per-row contiguous committed frontier
        payload_ok: Optional[Callable[[int, bool], bool]] = None,
    ) -> List[int]:
        R, W = self.R, self.W

        def lookup(r: int, c: int) -> Optional[int]:
            p = c % W
            return p if abs2[r, p] == c else None

        # candidate nodes: committed, unexecuted, inside the window.  A
        # committed column that our stored copy no longer holds (the
        # window slid past it while we were paused/partitioned) is a LOST
        # instance: the row stalls here and the caller must install-
        # snapshot past it (self.lost_rows signals that need).
        self.lost_rows: List[int] = []
        nodes: Dict[Tuple[int, int], Tuple[int, int, bool, np.ndarray]] = {}
        for r in range(R):
            for c in range(self.floor[r], int(cmt_row[r])):
                p = lookup(r, c)
                if p is None:
                    self.lost_rows.append(r)
                    break
                if st2[r, p] != COMMITTED:
                    break  # gap: not yet committed contiguously
                nodes[(r, c)] = (
                    int(seq2[r, p]), int(val2[r, p]),
                    bool(noop2[r, p]), deps2[r, p],
                )

        if not nodes:
            return list(self.floor)

        # edges: own-row predecessor + the per-row dependency frontiers.
        # ``dep[r2]`` is an EXCLUSIVE bar (the kernel's interference
        # tables carry "highest same-bucket column bar": columns < bar
        # are dependencies).  A bar below the floor is already executed;
        # a bar past the row's committed frontier blocks the node.
        blocked: set = set()
        edges: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for (r, c), (_seq, _vid, _noop, dep) in nodes.items():
            if payload_ok is not None and not payload_ok(_vid, _noop):
                blocked.add((r, c))  # committed but payload not yet here
            out = []
            if c - 1 >= self.floor[r]:
                out.append((r, c - 1))
            for r2 in range(R):
                if r2 == r:
                    continue
                d = int(dep[r2])
                if d <= 0:
                    continue  # no dependency on this row
                if d > int(cmt_row[r2]):
                    blocked.add((r, c))  # depends on uncommitted tail
                # prefix semantics: an edge to the last dependency column
                # suffices — that node chains to the rest of the prefix
                hi = min(d, int(cmt_row[r2])) - 1
                if hi >= self.floor[r2]:
                    out.append((r2, hi))
            kept = []
            for e in out:
                if e in nodes:
                    kept.append(e)
                elif e[1] >= self.floor[e[0]]:
                    # the dependency is unexecuted but absent from the
                    # candidate set (lost to a window slide or an
                    # uncommitted gap): the dependent must WAIT, never
                    # execute ahead of it
                    blocked.add((r, c))
            edges[(r, c)] = kept

        # transitively block nodes that reach a blocked node
        changed = True
        while changed:
            changed = False
            for n, outs in edges.items():
                if n not in blocked and any(e in blocked for e in outs):
                    blocked.add(n)
                    changed = True
        runnable = {n for n in nodes if n not in blocked}
        if not runnable:
            return list(self.floor)

        # iterative Tarjan over the runnable subgraph
        index: Dict[Tuple[int, int], int] = {}
        low: Dict[Tuple[int, int], int] = {}
        on_stack: set = set()
        stack: List[Tuple[int, int]] = []
        sccs: List[List[Tuple[int, int]]] = []
        counter = [0]

        def strongconnect(root):
            work = [(root, iter(
                [e for e in edges[root] if e in runnable]
            ))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(
                            [e for e in edges[w] if e in runnable]
                        )))
                        advanced = True
                        break
                    elif w in on_stack:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    sccs.append(comp)

        for n in sorted(runnable):
            if n not in index:
                strongconnect(n)

        # Tarjan emits SCCs in reverse topological order of the
        # condensation — i.e. dependencies first, which IS execution
        # order (execution.rs processes tarjan_scc output in order).
        # Within an SCC: sequence number, row id as tie-break.
        executed: set = set()
        for comp in sccs:
            comp.sort(key=lambda n: (nodes[n][0], n[0], n[1]))
            for (r, c) in comp:
                seq, vid, noop, _dep = nodes[(r, c)]
                self.apply_fn(r, c, vid, noop)
                executed.add((r, c))

        # advance contiguous per-row floors over executed prefixes
        for r in range(R):
            c = self.floor[r]
            while (r, c) in executed:
                c += 1
            self.floor[r] = c
        return list(self.floor)
