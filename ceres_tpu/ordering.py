"""Elimination orderings for Schur-structured problems.

Capability parity with the reference's parameter_block_ordering.cc
(IndependentSetOrdering graph_algorithms.h:98, ComputeSchurOrdering
parameter_block_ordering.h:61). Fill-reducing AMD/NESDIS orderings for
sparse direct factorization are intentionally absent: the device direct
path factorizes batched dense blocks (see solvers/dense.py rationale), so
only the independent-set (Schur) ordering is structurally meaningful.
"""

from __future__ import annotations

from typing import List, Set


def independent_set_ordering(program) -> List[int]:
    """Greedy maximum independent set over the parameter-block interaction
    graph (two variable blocks are adjacent iff they co-occur in a residual
    block). Returns the keys (id(array)) of the independent set — the
    candidate e-blocks. Visits vertices in increasing degree order
    (graph_algorithms.h:98)."""
    problem = program.problem
    # program order (not a set): id() values differ run-to-run, so ties
    # must break on the deterministic block order or the e/f partition —
    # and with it the whole solve structure — changes across runs of the
    # same problem (the reference visits blocks in program order).
    ordered_keys = [id(b.array) for b in program.variable_blocks]
    var_keys = set(ordered_keys)
    pos = {k: i for i, k in enumerate(ordered_keys)}
    adj = {k: set() for k in var_keys}
    for rb in problem._residual_records():
        ks = [k for k in rb.param_keys if k in var_keys]
        for i in range(len(ks)):
            for j in range(i + 1, len(ks)):
                adj[ks[i]].add(ks[j])
                adj[ks[j]].add(ks[i])
    order = sorted(ordered_keys, key=lambda k: (len(adj[k]), pos[k]))
    chosen: Set[int] = set()
    blocked: Set[int] = set()
    for k in order:
        if k in blocked:
            continue
        chosen.add(k)
        blocked.update(adj[k])
    return [k for k in order if k in chosen]


def compute_schur_ordering(program) -> List[int]:
    """ComputeSchurOrdering: the independent set becomes elimination group 0
    (the e-blocks); everything else group 1."""
    return independent_set_ordering(program)
