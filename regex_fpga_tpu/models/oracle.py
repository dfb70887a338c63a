"""Golden CPU oracles — the bit-exactness root of the test pyramid.

Implements the reference engine's match semantics exactly (SURVEY.md SS3.3,
derived from ``Design/FPGA.v:210-226`` accept detection and the
``current <= next`` swap at ``FPGA.v:733-737``):

1. accepting iff out-degree 0;
2. an accept entered on character ``k`` is *counted during the scan of
   character ``k+1``* (the state must be in ``current`` while a character is
   being processed), so an accept entered by the final character is never
   counted (the harness stops after the last scan,
   ``Simulation/testbench_BLK_Mem.sv:71``);
3. the match identifier is the raw state index, counted per state;
4. accepting states contribute no successors (out-degree 0) so they stay
   active exactly one character.

These oracles are deliberately simple Python/NumPy; the C++ fast oracle in
``native/`` and every device engine are validated against them.
"""

from __future__ import annotations

import numpy as np

from .csr import CsrAutomaton

__all__ = ["nfa_scan", "dfa_scan_counts", "dfa_step_table", "nfa_scan_trace"]


def _edge_dicts(aut: CsrAutomaton) -> list[dict[int, list[int]]]:
    """Per-state {byte: [targets]} adjacency."""
    out: list[dict[int, list[int]]] = []
    for i in range(aut.num_states):
        chars, targets = aut.edges(i)
        d: dict[int, list[int]] = {}
        for c, t in zip(chars.tolist(), targets.tolist()):
            d.setdefault(c, []).append(t)
        out.append(d)
    return out


def nfa_scan(
    aut: CsrAutomaton,
    stream: np.ndarray,
    start_states: tuple[int, ...] = (0,),
) -> np.ndarray:
    """Run one byte stream through the NFA; return per-state match counts.

    Reproduces the reference testbench counters (``match_count[i]``,
    ``Simulation/testbench_BLK_Mem.sv:61-69``) bit-exactly.
    """
    edges = _edge_dicts(aut)
    outdeg = aut.out_degree
    counts = np.zeros(aut.num_states, dtype=np.int64)
    current = set(start_states)
    for ch in np.asarray(stream).tolist():
        nxt: set[int] = set()
        for i in current:
            if outdeg[i] == 0:
                counts[i] += 1
            else:
                nxt.update(edges[i].get(ch, ()))
        current = nxt
    return counts


def nfa_scan_trace(
    aut: CsrAutomaton, stream: np.ndarray, start_states: tuple[int, ...] = (0,)
) -> list[set[int]]:
    """Like nfa_scan but returns the sequence of active sets (for debugging
    and for the active-set-size invariant tests, SURVEY.md SS4.2)."""
    edges = _edge_dicts(aut)
    outdeg = aut.out_degree
    current = set(start_states)
    history = [set(current)]
    for ch in np.asarray(stream).tolist():
        nxt: set[int] = set()
        for i in current:
            if outdeg[i] != 0:
                nxt.update(edges[i].get(ch, ()))
        current = nxt
        history.append(set(current))
    return history


def dfa_step_table(aut: CsrAutomaton, dead_state: int | None = None) -> np.ndarray:
    """Dense (256, N[+1]) next-state table for a DFA-shaped CsrAutomaton.

    Missing transitions go to ``dead_state`` (appended as state N with a
    self-loop if not given).  Raises if the automaton is not deterministic.
    """
    if not aut.is_dfa():
        raise ValueError("automaton is an NFA; dfa_step_table requires a DFA")
    n = aut.num_states
    dead = n if dead_state is None else dead_state
    size = n + 1 if dead_state is None else n
    table = np.full((256, size), dead, dtype=np.int32)
    src = np.repeat(np.arange(n, dtype=np.int64), aut.out_degree)
    table[aut.trans_char.astype(np.int64), src] = aut.trans_target
    return table


def dfa_scan_counts(
    table: np.ndarray, accept_mask: np.ndarray, stream: np.ndarray, start: int = 0
) -> np.ndarray:
    """Serial DFA scan with the reference match timing.

    ``table`` is (256, S) next-state; ``accept_mask`` is (S,) bool.  An
    accepting DFA state must behave like the NFA's out-degree-0 states: it is
    counted one character late and transitions to the dead state (callers
    building DFAs from reference-style automata must encode accepting rows as
    all-dead).  Returns per-state counts, shape (S,).
    """
    counts = np.zeros(table.shape[1], dtype=np.int64)
    s = start
    for ch in np.asarray(stream).tolist():
        if accept_mask[s]:
            counts[s] += 1
        s = int(table[ch, s])
    return counts
