"""Device table layouts — CSR automata converted to dense device arrays.

The reference engine walks CSR transition lists word-by-word out of BRAM
(``Design/FPGA.v:227-406``).  The device layout instead precomputes dense
per-byte-class tables at load time so the inner loop is pure vectorized
gather — no irregular CSR walk on device (SURVEY.md SS7.1 item 3).

All state math is integer (int32) end-to-end: the conformance contract is
bit-exactness (SURVEY.md SS7.4 item 4).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.csr import CsrAutomaton, byte_classes
from ..models.oracle import dfa_step_table

__all__ = ["NfaTables", "DfaTables", "build_nfa_tables", "build_dfa_tables",
           "stall_extend"]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["delta", "class_of", "accept"],
    meta_fields=["num_states", "max_fanout"],
)
@dataclasses.dataclass(frozen=True)
class NfaTables:
    """Dense NFA successor tables.

    ``delta[c, s, k]`` = k-th successor of state ``s`` on byte-class ``c``,
    or the sentinel ``num_states`` when absent.  Row ``num_states`` (the
    sentinel row) is all-sentinel, so sentinel slots in an active list are
    self-absorbing no-ops.
    """

    delta: jnp.ndarray      # (C, S+1, K) int32
    class_of: jnp.ndarray   # (256,) int32
    accept: jnp.ndarray     # (S+1,) bool; accept[S] = False
    num_states: int
    max_fanout: int

    @property
    def num_classes(self) -> int:
        return self.delta.shape[0]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["table", "class_of", "accept"],
    meta_fields=["num_states"],
)
@dataclasses.dataclass(frozen=True)
class DfaTables:
    """Dense DFA next-state table: ``table[c, s]`` on byte-class ``c``.

    Includes a dead state (index ``num_states - 1`` by convention of the
    builder) that is absorbing; accepting states transition to dead
    (reference accept semantics: out-degree 0, SURVEY.md SS3.3).
    """

    table: jnp.ndarray      # (C, S) int32
    class_of: jnp.ndarray   # (256,) int32
    accept: jnp.ndarray     # (S,) bool
    num_states: int

    @property
    def num_classes(self) -> int:
        return self.table.shape[0]


def build_nfa_tables(aut: CsrAutomaton) -> NfaTables:
    cls, num_classes = byte_classes(aut)
    s = aut.num_states
    k = max(aut.max_fanout(), 1)
    delta = np.full((num_classes, s + 1, k), s, dtype=np.int32)

    src = np.repeat(np.arange(s, dtype=np.int64), aut.out_degree)
    ch = aut.trans_char.astype(np.int64)
    # one representative byte per class (bytes in a class have identical
    # transition structure by construction — models/csr.py byte_classes)
    rep_of_class = np.full(num_classes, -1, dtype=np.int64)
    for b in range(255, -1, -1):
        rep_of_class[cls[b]] = b
    keep = ch == rep_of_class[cls[ch]]
    src, ch, tgt = src[keep], ch[keep], aut.trans_target[keep]
    # slot index within each (class, state) cell
    cell = cls[ch].astype(np.int64) * s + src
    order = np.argsort(cell, kind="stable")
    cell_s = cell[order]
    slot = np.arange(len(cell_s)) - np.searchsorted(cell_s, cell_s, side="left")
    delta[cls[ch[order]], src[order], slot] = tgt[order]

    accept = np.concatenate([aut.accept_mask, [False]])
    return NfaTables(
        delta=jnp.asarray(delta),
        class_of=jnp.asarray(cls),
        accept=jnp.asarray(accept),
        num_states=s,
        max_fanout=k,
    )


def build_dfa_tables(
    table_256: np.ndarray, accept: np.ndarray
) -> DfaTables:
    """Build from a dense (256, S) table (e.g. ``oracle.dfa_step_table`` or a
    compiled regex DFA), compressing the byte axis to equivalence classes.

    Rejects out-of-range transition targets at build time (SURVEY.md SS5.2:
    fail loudly on the host rather than silently mis-scan on the device —
    an out-of-range id makes the one-hot select yield state 0)."""
    table_256 = np.asarray(table_256)
    s = table_256.shape[1]
    if table_256.size and (table_256.min() < 0 or table_256.max() >= s):
        raise ValueError(
            f"transition targets must be in [0, {s}); got "
            f"[{table_256.min()}, {table_256.max()}]"
        )
    _, class_of = np.unique(table_256, axis=0, return_inverse=True)
    # np.unique sorts rows; rebuild table in class order
    reps = np.zeros(class_of.max() + 1, dtype=np.int64)
    reps[class_of] = np.arange(256)
    table = table_256[reps]
    return DfaTables(
        table=jnp.asarray(table.astype(np.int32)),
        class_of=jnp.asarray(class_of.astype(np.int32)),
        accept=jnp.asarray(np.asarray(accept, dtype=bool)),
        num_states=table_256.shape[1],
    )


def build_dfa_tables_from_csr(aut: CsrAutomaton) -> DfaTables:
    """DFA tables straight from a deterministic CsrAutomaton (adds the dead
    state and routes accepting states to it, matching reference timing)."""
    table = dfa_step_table(aut)          # (256, S+1) with dead = S
    accept = np.concatenate([aut.accept_mask, [False]])
    return build_dfa_tables(table, accept)


def stall_extend(tables: DfaTables) -> DfaTables:
    """Append a STALL byte class (id = ``tables.num_classes``) whose table
    column is the identity: a lane stepping on it stays in place.

    This is the ragged-batch device primitive (r4 verdict item 3):
    variable-length streams pad to a common bucket length with the stall
    class, run as ordinary chain lanes in ONE GEMM chain, and finish with
    their true final state frozen in place.  The only side effect is that
    the counting pass sees the frozen state once per padded step — an
    exact, host-side subtraction (``api.DfaMatcher._scan_ragged_counts``).
    No real byte maps to the class (``class_of`` is unchanged), so
    equal-length scans through the same tables are untouched."""
    ident = jnp.arange(tables.num_states, dtype=jnp.int32)[None, :]
    return dataclasses.replace(
        tables, table=jnp.concatenate([tables.table, ident], axis=0)
    )
