"""Jacobi chain scan for LARGE state spaces (lazy subset DFAs).

The one-hot GEMM engine (``dfa_fast``) costs C*S MACs per byte — cheap for
S <= a few hundred, hopeless for the 10^4-10^5-state lazy subset automata.
Here each chain step is ONE flat gather ``table[cls * M + s]`` per block
lane: one table load per scanned byte.  Its rate on the GPU is not
measured yet (ROADMAP S2/R1).

Unknown-frontier semantics for the lazy-DFA host/device loop: the table's
``unknown`` id must be absorbing; positions at/after the first unknown visit
in a block are garbage but everything before is exact, which is all the
host expansion loop needs (models/lazy_dfa.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["TakeScanResult", "dfa_scan_take"]


class TakeScanResult(NamedTuple):
    final_state: jnp.ndarray   # () int32
    states: jnp.ndarray        # (L,) int32 — state before consuming byte i
    converged: jnp.ndarray     # () bool
    iterations: jnp.ndarray    # () int32


def _chain(table_flat, m1, cls_seq, entries, with_states):
    def body(state, cls_t):
        nxt = jnp.take(table_flat, cls_t * m1 + state)
        return nxt, (state if with_states else None)

    finals, states = jax.lax.scan(body, entries, cls_seq)
    return finals, states


def _sync_entries(table_flat, m1, cls_seq, start, num_blocks, sync_overlap, sync_state):
    """Initial entry guesses via overlap synchronization.

    A naive all-``start`` guess makes wrong-guess chains wander into state
    space the lazy DFA never explored (straight to the unknown sentinel) and
    Jacobi cannot converge.  Instead, guess block n's entry by scanning the
    LAST ``sync_overlap`` bytes of block n-1 from the hub state
    (``sync_state``): IDS/tokenizer automata synchronize within a few dozen
    bytes, and a hub-rooted scan follows exactly the trace-like paths the
    lazy DFA has already interned."""
    b = cls_seq.shape[0]
    w = min(sync_overlap, b)
    if w <= 0:
        return jnp.full((num_blocks,), start, dtype=jnp.int32)
    ov = cls_seq[b - w :, :]  # (W, NB): column n = tail of block n
    hub = jnp.full((num_blocks,), sync_state, dtype=jnp.int32)
    ov_finals, _ = _chain(table_flat, m1, ov, hub, False)
    return jnp.concatenate([start[None], ov_finals[:-1]])


@functools.partial(
    jax.jit, static_argnames=("num_blocks", "max_iters", "sync_overlap")
)
def dfa_scan_take(
    table: jnp.ndarray,       # (C, M+1) int32, unknown row absorbing
    classes: jnp.ndarray,     # (L,) int32 byte-class ids
    num_blocks: int = 4096,
    start: int = 0,
    max_iters: int = 16,
    sync_overlap: int = 64,
    sync_state: int = 0,
) -> TakeScanResult:
    l = classes.shape[0]
    assert l % num_blocks == 0
    b = l // num_blocks
    m1 = table.shape[1]
    table_flat = table.reshape(-1)
    cls_seq = classes.astype(jnp.int32).reshape(num_blocks, b).T  # (B, NB)
    start = jnp.asarray(start, jnp.int32)

    def shift(finals):
        return jnp.concatenate([start[None], finals[:-1]])

    def cond(carry):
        _, done, it = carry
        return jnp.logical_and(~done, it < max_iters)

    def body(carry):
        entries, _, it = carry
        finals, _ = _chain(table_flat, m1, cls_seq, entries, False)
        new_entries = shift(finals)
        return new_entries, jnp.all(new_entries == entries), it + 1

    entries0 = _sync_entries(
        table_flat, m1, cls_seq, start, num_blocks, sync_overlap, sync_state
    )
    entries, converged, iters = jax.lax.while_loop(
        cond, body, (entries0, jnp.array(False), jnp.array(0, jnp.int32))
    )
    finals, states = _chain(table_flat, m1, cls_seq, entries, True)
    return TakeScanResult(
        final_state=finals[-1],
        states=states.T.reshape(-1),
        converged=converged,
        iterations=iters,
    )


class TakeCountsResult(NamedTuple):
    final_state: jnp.ndarray    # () int32
    visits_acc: jnp.ndarray     # (M+1,) int32 — accumulated subset-state visits
    converged: jnp.ndarray      # () bool
    unknown_hit: jnp.ndarray    # () bool — chunk touched the frontier
    iterations: jnp.ndarray     # () int32


@functools.partial(
    jax.jit,
    static_argnames=("num_blocks", "max_iters", "sync_overlap"),
    donate_argnames=("visits_acc",),
)
def dfa_scan_take_counts(
    table: jnp.ndarray,       # (C, M+1) int32, unknown row absorbing
    classes: jnp.ndarray,     # (L,) int32
    visits_acc: jnp.ndarray,  # (M+1,) int32 running per-state visit counts
    num_blocks: int = 1024,
    start: int = 0,
    max_iters: int = 16,
    sync_overlap: int = 64,
    sync_state: int = 0,
) -> TakeCountsResult:
    """Chunk scan with DEVICE-side visit counting.

    Per-position states never leave the device (their readback would
    cost 4 B per scanned byte): visits bincount on device, accumulated into
    ``visits_acc`` (donated) ONLY when the chunk is clean — on an unknown
    hit or non-convergence the accumulator is left untouched and the caller
    re-runs the chunk via ``dfa_scan_take`` / the host path.
    """
    l = classes.shape[0]
    assert l % num_blocks == 0
    b = l // num_blocks
    m1 = table.shape[1]
    table_flat = table.reshape(-1)
    cls_seq = classes.astype(jnp.int32).reshape(num_blocks, b).T
    start = jnp.asarray(start, jnp.int32)

    def shift(finals):
        return jnp.concatenate([start[None], finals[:-1]])

    def cond(carry):
        _, done, it = carry
        return jnp.logical_and(~done, it < max_iters)

    def body(carry):
        entries, _, it = carry
        finals, _ = _chain(table_flat, m1, cls_seq, entries, False)
        new_entries = shift(finals)
        return new_entries, jnp.all(new_entries == entries), it + 1

    entries0 = _sync_entries(
        table_flat, m1, cls_seq, start, num_blocks, sync_overlap, sync_state
    )
    entries, converged, iters = jax.lax.while_loop(
        cond, body, (entries0, jnp.array(False), jnp.array(0, jnp.int32))
    )
    finals, states = _chain(table_flat, m1, cls_seq, entries, True)
    visits = jnp.bincount(states.reshape(-1), length=m1)
    # frontier escape shows either as a visited unknown (state before some
    # byte) or as the LAST transition landing on it (final_state == unknown)
    unknown_hit = jnp.logical_or(visits[m1 - 1] > 0, finals[-1] == m1 - 1)
    ok = jnp.logical_and(converged, ~unknown_hit)
    new_acc = jnp.where(ok, visits_acc + visits.astype(jnp.int32), visits_acc)
    return TakeCountsResult(
        final_state=finals[-1],
        visits_acc=new_acc,
        converged=converged,
        unknown_hit=unknown_hit,
        iterations=iters,
    )
