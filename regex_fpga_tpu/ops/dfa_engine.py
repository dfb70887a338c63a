"""DFA speculative-scan engine — the high-throughput path (jnp reference).

The reference's per-character state chain is strictly serial
(``current <= next`` once per char, ``Design/FPGA.v:733-737``) — the central
limitation the device build removes (SURVEY.md SS5.7).  The parallelization is
the classic associative-function-composition scheme:

  pass 1 (parallel over blocks): each block of B bytes computes its composed
     transition *function* f_block: S -> S by stepping all S start states
     simultaneously (speculative, vectorized over the S lane dimension);
  combine: entry states of blocks via an exclusive ``associative_scan`` with
     the composition operator (f after g)[s] = f[g[s]] (a gather);
  pass 2 (parallel over blocks): re-scan each block from its now-known true
     entry state (one lane per block) to emit exact per-position match state
     with the reference timing (accept counted one char late, final-char
     accept dropped — SURVEY.md SS3.3).

Total work = L*(S+1) gathers for full per-position output, or pass 1 only
(L*S) when just the composed function / final state is needed.  This module
is the jnp-level reference implementation and the exact fallback of the fast
engines.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .tables import DfaTables

__all__ = [
    "DfaScanResult",
    "dfa_scan_serial",
    "block_transition_functions",
    "compose",
    "block_entry_states",
    "dfa_scan_blocked",
    "dfa_match_positions",
]


class DfaScanResult(NamedTuple):
    counts: jnp.ndarray       # (S,) int32 per-state match counts
    final_state: jnp.ndarray  # () int32 state after the full stream
    match_mask: jnp.ndarray | None  # (L,) bool — accept fired at position (or None)


def compose(f: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Composition of transition functions: apply ``f`` first, then ``g``.

    Shapes (..., S); returns h with h[s] = g[f[s]].  Associative, which is
    what lets ``jax.lax.associative_scan`` parallelize the chain.
    """
    return jnp.take_along_axis(g, f, axis=-1)


@jax.jit
def dfa_scan_serial(tables: DfaTables, stream: jnp.ndarray, start: int = 0) -> DfaScanResult:
    """Strictly serial scan (one gather per byte) — oracle + latency baseline."""
    classes = tables.class_of[stream.astype(jnp.int32)]

    def step(carry, cls_b):
        s, counts = carry
        counts = counts.at[s].add(tables.accept[s].astype(jnp.int32))
        return (tables.table[cls_b, s], counts), tables.accept[s]

    (s, counts), matches = jax.lax.scan(
        step,
        (jnp.asarray(start, dtype=jnp.int32), jnp.zeros(tables.num_states, jnp.int32)),
        classes,
    )
    return DfaScanResult(counts=counts, final_state=s, match_mask=matches)


def block_transition_functions(tables: DfaTables, classes: jnp.ndarray) -> jnp.ndarray:
    """Pass 1.  ``classes``: (NB, B) byte-class ids.  Returns (NB, S) int32
    block functions: f[n, s] = state after block n when entered in state s."""
    nb, _ = classes.shape
    s = tables.num_states
    init = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (nb, s))

    def step(states, cls_t):
        # states: (NB, S); cls_t: (NB,). flat gather into (C*S) table
        idx = cls_t[:, None] * s + states
        return jnp.take(tables.table.reshape(-1), idx), None

    out, _ = jax.lax.scan(step, init, classes.T)
    return out


def block_entry_states(
    block_fns: jnp.ndarray, start: int = 0
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Combine.  Returns (entry_states (NB,), final_state ()).

    entry_states[n] = state at the start of block n when the whole stream is
    entered at ``start`` — an exclusive prefix composition, computed with a
    log-depth associative scan over the block functions.
    """
    prefix = jax.lax.associative_scan(lambda a, b: compose(a, b), block_fns, axis=0)
    entry = jnp.concatenate(
        [jnp.full((1,), start, dtype=jnp.int32), prefix[:-1, start].astype(jnp.int32)]
    )
    return entry, prefix[-1, start].astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("block_size", "collect_matches"))
def dfa_scan_blocked(
    tables: DfaTables,
    stream: jnp.ndarray,
    block_size: int = 1024,
    start: int = 0,
    collect_matches: bool = True,
) -> DfaScanResult:
    """Block-parallel scan with exact reference match semantics.

    ``len(stream)`` must be a multiple of ``block_size`` (callers pad with a
    byte class that maps the dead state to itself and strip counts later, or
    use the chunked API in ``parallel/``).
    """
    l = stream.shape[0]
    assert l % block_size == 0, "pad stream to a multiple of block_size"
    nb = l // block_size
    s = tables.num_states
    classes = tables.class_of[stream.astype(jnp.int32)].reshape(nb, block_size)

    block_fns = block_transition_functions(tables, classes)
    entry, final_state = block_entry_states(block_fns, start)

    # pass 2: exact re-scan of each block from its true entry state.
    def step(states, cls_t):
        # states: (NB,) current state of each block
        nxt = tables.table[cls_t, states]
        return nxt, states

    _, states_t = jax.lax.scan(step, entry, classes.T)  # (B, NB) state before byte t
    visited = states_t.T.reshape(-1)                     # (L,) in stream order
    is_match = tables.accept[visited]
    counts = jnp.bincount(
        jnp.where(is_match, visited, s), length=s + 1, minlength=s + 1
    )[:s].astype(jnp.int32)
    return DfaScanResult(
        counts=counts,
        final_state=final_state,
        match_mask=is_match if collect_matches else None,
    )


def dfa_match_positions(result: DfaScanResult) -> jnp.ndarray:
    """Positions (0-based byte index) at which a match fired.  Note the
    reference timing: a match at position p was *entered* by byte p-1."""
    assert result.match_mask is not None
    return jnp.nonzero(result.match_mask)[0]
