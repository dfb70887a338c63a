"""Device NFA active-set engine — the bit-exact conformance path.

The reference engine scans every state index serially per character
(1 cycle per inactive state, ``Design/FPGA.v:744-765``), so its cost is
O(num_states) per byte.  Here the active set is instead carried as a bounded
sorted index list (the shipped rulesets never exceed 37 simultaneously active
states — SURVEY.md SS4.2) and one step is:

    gather successors of all active states from the dense (C, S+1, K) table,
    dedupe with a fixed-size sort (``jnp.unique(size=A)``), count accepts.

Everything is integer math inside one ``lax.scan`` over bytes; batching over
streams (the generalization of the reference's dual-stream mode,
``FPGA.v:54-57``) is a ``vmap``.  Overflow of the bound is detected, not
silently dropped.

Match semantics (SURVEY.md SS3.3): a state is counted iff it is accepting
(out-degree 0) and present in the active set when a character is scanned;
accepts entered by the final character are never counted.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .tables import NfaTables

__all__ = ["NfaScanResult", "nfa_scan_jax", "nfa_scan_batch", "DEFAULT_ACTIVE_BOUND"]

DEFAULT_ACTIVE_BOUND = 128


class NfaScanResult(NamedTuple):
    counts: jnp.ndarray        # (S,) int32 per-state match counts
    final_active: jnp.ndarray  # (A,) int32 sorted active list (sentinel-padded)
    overflowed: jnp.ndarray    # () bool — True if the active bound was exceeded


def _nfa_step(delta, accept, num_states, active, counts, cls_b, active_bound):
    """One character step.  active: (A,) sorted int32 with sentinel padding."""
    # accept counting happens on the set active *while this char is scanned*
    acc = accept[active]
    counts = counts.at[active].add(acc.astype(jnp.int32))
    # successors of all active states on this byte class: (A, K)
    cand = delta[cls_b][active].reshape(-1)
    # fixed-size dedupe; ask for one extra slot to detect overflow
    uniq = jnp.unique(cand, size=active_bound + 1, fill_value=num_states)
    overflow = uniq[active_bound] != num_states
    return uniq[:active_bound], counts, overflow


@functools.partial(jax.jit, static_argnames=("active_bound",))
def nfa_scan_jax(
    tables: NfaTables,
    stream: jnp.ndarray,
    active_bound: int = DEFAULT_ACTIVE_BOUND,
    start_active: jnp.ndarray | None = None,
    counts_init: jnp.ndarray | None = None,
) -> NfaScanResult:
    """Scan one uint8 stream; returns per-state counts (bit-exact vs oracle).

    ``start_active``/``counts_init`` allow chunked resume: pass the previous
    chunk's ``final_active``/``counts`` to continue a stream across chunk
    boundaries (the checkpoint carry of SURVEY.md SS5.4).
    """
    s = tables.num_states
    if start_active is None:
        start_active = jnp.full((active_bound,), s, dtype=jnp.int32).at[0].set(0)
    if counts_init is None:
        counts_init = jnp.zeros((s + 1,), dtype=jnp.int32)

    classes = tables.class_of[stream.astype(jnp.int32)]

    def step(carry, cls_b):
        active, counts, overflow = carry
        active, counts, ov = _nfa_step(
            tables.delta, tables.accept, s, active, counts, cls_b, active_bound
        )
        return (active, counts, overflow | ov), None

    (active, counts, overflow), _ = jax.lax.scan(
        step, (start_active, counts_init, jnp.array(False)), classes
    )
    return NfaScanResult(counts=counts[:s], final_active=active, overflowed=overflow)


@functools.partial(jax.jit, static_argnames=("active_bound",))
def nfa_scan_batch(
    tables: NfaTables, streams: jnp.ndarray, active_bound: int = DEFAULT_ACTIVE_BOUND
) -> NfaScanResult:
    """Batched scan over (B, L) streams — per-stream counts (B, S).

    The reference runs exactly 2 concurrent streams (``FPGA.v:17``); here the
    batch axis is arbitrary and maps onto vector lanes / mesh data axes.
    """
    return jax.vmap(lambda st: nfa_scan_jax(tables, st, active_bound))(streams)
