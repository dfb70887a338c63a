"""Tensor-parallel NFA scan — the automaton STATE dimension sharded over chips.

SURVEY.md SS2.2 lists tensor parallelism as the one axis the reference lacks
that only matters for rulesets far larger than the two shipped images
("shard the S-dimension of NFA bitset/transition tables over a ``model``
axis for very large rulesets").  This module implements that axis as a
first-class engine rather than a documented decision:

- The active set is carried as a FULL S-bit bitmap (the direct device analogue
  of the reference's per-state BFS bitmaps ``current``/``next``,
  ``Design/FPGA.v:54-57``) instead of the bounded active list of
  ``ops/nfa_engine.py`` — so there is no active-set bound to overflow, at the
  cost of O(S) work per byte.  That O(S) is exactly what gets sharded.
- Each device owns a contiguous slice of states: its rows of the dense
  successor table ``delta[c, s_local, k]``, its slice of the accept mask,
  its slice of the bitmap, and its slice of the per-state match counters.
- One character step: every device expands the successors of its LOCAL
  active states into a full-width predecessor-count vector (a scatter-add of
  at most ``S_local * K`` indices), a single ``lax.psum`` over the ``model``
  axis merges the partial counts (the tensor-parallel all-reduce), and each
  device keeps its slice of ``counts > 0`` as the next bitmap.  Integer math
  throughout — the bit-exactness contract of SURVEY.md SS7.4 holds.
- Accept counting is shard-local (state s is counted by the device owning
  s while it is active, reproducing the reference's one-char-late timing,
  SURVEY.md SS3.3) and needs no communication until the final gather.

Memory per device is O(C * S/P * K) for the table shard — the whole point:
a ruleset 8x larger than HBM-per-chip allows still scans, with one (S,)
int32 all-reduce per byte as the only cross-chip traffic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops.tables import NfaTables
from .mesh import DATA_AXIS, MODEL_AXIS

__all__ = ["nfa_scan_tp", "pad_tables_tp"]


def pad_tables_tp(tables: NfaTables, n_model: int):
    """Pad the (C, S+1, K) successor table so the state axis splits evenly
    over ``n_model`` devices.  Padding rows behave like the sentinel row
    (all successors = sentinel, non-accepting) and are never activated."""
    delta = np.asarray(tables.delta)
    accept = np.asarray(tables.accept)
    c, s1, k = delta.shape
    s = tables.num_states  # sentinel row index
    s_pad = ((s1 + n_model - 1) // n_model) * n_model
    if s_pad != s1:
        pad = np.full((c, s_pad - s1, k), s, dtype=delta.dtype)
        delta = np.concatenate([delta, pad], axis=1)
        accept = np.concatenate(
            [accept, np.zeros(s_pad - s1, dtype=bool)]
        )
    return jnp.asarray(delta), jnp.asarray(accept), s_pad


def nfa_scan_tp(
    mesh,
    tables: NfaTables,
    streams: jnp.ndarray,
    start_bitmap: jnp.ndarray | None = None,
    counts_init: jnp.ndarray | None = None,
):
    """Bit-exact NFA scan with states sharded over the mesh ``model`` axis.

    ``streams``: (B, L) uint8, B divisible by the ``data`` axis size.
    ``start_bitmap``/``counts_init``: optional (B, S_pad) resume carries from
    a previous chunk's ``final_bitmap``/raw counts (SURVEY.md SS5.4 — the
    checkpoint state is just the bitmap + counters, as in the reference).

    Returns ``(counts, final_bitmap)``: per-stream per-state match counts
    (B, S) and the final active bitmaps (B, S_pad) (slice [:, :S] for the
    real states; slot S is the self-absorbing sentinel).
    """
    n_model = mesh.shape[MODEL_AXIS]
    s = tables.num_states
    k = tables.max_fanout
    delta, accept, s_pad = pad_tables_tp(tables, n_model)
    s_loc = s_pad // n_model

    batch, _ = streams.shape
    if start_bitmap is None:
        start_bitmap = (
            jnp.zeros((batch, s_pad), dtype=bool).at[:, 0].set(True)
        )
    if counts_init is None:
        counts_init = jnp.zeros((batch, s_pad), dtype=jnp.int32)
    elif counts_init.shape[1] != s_pad:  # resume from a sliced (B, S) result
        counts_init = jnp.pad(
            counts_init.astype(jnp.int32),
            ((0, 0), (0, s_pad - counts_init.shape[1])),
        )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(None, MODEL_AXIS, None),   # delta rows
            P(MODEL_AXIS),               # accept slice
            P(),                         # class_of (replicated)
            P(DATA_AXIS, None),          # streams
            P(DATA_AXIS, MODEL_AXIS),    # start bitmaps
            P(DATA_AXIS, MODEL_AXIS),    # initial counts
        ),
        out_specs=(P(DATA_AXIS, MODEL_AXIS), P(DATA_AXIS, MODEL_AXIS)),
        check_vma=False,
    )
    def run(delta_loc, accept_loc, class_of, streams_loc, bm0, cnt0):
        classes = class_of[streams_loc.astype(jnp.int32)]  # (B_loc, L)
        acc_i = accept_loc.astype(jnp.int32)
        off = jax.lax.axis_index(MODEL_AXIS) * s_loc

        def scan_one(stream_cls, bitmap0, counts0):
            def step(carry, cls_b):
                bm, counts = carry
                # accept fires while the char is scanned (one-char-late,
                # final-char accepts dropped by loop structure)
                counts = counts + bm.astype(jnp.int32) * acc_i
                cand = delta_loc[cls_b].reshape(-1)        # (S_loc*K,)
                w = jnp.repeat(bm.astype(jnp.int32), k)
                partial = jnp.zeros((s_pad,), jnp.int32).at[cand].add(w)
                total = jax.lax.psum(partial, MODEL_AXIS)  # TP all-reduce
                nxt = jax.lax.dynamic_slice(total, (off,), (s_loc,)) > 0
                return (bm_mask_sentinel(nxt), counts), None

            def bm_mask_sentinel(bm):
                # sentinel slot S collects "no successor" fills; keep it out
                # of the bitmap so padded automata stay byte-for-byte equal
                # to the unsharded engine's carries
                idx = jnp.arange(s_loc) + off
                return jnp.where(idx == s, False, bm)

            (bm, counts), _ = jax.lax.scan(
                step, (bitmap0, counts0), stream_cls
            )
            return counts, bm

        counts, finals = jax.vmap(scan_one)(classes, bm0, cnt0)
        return counts, finals

    counts, finals = run(
        delta, accept, tables.class_of, streams, start_bitmap, counts_init
    )
    return counts[:, :s], finals
