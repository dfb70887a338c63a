"""Distributed scans: shard_map over the (data, seq) mesh.

Layout (SURVEY.md SS5.8): automaton tables are small (0.35-0.5 MiB per
shipped ruleset) and REPLICATED per chip; byte streams are SHARDED — the
batch of streams over the ``data`` axis, and each stream's blocks over the
``seq`` axis.  Cross-chip seams are resolved with the same Jacobi fixpoint
as intra-chip block seams, except the entry of a chip's first block arrives
from the previous device via ``lax.ppermute``; the convergence flag and match
totals reduce with ``psum``.  No other communication exists — the inner loop
is entirely local work.

The NFA conformance engine distributes over ``data`` only (each stream's
active-set chain is short-range serial; streams are independent, mirroring
the reference's two fully independent streams, SURVEY.md SS3.3 item 5).

The k-gram counting engine — the single-chip throughput headline — runs on
the same mesh via ``dfa_scan_kgram_dist`` (k-gram tables compose
associatively exactly like k=1 tables, so the seam machinery is shared);
``parallel.ingest.dist_resilient_scan`` chains chunked corpus ingest into
either scan with per-stream carries (BASELINE config 5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.dfa_fast import chain_pass_finals, chain_pass_full
from ..ops.kgram import kgram_pass_full, make_kgram_step
from ..ops.nfa_engine import DEFAULT_ACTIVE_BOUND, nfa_scan_batch
from ..ops.tables import DfaTables, NfaTables
from .mesh import DATA_AXIS, SEQ_AXIS

__all__ = ["nfa_scan_dist", "dfa_scan_fast_dist", "dfa_scan_kgram_dist"]


def nfa_scan_dist(mesh, tables: NfaTables, streams: jnp.ndarray,
                  active_bound: int = DEFAULT_ACTIVE_BOUND):
    """Batched NFA scan, streams (B, L) sharded over the data axis.

    Returns per-stream counts (B, S) sharded the same way, plus the
    psum-aggregated per-state totals (replicated) — the distributed analogue
    of the reference testbench's final histogram report
    (``testbench_BLK_Mem.sv:75-85``).
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, None)),
        out_specs=(P(DATA_AXIS, None), P()),
        check_vma=False,
    )
    def run(tables, streams_local):
        res = nfa_scan_batch(tables, streams_local, active_bound)
        # input is seq-replicated, so reduce over data only; the result is
        # already identical across the seq axis
        totals = jax.lax.psum(res.counts.sum(axis=0), axis_name=DATA_AXIS)
        return res.counts, totals

    return run(tables, streams)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "blocks_per_shard", "max_iters", "overlap"),
)
def dfa_scan_fast_dist(
    mesh,
    tables: DfaTables,
    classes: jnp.ndarray,
    blocks_per_shard: int = 8192,
    start: int = 0,
    max_iters: int = 16,
    overlap: int = 64,
):
    """Distributed fast DFA scan.

    ``classes``: (BATCH, L) byte-class ids; BATCH divisible by the mesh
    ``data`` axis, L divisible by (seq_size * blocks_per_shard).  Each device
    runs ``blocks_per_shard`` Jacobi chains over its local span; seam entries
    flow along ``seq`` via ppermute each iteration.

    Block AND chip seams are speculated first (ops/dfa_fast.py): every
    block's entry guess comes from replaying the previous block's last
    ``overlap`` bytes from the start state — the previous SHARD's tail
    arrives via one ``ppermute`` — and the Jacobi fixpoint loop then serves
    as the exactness verifier (1 iteration when the automaton synchronizes,
    plain iteration otherwise).

    ``start``: scalar or (BATCH,) per-stream entry states — the latter is
    how chunked streaming carries each stream's state across chunk
    boundaries (``dist_resilient_scan``).

    Returns (final_states (BATCH,), match_counts (BATCH,), converged ()).
    """
    n_seq = mesh.shape[SEQ_AXIS]
    batch, l = classes.shape
    assert l % (n_seq * blocks_per_shard) == 0
    starts = jnp.broadcast_to(jnp.asarray(start, jnp.int32), (batch,))

    # reshape to expose the seq shards: (BATCH, n_seq, L/n_seq)
    classes3 = classes.reshape(batch, n_seq, l // n_seq)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS, SEQ_AXIS, None), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P()),
        check_vma=False,
    )
    def run(tables, cls_local, starts_local):
        # cls_local: (b_loc, 1, l_loc); starts_local: (b_loc,)
        b_loc, _, l_loc = cls_local.shape
        nb = blocks_per_shard
        assert l_loc % nb == 0
        seq_idx = jax.lax.axis_index(SEQ_AXIS)
        n_seq_ = jax.lax.axis_size(SEQ_AXIS)
        # (b_loc, B, NB) columns for scan
        cls_seq = cls_local.reshape(b_loc, nb, l_loc // nb).swapaxes(1, 2)

        fwd = [(i, (i + 1) % n_seq_) for i in range(n_seq_)]

        def one_pass_finals(entries):
            return jax.vmap(lambda cs, e: chain_pass_finals(tables, cs, e))(
                cls_seq, entries
            )

        def body(carry):
            entries, _, it = carry
            finals = one_pass_finals(entries)  # (b_loc, NB)
            # seam: previous shard's last final -> my first entry
            seam_in = jax.lax.ppermute(finals[:, -1], SEQ_AXIS, fwd)
            first = jnp.where(seq_idx == 0, starts_local, seam_in)
            new_entries = jnp.concatenate([first[:, None], finals[:, :-1]], axis=1)
            local_done = jnp.all(new_entries == entries)
            ndone = jax.lax.psum(
                jax.lax.psum(1 - local_done.astype(jnp.int32), DATA_AXIS), SEQ_AXIS
            )
            return new_entries, ndone == 0, it + 1

        def cond(carry):
            _, done, it = carry
            return jnp.logical_and(~done, it < max_iters)

        entries0 = jnp.broadcast_to(starts_local[:, None], (b_loc, nb))
        b_len = l_loc // nb
        ov = min(overlap, b_len)
        if ov > 0:
            blocks_l = cls_local.reshape(b_loc, nb, b_len)
            tails = blocks_l[:, :, b_len - ov:]           # (b_loc, NB, ov)
            # previous shard's last-block tail seeds this shard's block 0
            seam_tail = jax.lax.ppermute(tails[:, -1], SEQ_AXIS, fwd)
            ov_blocks = jnp.concatenate(
                [seam_tail[:, None], tails[:, :-1]], axis=1
            )
            ov_seq = ov_blocks.swapaxes(1, 2)             # (b_loc, ov, NB)
            spec = jax.vmap(
                lambda cs, e: chain_pass_finals(tables, cs, e)
            )(ov_seq, entries0)
            first0 = jnp.where(seq_idx == 0, starts_local, spec[:, 0])
            entries0 = spec.at[:, 0].set(first0)
        entries, converged, _ = jax.lax.while_loop(
            cond, body, (entries0, jnp.array(False), jnp.array(0, jnp.int32))
        )

        finals, _, acc = jax.vmap(
            lambda cs, e: chain_pass_full(tables, cs, e)
        )(cls_seq, entries)
        # per-stream totals: sum local accept bits, add over seq axis
        local_counts = acc.sum(axis=(1, 2)).astype(jnp.int32)  # (b_loc,)
        counts = jax.lax.psum(local_counts, SEQ_AXIS)
        # final state of the stream = last block's final on the last shard,
        # broadcast to every seq member via all_gather
        alls = jax.lax.all_gather(finals[:, -1], SEQ_AXIS)  # (n_seq, b_loc)
        return alls[-1], counts, converged

    finals, counts, converged = run(tables, classes3, starts)
    return finals, counts, converged


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "blocks_per_shard", "max_iters", "overlap", "acc_bound"
    ),
)
def dfa_scan_kgram_dist(
    mesh,
    table: jnp.ndarray,       # (C_k, S) int32 composed k-gram transitions
    acc_table: jnp.ndarray,   # (C_k, S) int32 accept counts per step
    classes_k: jnp.ndarray,   # (BATCH, L/k) k-gram class ids
    blocks_per_shard: int = 8192,
    start: int = 0,
    max_iters: int = 16,
    overlap: int = 16,
    acc_bound: int | None = None,
):
    """Distributed k-gram scan — the headline counting engine on the
    (data, seq) mesh.

    K-gram transition tables compose associatively exactly like the k=1
    tables (``ops/kgram.py``), so the seam machinery of
    ``dfa_scan_fast_dist`` carries over unchanged: block entries inside a
    shard come from the previous lane, the entry of a shard's first block
    arrives from the previous device via ``lax.ppermute``, and
    convergence / per-stream totals reduce with ``psum``.  Accept counts
    ride the SAME GEMM as the transitions ((NB, C) @ (C, 2S)), so every
    Jacobi pass is a full pass and the converging pass's totals are the
    exact answer — no separate output pass, matching the single-device
    ``dfa_scan_kgram`` cost profile.

    ``classes_k``: (BATCH, Lk) k-gram class ids (``map_kgram_classes``);
    BATCH divisible by the ``data`` axis, Lk divisible by
    (seq_size * blocks_per_shard).  ``overlap`` counts k-gram STEPS (the
    speculation window spans overlap*k bytes).

    Returns (final_states (BATCH,), totals (BATCH,), converged ()).
    Parallelizes the serial char chain of ``Design/FPGA.v:733-737`` across
    both blocks and chips (SURVEY.md SS5.7c/SS5.8).
    """
    n_seq = mesh.shape[SEQ_AXIS]
    batch, lk = classes_k.shape
    assert lk % (n_seq * blocks_per_shard) == 0
    starts = jnp.broadcast_to(jnp.asarray(start, jnp.int32), (batch,))
    # callers may ship class ids narrow (int16 halves the upload);
    # the engine math is int32
    classes3 = classes_k.astype(jnp.int32).reshape(batch, n_seq, lk // n_seq)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS, SEQ_AXIS, None), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P()),
        check_vma=False,
    )
    def run(table, acc_table, cls_local, starts_local):
        # cls_local: (b_loc, 1, l_loc); starts_local: (b_loc,)
        b_loc, _, l_loc = cls_local.shape
        nb = blocks_per_shard
        assert l_loc % nb == 0
        b_len = l_loc // nb
        seq_idx = jax.lax.axis_index(SEQ_AXIS)
        n_seq_ = jax.lax.axis_size(SEQ_AXIS)
        blocks_l = cls_local.reshape(b_loc, nb, b_len)
        cls_seq = blocks_l.swapaxes(1, 2)  # (b_loc, B, NB)
        fwd = [(i, (i + 1) % n_seq_) for i in range(n_seq_)]

        def pass_full(entries):
            return jax.vmap(
                lambda cs, e: kgram_pass_full(
                    table, acc_table, cs, e, acc_bound
                )
            )(cls_seq, entries)

        # --- speculation prescan: replay the previous block's last ``ov``
        # k-gram steps; the previous SHARD's tail arrives via one ppermute
        entries0 = jnp.broadcast_to(starts_local[:, None], (b_loc, nb))
        ov = min(overlap, b_len)
        if ov > 0:
            step = make_kgram_step(table, acc_table, acc_bound)
            tails = blocks_l[:, :, b_len - ov:]           # (b_loc, NB, ov)
            seam_tail = jax.lax.ppermute(tails[:, -1], SEQ_AXIS, fwd)
            ov_blocks = jnp.concatenate(
                [seam_tail[:, None], tails[:, :-1]], axis=1
            )
            ov_seq = ov_blocks.swapaxes(1, 2)             # (b_loc, ov, NB)

            def ov_body(st, cl):
                nxt, _ = step(st, cl)
                return nxt, None

            spec = jax.vmap(
                lambda cs, e: jax.lax.scan(ov_body, e, cs)[0]
            )(ov_seq, entries0)
            first0 = jnp.where(seq_idx == 0, starts_local, spec[:, 0])
            entries0 = spec.at[:, 0].set(first0)

        # --- Jacobi fixpoint; every pass carries totals, so the converging
        # pass IS the output pass
        def body(carry):
            entries, _, _, _, it = carry
            finals, totals = pass_full(entries)
            seam_in = jax.lax.ppermute(finals[:, -1], SEQ_AXIS, fwd)
            first = jnp.where(seq_idx == 0, starts_local, seam_in)
            new_entries = jnp.concatenate(
                [first[:, None], finals[:, :-1]], axis=1
            )
            local_done = jnp.all(new_entries == entries)
            ndone = jax.lax.psum(
                jax.lax.psum(1 - local_done.astype(jnp.int32), DATA_AXIS),
                SEQ_AXIS,
            )
            return new_entries, finals, totals, ndone == 0, it + 1

        def cond(carry):
            return jnp.logical_and(~carry[3], carry[4] < max_iters)

        zero = jnp.zeros((b_loc, nb), jnp.int32)
        _, finals, totals, converged, _ = jax.lax.while_loop(
            cond,
            body,
            (entries0, zero, zero, jnp.array(False),
             jnp.array(0, jnp.int32)),
        )
        stream_totals = jax.lax.psum(
            totals.sum(axis=1).astype(jnp.int32), SEQ_AXIS
        )
        alls = jax.lax.all_gather(finals[:, -1], SEQ_AXIS)  # (n_seq, b_loc)
        return alls[-1], stream_totals, converged

    return run(table, acc_table, classes3, starts)
