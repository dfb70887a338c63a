"""Fast DFA scan — one-hot GEMM inner loop + Jacobi fixpoint block merge.

A table lookup is a one-hot matmul, so the inner loop needs no gather:

    rows = onehot(class_t) @ T          # (NB, C) @ (C, S) GEMM
    next = sum(rows * onehot(state), -1)  # select-reduce, exact in f32

with NB parallel block-chains, one lane per block.  This costs C*S MACs per
byte.  The shape was chosen for a matrix unit without fast gathers; the
gather form of the same chains lives in ``dfa_take.py``, and which of the
two is faster on the GPU is an open measurement (ROADMAP S2).

Block seams are resolved by Jacobi fixpoint iteration (speculation width 1):
run all chains from guessed entry states, propagate finals to the next
block's entry, repeat until the entry vector is unchanged.  At fixpoint the
result equals the serial scan exactly (induction from block 0).  Real
rulesets/corpora synchronize within a block so 2-3 iterations suffice;
non-synchronizing automata (e.g. parity counters) may not converge — the
engine reports it and callers fall back to the exact associative path in
``dfa_engine.py``.

The reference design has no analogue of any of this: its chain is serial per
char (``Design/FPGA.v:733-737``); this module is the SURVEY.md SS5.7
sequence-parallel design point.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .tables import DfaTables

__all__ = [
    "FastScanResult",
    "MultiScanResult",
    "dfa_scan_fast",
    "dfa_scan_fast_multi",
    "chain_pass_finals",
    "chain_pass_full",
    "mask_positions",
    "StepPlan",
    "mm_dtype",
    "mm_precision",
    "one_hot_dot",
    "split_states",
    "step_plan",
    "table_domain_ok",
    "table_encoding",
    "transposed_step",
]


@functools.partial(jax.jit, static_argnames=("cap",))
def mask_positions(mask: jnp.ndarray, cap: int):
    """DEVICE-side compaction of a (L,) bool accept mask into match
    positions: cumsum assigns each set bit its output slot, one scatter
    writes the byte offsets densely into a (cap,) array.  The caller
    downloads the count (4 bytes) plus a prefix of the positions array
    (N*4 bytes) instead of the full L-byte mask — an 8-1000x readback cut
    for sparse matches.

    Returns (positions (cap,) int32 — slots beyond ``count`` undefined —
    and count ()).  When count > cap the overflow positions are dropped:
    callers must then fall back to full-mask readback (density > cap/L
    makes the mask the cheaper download anyway)."""
    n = mask.shape[0]
    m32 = mask.astype(jnp.int32)
    idx = jnp.cumsum(m32) - 1          # output slot of each set bit
    count = idx[-1] + 1 if n else jnp.zeros((), jnp.int32)
    tgt = jnp.where(mask, idx, cap)    # unset bits scatter out of range
    pos = jnp.zeros((cap,), jnp.int32).at[tgt].set(
        jax.lax.broadcasted_iota(jnp.int32, (n,), 0), mode="drop"
    )
    return pos, count


class FastScanResult(NamedTuple):
    final_state: jnp.ndarray   # () int32
    match_mask: jnp.ndarray | None  # (L,) bool — accept fired before byte i
    states: jnp.ndarray | None      # (L,) int32 — state before byte i
    converged: jnp.ndarray     # () bool
    iterations: jnp.ndarray    # () int32
    counts: jnp.ndarray | None = None  # (S,) per-state counts (counts mode)
    #: SURVEY.md SS5.2 integer-domain guard: False means the device pass
    #: produced out-of-domain values (corrupt/mis-typed table, broken
    #: exactness contract) — results must be discarded, not trusted.
    domain_ok: jnp.ndarray | bool = True


#: bf16 carries 8 significant bits: every integer up to 256 is exact.
BF16_EXACT_MAX = 256
#: byte-split halves (ids below 2^16) each stay below 256
SPLIT_MAX_STATES = 1 << 16


def table_encoding(num_states: int) -> str:
    """How a one-hot lookup table with ids in ``[0, num_states)`` rides the
    GEMM exactly — THE single exactness rule (``mm_dtype``,
    ``split_states``, ``ops.kgram`` and the router's cost model all defer
    to it).  It reads only the value range, never the platform:

    * ``"bf16"`` up to 256 states: ids are bf16-exact, one-hot x id
      products are exact, and f32 accumulation of a single non-zero term
      is exact.
    * ``"split"`` for 256 < S <= 65,536: T = 256*Th + Tl with both halves
      < 256, concatenated column-wise into one 2S-wide bf16 GEMM; the
      select-reduce recombines lo + 256*hi in f32.  Products are one-hot x
      (<256) — exact on any matrix unit that accumulates in f32.
    * ``"f32"`` above: f32 operands with ``Precision.HIGHEST`` (exact below
      2^24).  The precision is mandatory — a default-precision f32 dot may
      run as TF32 or a single bf16 pass, exact only to 2,048 / 256."""
    if num_states <= BF16_EXACT_MAX:
        return "bf16"
    if num_states <= SPLIT_MAX_STATES:
        return "split"
    return "f32"


def mm_dtype(num_states: int):
    """Operand dtype of an UNSPLIT table holding ids below ``num_states``
    (see ``table_encoding``): bf16 when exact, else f32 + HIGHEST."""
    if table_encoding(num_states) == "bf16":
        return jnp.bfloat16
    return jnp.float32


def split_states(num_states: int) -> bool:
    """True when the byte-split bf16 encoding applies (``table_encoding``)."""
    return table_encoding(num_states) == "split"


def mm_precision(dtype):
    """Dot precision matching the exactness rule: f32 tables need HIGHEST
    (``table_encoding``); bf16 tables are exact at the default."""
    if dtype == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


def one_hot_dot(lhs, rhs):
    """``lhs @ rhs`` with f32 accumulation at the precision the exactness
    rule demands (``mm_precision``).  XLA's CPU backend cannot emit a bf16
    dot inside the small loops it compiles into one kernel, so there the
    bf16 operands are widened to f32 first — exact, because every value
    was already bf16-exact — and the dot runs at HIGHEST."""
    if lhs.dtype == jnp.bfloat16 and jax.default_backend() == "cpu":
        lhs, rhs = lhs.astype(jnp.float32), rhs.astype(jnp.float32)
    return jnp.dot(lhs, rhs, preferred_element_type=jnp.float32,
                   precision=mm_precision(lhs.dtype))


def transposed_step(c: int, s: int) -> bool:
    """True when the STATE-CONTRACTED orientation of the one-hot lookup
    pads to fewer/narrower 128x128 tiles than the class-contracted one.

    The lookup ``next[b] = T[cls_b, state_b]`` is a bilinear form in two
    one-hots and can ride the GEMM either way:

    * class-contracted: ``onehot(cls) (NB,C) @ T (C,W)`` with table width
      ``W = S`` (or ``2S`` byte-split) — the select-reduce then needs an
      ``(NB, W)`` rows intermediate.
    * state-contracted: ``onehot(state) (NB,S) @ T^T (S,Wc)`` with
      ``Wc = C`` (or ``2C`` split) — rows shrink to ``(NB, Wc)``.

    For realistic IDS automata C is tiny (byte classes, <= 64) while S is
    hundreds-plus, so contracting over S means fewer padded tiles (at
    S=836/C=36: 7 vs 14) and a 14x smaller rows intermediate.  Ties keep
    the original orientation unless the rows intermediate is strictly
    narrower.  The 128x128 tile model is a heuristic kept from the
    design's first target; ``chip_smoke.py`` prints both orientations'
    times on the GPU (ROADMAP S1)."""
    cur_tiles, tr_tiles, w_cur, w_tr = step_orientation_costs(c, s)
    if tr_tiles != cur_tiles:
        return tr_tiles < cur_tiles
    return w_tr < w_cur


class StepPlan(NamedTuple):
    """How one lookup step is laid out: the table encoding
    (``table_encoding``) and the GEMM orientation (``transposed_step``)."""

    encoding: str
    transposed: bool


def step_plan(c: int, s: int) -> StepPlan:
    """The engine's own choice for a (C, S) table; callers may pass another
    ``StepPlan`` to ``dfa_scan_fast`` to time the alternatives."""
    return StepPlan(table_encoding(s), transposed_step(c, s))


def step_orientation_costs(c: int, s: int) -> tuple[int, int, int, int]:
    """(class-contracted tiles, state-contracted tiles, and the two rows
    widths) of one lookup step — THE single source of the padded-tile
    arithmetic, shared by ``transposed_step`` (engine orientation choice)
    and ``ops.router.device_count_bps`` (host-vs-device cost model) so
    the model can never drift from what the engine emits (same discipline
    as ``ops.kgram.KGRAM_MAX_STATES``)."""
    wide = 1 if table_encoding(s) == "bf16" else 2
    w_cur = wide * s
    w_tr = wide * c
    cur_tiles = -(-c // 128) * -(-w_cur // 128)
    tr_tiles = -(-s // 128) * -(-w_tr // 128)
    return cur_tiles, tr_tiles, w_cur, w_tr


class _StepT(NamedTuple):
    t: jnp.ndarray        # lookup table in GEMM orientation/encoding
    iota_c: jnp.ndarray   # (1, C) int32
    iota_s: jnp.ndarray   # (1, S) int32
    transposed: bool      # contract over states (see transposed_step)
    split: bool           # byte-split halves: t width = 2 * out_dim


def _step_tables(tables: DfaTables, plan: StepPlan | None = None) -> _StepT:
    c, s = tables.table.shape
    assert s < (1 << 24), "state ids must stay exactly representable in f32"
    plan = plan or step_plan(c, s)
    tr = plan.transposed
    base = tables.table.T if tr else tables.table  # values: state ids
    split = plan.encoding == "split"
    if split:
        # byte-split bf16 encoding (table_encoding): [Tl | Th] columns
        t = jnp.concatenate([base % 256, base // 256], axis=1).astype(
            jnp.bfloat16
        )
    else:
        t = base.astype(
            jnp.bfloat16 if plan.encoding == "bf16" else jnp.float32
        )
    iota_c = jax.lax.broadcasted_iota(jnp.int32, (1, c), 1)
    iota_s = jax.lax.broadcasted_iota(jnp.int32, (1, s), 1)
    return _StepT(t, iota_c, iota_s, tr, split)


def table_domain_ok(tables: DfaTables) -> jnp.ndarray:
    """SURVEY.md SS5.2 guard, evaluated on device: every transition target
    must be a valid state id AND survive the ``mm_dtype`` cast losslessly
    (bf16 corrupts integers > 256 silently — the exactness rule in
    ``table_encoding``).  Returns a () bool."""
    c, s = tables.table.shape
    t = tables.table
    in_range = jnp.all((t >= 0) & (t < s))
    lossless = jnp.all(
        t.astype(mm_dtype(s)).astype(jnp.int32) == t.astype(jnp.int32)
    )
    return jnp.logical_and(in_range, lossless)


def _finals_domain_ok(finals: jnp.ndarray, s: int) -> jnp.ndarray:
    return jnp.all((finals >= 0) & (finals < s))


def _mm_step(st: _StepT, state, cls_t):
    """One byte for NB chains: state (NB,), cls_t (NB,) -> next state (NB,).

    The GEMM contracts over classes (original) or states (``transposed``,
    see ``transposed_step``); the other one-hot selects from the
    ``(NB, out_dim)`` rows.  Byte-split tables carry [lo | hi] halves and
    recombine ``lo + 256*hi``."""
    if st.transposed:
        a_idx, a_iota = state, st.iota_s
        sel_idx, sel_iota = cls_t, st.iota_c
    else:
        a_idx, a_iota = cls_t, st.iota_c
        sel_idx, sel_iota = state, st.iota_s
    oh_a = (a_idx[:, None] == a_iota).astype(st.t.dtype)
    out_dim = sel_iota.shape[1]
    rows = one_hot_dot(oh_a, st.t)
    oh_sel = (sel_idx[:, None] == sel_iota).astype(jnp.float32)
    if st.split:  # byte-split: recombine lo + 256*hi
        lo = jnp.sum(rows[:, :out_dim] * oh_sel, axis=-1)
        hi = jnp.sum(rows[:, out_dim:] * oh_sel, axis=-1)
        return (lo + 256.0 * hi).astype(jnp.int32)
    return jnp.sum(rows * oh_sel, axis=-1).astype(jnp.int32)


def chain_pass_finals(tables: DfaTables, cls_seq: jnp.ndarray, entries: jnp.ndarray,
                      plan: StepPlan | None = None):
    """Run NB chains over (B, NB) class columns; return final states (NB,).

    Cheap pass used inside the fixpoint loop — no per-position outputs.
    """
    st = _step_tables(tables, plan)

    def body(state, cls_t):
        return _mm_step(st, state, cls_t), None

    finals, _ = jax.lax.scan(body, entries, cls_seq)
    return finals


def chain_pass_full(tables: DfaTables, cls_seq: jnp.ndarray, entries: jnp.ndarray,
                    plan: StepPlan | None = None):
    """Output pass: also emit per-position state + accept bit (B, NB)."""
    st = _step_tables(tables, plan)
    accept_f = tables.accept.astype(jnp.float32)

    def body(state, cls_t):
        oh_x = (state[:, None] == st.iota_s).astype(jnp.float32)
        acc = jnp.sum(oh_x * accept_f[None, :], axis=-1) > 0.0
        nxt = _mm_step(st, state, cls_t)
        return nxt, (state, acc)

    finals, (states, acc) = jax.lax.scan(body, entries, cls_seq)
    return finals, states, acc


def chain_pass_mask(tables: DfaTables, cls_seq: jnp.ndarray, entries: jnp.ndarray,
                    plan: StepPlan | None = None):
    """Mask-only output pass: per-position accept bit (B, NB), no states
    array — finditer's backward scan and ``_scan_mask`` need only the bits,
    and skipping the (B, NB) int32 states store saves 4 B/byte of HBM
    write traffic."""
    st = _step_tables(tables, plan)
    accept_f = tables.accept.astype(jnp.float32)

    def body(state, cls_t):
        oh_x = (state[:, None] == st.iota_s).astype(jnp.float32)
        acc = jnp.sum(oh_x * accept_f[None, :], axis=-1) > 0.0
        nxt = _mm_step(st, state, cls_t)
        return nxt, acc

    finals, acc = jax.lax.scan(body, entries, cls_seq)
    return finals, acc


def chain_pass_counts(tables: DfaTables, cls_seq: jnp.ndarray, entries: jnp.ndarray,
                      plan: StepPlan | None = None):
    """Counting pass: per-state visit counts accumulated IN the scan carry.

    The per-step one-hot ``oh_x`` is reduced over lanes in f32 (exact: the
    per-step sum is at most NB < 2^24) and added into an int32 accumulator
    (exact to 2^31, far above any chunk length) — no per-position arrays
    reach HBM and no scatter/bincount is needed.  Accept masking happens
    once at the end: counts[s] = visits[s] * accept[s].
    """
    st = _step_tables(tables, plan)
    s_dim = tables.num_states

    def body(carry, cls_t):
        state, visits = carry
        oh_x = (state[:, None] == st.iota_s).astype(jnp.float32)
        visits = visits + jnp.sum(oh_x, axis=0).astype(jnp.int32)
        nxt = _mm_step(st, state, cls_t)
        return (nxt, visits), None

    (finals, visits), _ = jax.lax.scan(
        body, (entries, jnp.zeros((s_dim,), jnp.int32)), cls_seq
    )
    counts = visits * tables.accept.astype(jnp.int32)
    return finals, counts


def _shift_entries(finals: jnp.ndarray, start) -> jnp.ndarray:
    return jnp.concatenate(
        [jnp.asarray(start, jnp.int32)[None], finals[:-1]]
    )


@functools.partial(
    jax.jit,
    static_argnames=("num_blocks", "max_iters", "emit", "overlap", "plan"),
)
def dfa_scan_fast(
    tables: DfaTables,
    classes: jnp.ndarray,
    num_blocks: int = 65536,
    start: int = 0,
    max_iters: int = 16,
    emit: str = "full",
    overlap: int = 64,
    plan: StepPlan | None = None,
) -> FastScanResult:
    """Scan a class stream (byte-class ids, length divisible by num_blocks).

    ``classes`` layout: the stream is split into ``num_blocks`` contiguous
    blocks scanned in parallel, one chain lane per block.  Byte-class mapping
    of raw bytes happens host-side during ingest (``utils.ingest``) — the
    device loop then pays C*S MACs/byte instead of 256*S.

    Block seams: each lane first replays the last ``overlap`` bytes of the
    previous block from the start state (speculation); real automata
    synchronize within that window, making the entry guesses exact, which a
    single induction check (``finals[l-1] == entries[l]``, lane 0 anchored)
    verifies.  On success the output pass ran from true entries and its
    results stand — ~1 pass total.  On failure the engine falls back to the
    Jacobi fixpoint iteration (exact whenever ``converged``).

    ``plan`` overrides the step layout (``step_plan``); every plan is
    exact, so it only changes speed.
    """
    l = classes.shape[0]
    assert l % num_blocks == 0, "stream length must be divisible by num_blocks"
    b = l // num_blocks
    blocks = classes.astype(jnp.int32).reshape(num_blocks, b)
    cls_seq = blocks.T  # (B, NB) scan columns
    start = jnp.asarray(start, jnp.int32)

    pass_finals = lambda e: chain_pass_finals(tables, cls_seq, e, plan)
    pass_full = lambda e: chain_pass_full(tables, cls_seq, e, plan)

    # --- speculative entries: replay the previous block's tail
    ov = min(overlap, b)
    entries0 = jnp.full((num_blocks,), start, dtype=jnp.int32)
    if ov > 0:
        ov_seq = jnp.concatenate(
            [blocks[:1, b - ov:], blocks[:-1, b - ov:]], axis=0
        ).T  # (ov, NB); lane 0's rows are junk — its entry is forced below
        spec = chain_pass_finals(tables, ov_seq, entries0, plan)
        entries0 = spec.at[0].set(start)

    def _jacobi_entries(seed_entries):
        def cond(carry):
            _, done, it = carry
            return jnp.logical_and(~done, it < max_iters)

        def body(carry):
            entries, _, it = carry
            finals = pass_finals(entries)
            new_entries = _shift_entries(finals, start)
            done = jnp.all(new_entries == entries)
            return new_entries, done, it + 1

        return jax.lax.while_loop(
            cond, body, (seed_entries, jnp.array(False), jnp.array(1, jnp.int32))
        )

    def _run_pass(pass_fn):
        """Speculation-first execution of an output pass whose first result
        is the per-lane finals: if the speculated entries verify, the pass
        already ran from true entries; otherwise iterate the Jacobi
        fixpoint and re-run the pass once from the converged entries."""
        out0 = pass_fn(entries0)
        spec_ok = jnp.all(_shift_entries(out0[0], start) == entries0)

        def _spec(_):
            return (*out0, jnp.array(True), jnp.array(1, jnp.int32))

        def _jac(_):
            entries, converged, iters = _jacobi_entries(
                _shift_entries(out0[0], start)
            )
            return (*pass_fn(entries), converged, iters)

        return jax.lax.cond(spec_ok, _spec, _jac, None)

    s_dim = tables.num_states
    if emit == "counts":
        # per-state accept-visit counts accumulated ON DEVICE inside the
        # scan carry (no per-position arrays, no scatter/bincount)
        finals, counts, converged, iters = _run_pass(
            lambda e: chain_pass_counts(tables, cls_seq, e, plan)
        )
        return FastScanResult(
            final_state=finals[-1],
            match_mask=None,
            states=None,
            converged=converged,
            iterations=iters,
            counts=counts,
            domain_ok=jnp.logical_and(
                table_domain_ok(tables), _finals_domain_ok(finals, s_dim)
            ),
        )

    if emit == "mask":
        # accept bits only: finditer's backward pass and _scan_mask never
        # read the states array, so skip its (B, NB) int32 HBM store
        finals, acc, converged, iters = _run_pass(
            lambda e: chain_pass_mask(tables, cls_seq, e, plan)
        )
        return FastScanResult(
            final_state=finals[-1],
            match_mask=acc.T.reshape(-1),
            states=None,
            converged=converged,
            iterations=iters,
            domain_ok=jnp.logical_and(
                table_domain_ok(tables), _finals_domain_ok(finals, s_dim)
            ),
        )

    finals, states, acc, converged, iters = _run_pass(pass_full)
    # (B, NB) -> stream order (NB, B) -> (L,)
    return FastScanResult(
        final_state=finals[-1],
        match_mask=acc.T.reshape(-1),
        states=states.T.reshape(-1),
        converged=converged,
        iterations=iters,
        domain_ok=jnp.logical_and(
            table_domain_ok(tables),
            jnp.logical_and(
                _finals_domain_ok(finals, s_dim),
                _finals_domain_ok(states, s_dim),
            ),
        ),
    )


class MultiScanResult(NamedTuple):
    final_states: jnp.ndarray  # (N,) int32 — state after each stream
    counts: jnp.ndarray | None      # (N, S) int32 per-stream accept counts
    match_mask: jnp.ndarray | None  # (N, L) bool (full mode)
    states: jnp.ndarray | None      # (N, L) int32 (full mode)
    converged: jnp.ndarray     # () bool
    iterations: jnp.ndarray    # () int32
    domain_ok: jnp.ndarray | bool = True  # SURVEY.md SS5.2 guard (see above)


def _chain_pass_counts_multi(tables: DfaTables, cls_seq, entries, n: int,
                             plan: StepPlan | None = None):
    """Counting pass with PER-STREAM accumulators: lanes are grouped
    (stream-major) and segment-summed into an (N, S) carry.  Exact: the
    per-step per-stream lane sum is at most NB < 2^24 in f32, accumulated
    in int32."""
    st = _step_tables(tables, plan)
    s_dim = tables.num_states
    nb = cls_seq.shape[1] // n

    def body(carry, cls_t):
        state, visits = carry
        oh_x = (state[:, None] == st.iota_s).astype(jnp.float32)
        per = jnp.sum(oh_x.reshape(n, nb, s_dim), axis=1).astype(jnp.int32)
        nxt = _mm_step(st, state, cls_t)
        return (nxt, visits + per), None

    (finals, visits), _ = jax.lax.scan(
        body, (entries, jnp.zeros((n, s_dim), jnp.int32)), cls_seq
    )
    return finals, visits * tables.accept.astype(jnp.int32)[None, :]


@functools.partial(
    jax.jit,
    static_argnames=("num_blocks", "max_iters", "emit", "overlap"),
)
def dfa_scan_fast_multi(
    tables: DfaTables,
    classes: jnp.ndarray,
    num_blocks: int = 256,
    starts: jnp.ndarray | int = 0,
    max_iters: int = 16,
    emit: str = "counts",
    overlap: int = 64,
) -> MultiScanResult:
    """Batch scan of N equal-length independent streams in ONE chain pass.

    The reference runs two streams through one state-scan by duplicating
    its bitmaps (``FPGA.v:54-57``, added in v1.5 ``FPGA.v:17``); here the
    batch axis is just MORE CHAIN LANES: ``classes`` is (N, L), each stream
    splits into ``num_blocks`` blocks, and the N*num_blocks lanes run in the
    same GEMM chain.  Stream boundaries are lane positions whose entry state
    is pinned to that stream's start (``starts`` scalar or (N,)) instead of
    the previous lane's final — both in the speculative seeding and in every
    Jacobi shift — so streams stay fully independent (SURVEY.md §3.3 item
    5).  Larger N widens the GEMMs; this is the serving-path layout for
    many concurrent flows.

    emit="counts": per-stream per-state histograms accumulated on device.
    emit="full":   per-stream (N, L) states and match masks.
    """
    n, l = classes.shape
    assert l % num_blocks == 0, "stream length must be divisible by num_blocks"
    b = l // num_blocks
    nb_tot = n * num_blocks
    blocks = classes.astype(jnp.int32).reshape(nb_tot, b)
    cls_seq = blocks.T  # (B, NB_tot), lanes stream-major
    starts_v = jnp.broadcast_to(
        jnp.asarray(starts, jnp.int32).reshape(-1), (n,)
    ) if jnp.ndim(starts) <= 1 else starts
    lane_start = jnp.repeat(starts_v, num_blocks)  # (NB_tot,)
    first = (jnp.arange(nb_tot) % num_blocks) == 0

    def shift(finals):
        prev = jnp.concatenate([lane_start[:1], finals[:-1]])
        return jnp.where(first, lane_start, prev)

    entries0 = lane_start
    ov = min(overlap, b)
    if ov > 0:
        ov_seq = jnp.concatenate(
            [blocks[:1, b - ov:], blocks[:-1, b - ov:]], axis=0
        ).T
        spec = chain_pass_finals(tables, ov_seq, entries0)
        entries0 = jnp.where(first, lane_start, spec)

    pass_finals = lambda e: chain_pass_finals(tables, cls_seq, e)

    def _jacobi_entries(seed_entries):
        def cond(carry):
            _, done, it = carry
            return jnp.logical_and(~done, it < max_iters)

        def body(carry):
            entries, _, it = carry
            new_entries = shift(pass_finals(entries))
            done = jnp.all(new_entries == entries)
            return new_entries, done, it + 1

        return jax.lax.while_loop(
            cond, body, (seed_entries, jnp.array(False), jnp.array(1, jnp.int32))
        )

    if emit == "counts":
        pass_counts = lambda e: _chain_pass_counts_multi(tables, cls_seq, e, n)
        finals0, counts0 = pass_counts(entries0)
        spec_ok = jnp.all(shift(finals0) == entries0)

        def _spec(_):
            return finals0, counts0, jnp.array(True), jnp.array(1, jnp.int32)

        def _jac(_):
            entries, converged, iters = _jacobi_entries(shift(finals0))
            finals, counts = pass_counts(entries)
            return finals, counts, converged, iters

        finals, counts, converged, iters = jax.lax.cond(
            spec_ok, _spec, _jac, None
        )
        return MultiScanResult(
            final_states=finals.reshape(n, num_blocks)[:, -1],
            counts=counts,
            match_mask=None,
            states=None,
            converged=converged,
            iterations=iters,
            domain_ok=jnp.logical_and(
                table_domain_ok(tables),
                _finals_domain_ok(finals, tables.num_states),
            ),
        )

    pass_full = lambda e: chain_pass_full(tables, cls_seq, e)
    finals0, states0, acc0 = pass_full(entries0)
    spec_ok = jnp.all(shift(finals0) == entries0)

    def _spec_f(_):
        return finals0, states0, acc0, jnp.array(True), jnp.array(1, jnp.int32)

    def _jac_f(_):
        entries, converged, iters = _jacobi_entries(shift(finals0))
        finals, states, acc = pass_full(entries)
        return finals, states, acc, converged, iters

    finals, states, acc, converged, iters = jax.lax.cond(
        spec_ok, _spec_f, _jac_f, None
    )
    # (B, NB_tot) -> (NB_tot, B) -> (N, L)
    return MultiScanResult(
        final_states=finals.reshape(n, num_blocks)[:, -1],
        counts=None,
        match_mask=acc.T.reshape(n, l),
        states=states.T.reshape(n, l),
        converged=converged,
        iterations=iters,
        domain_ok=jnp.logical_and(
            table_domain_ok(tables),
            jnp.logical_and(
                _finals_domain_ok(finals, tables.num_states),
                _finals_domain_ok(states, tables.num_states),
            ),
        ),
    )
