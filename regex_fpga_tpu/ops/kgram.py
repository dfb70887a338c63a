"""k-gram precomposition: scan k bytes per engine step (throughput mode).

The fast engine's cost is per STEP (one (NB,C)@(C,S) GEMM + select-reduce),
not per byte.  Transition functions compose associatively, so k consecutive
byte-classes fuse into one "k-gram class" whose table column is the composed
function; the engine then consumes k bytes per step.  Classes are
recompressed at each doubling (distinct composed function+count columns,
bounded by the automaton's transition monoid).

Per-position match bits are not observable at k-gram granularity, so this
mode carries an ACCEPT-COUNT table alongside:

    A_1[c, s]        = accept(s)                      (count before the byte)
    A_2k[(c1,c2), s] = A_k[c1, s] + A_k[c2, T_k[c1, s]]

giving exact TOTAL match counts (reference timing: accept before each byte,
final-byte accept dropped) at k bytes per step — the mode for counting
scans (IDS totals, grep -c, benchmarking).  Use k=1 when per-position masks
or per-state histograms are needed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .tables import DfaTables

__all__ = [
    "KgramTables",
    "build_kgram",
    "map_kgram_classes",
    "make_kgram_step",
    "kgram_pass_full",
    "dfa_scan_kgram",
    "kgram_step_cost",
    "choose_kgram_level",
    "choose_scan_level",
    "KGRAM_MAX_STATES",
]

#: k-gram vs k=1 engine gate: the k-gram counting engine is used only up
#: to this many states (the packed single-select boundary); above it the
#: k=1 counts engine runs.  The value comes from the design's first target
#: and has not been re-measured on the GPU (ROADMAP S1/S5;
#: ``chip_smoke.py`` prints both engines' rates).  Shared by
#: ``api.DfaMatcher._kgram`` and ``choose_scan_level`` so the model and
#: the gate cannot disagree.
KGRAM_MAX_STATES = 32



def kgram_step_cost(s: int, c_l: int, lv: int) -> float:
    """Padded-tile cost per BYTE of one engine step at level ``lv``.

    Models what ``make_kgram_step`` actually emits, with every GEMM padded
    to 128x128 tiles (a heuristic kept from the design's first target):
    cost/step = ceil(C_l/128) * ceil(W/128) + selects, where the table
    width W and select count depend on the route —
    byte-split (S > 256) rides a 3S-wide GEMM, the packed single-select
    route (``(S-1)*mult + k <= 256``) an S-wide one, and the unpacked
    route a 2S-wide GEMM with two selects.  Level 0 is the k=1 counts
    engine (2S-wide when split, else S-wide, one select).  Divided by
    k = 2^lv bytes per step.

    The model picks the right LEVEL within the k-gram engine; the
    engine-vs-engine choice (k-gram vs k=1) additionally shifts with
    unmodeled per-step costs (int16 class-stream gathers, prescan), so
    ``api.DfaMatcher._kgram`` uses the crossover constant
    ``KGRAM_MAX_STATES`` rather than comparing cost(0) to cost(best).
    """
    from .dfa_fast import split_states

    k = 1 << lv
    split = split_states(s)
    if lv == 0:
        width, selects = (2 * s if split else s), 1
    elif split:
        width, selects = 3 * s, 3
    else:
        mult = 1
        while mult <= k:
            mult *= 2
        if (s - 1) * mult + k <= 256:
            width, selects = s, 1
        else:
            width, selects = 2 * s, 2
    tiles = -(-c_l // 128) * -(-width // 128) + selects
    return tiles / k


def choose_kgram_level(s: int, level_classes: list[int]) -> int:
    """Cheapest level >= 1 under ``kgram_step_cost`` — ONLY for callers
    that already committed to the k-gram engine (e.g. the bench sweep
    measuring the k-gram curve for the record).  For the real engine
    choice use ``choose_scan_level``, which includes the k=1
    crossover gate."""
    costs = [kgram_step_cost(s, c_l, lv)
             for lv, c_l in enumerate(level_classes)]
    return int(np.argmin(costs[1:])) + 1


def choose_scan_level(s: int, level_classes: list[int] | None = None) -> int:
    """Engine choice for a COUNTING scan: 0 = the k=1 counts engine,
    ``lv >= 1`` = the k-gram engine at that level.

    Folds the gate on top of the padded-tile model: above
    ``KGRAM_MAX_STATES`` the answer is 0 regardless of ``level_classes``
    (the model's blind spots — int16 class-stream gather, host prescan —
    all scale against k-gram).  At or below the gate the cheapest level
    under ``kgram_step_cost`` wins, INCLUDING level 0 when the model says
    the k=1 engine is already cheapest (degenerate class structures)."""
    if s > KGRAM_MAX_STATES or not level_classes:
        return 0
    costs = [kgram_step_cost(s, c_l, lv)
             for lv, c_l in enumerate(level_classes)]
    return int(np.argmin(costs))


@dataclasses.dataclass(frozen=True)
class KgramTables:
    """Composed tables for k = 2^levels bytes per step."""

    table: np.ndarray            # (C_k, S) int32 composed transitions
    acc_table: np.ndarray        # (C_k, S) int32 accept counts per step
    class_of: np.ndarray         # (256,) base byte -> level-0 class
    pair_maps: list[np.ndarray]  # level i: (C_i*C_i,) -> C_{i+1}
    level_classes: list[int]     # C_i per level (len = levels + 1)
    num_states: int
    k: int


def _intern_rows(both: np.ndarray, max_classes: int):
    """Dedupe rows of a 2-D int32 array by first-occurrence interning.
    Returns (uniq_rows, remap) or None when distinct rows exceed
    ``max_classes``.  np.unique(axis=0) would lex-sort the full rows; the
    dict avoids that sort and first-occurrence order keeps class ids
    stable."""
    both = np.ascontiguousarray(both, dtype=np.int32)
    seen: dict[bytes, int] = {}
    remap = np.empty(both.shape[0], dtype=np.int32)
    keep: list[int] = []
    for i, row in enumerate(both):
        key = row.tobytes()
        j = seen.get(key)
        if j is None:
            j = len(seen)
            if j >= max_classes:  # blowup: bail before hashing the rest
                return None
            seen[key] = j
            keep.append(i)
        remap[i] = j
    return both[keep], remap


def build_kgram(
    tables: DfaTables, levels: int = 2, max_classes: int = 2048
) -> KgramTables | None:
    """Build 2^levels-gram tables, or None if the class count explodes."""
    t = np.asarray(tables.table).astype(np.int32)       # (C, S)
    a = np.broadcast_to(
        np.asarray(tables.accept).astype(np.int32), t.shape
    ).copy()                                            # A_1[c, s] = accept[s]
    pair_maps: list[np.ndarray] = []
    level_classes = [t.shape[0]]
    for _ in range(levels):
        c, s = t.shape
        # transient-allocation gate: ~4 * C^2 * S int32 materialize per
        # level before interning can reject
        if c * c > (1 << 22) or c * c * s > (1 << 26):
            return None
        t2 = t[:, t]                       # [c2, c1, s] = t[c2, t[c1, s]]
        t2 = t2.transpose(1, 0, 2)         # [c1, c2, s]
        a2 = a[:, None, :] + a[:, t].transpose(1, 0, 2)
        # a2[c1, c2, s] = a[c1, s] + a[c2, t[c1, s]]
        t2 = t2.reshape(c * c, s)
        a2 = a2.reshape(c * c, s)
        interned = _intern_rows(np.concatenate([t2, a2], axis=1), max_classes)
        if interned is None:
            return None
        uniq, remap = interned
        pair_maps.append(remap)
        t, a = (np.ascontiguousarray(uniq[:, :s]),
                np.ascontiguousarray(uniq[:, s:]))
        level_classes.append(t.shape[0])
    return KgramTables(
        table=t,
        acc_table=a,
        class_of=np.asarray(tables.class_of),
        pair_maps=pair_maps,
        level_classes=level_classes,
        num_states=tables.num_states,
        k=1 << levels,
    )


def map_kgram_classes(kg: KgramTables, data: np.ndarray) -> np.ndarray:
    """Map raw bytes to k-gram class ids (length L / k; L % k == 0).

    Uses the native streaming passes when available (numpy fancy indexing
    is far slower; the C passes run at memory speed)."""
    data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    assert len(data) % kg.k == 0
    lib = None
    if kg.pair_maps:
        try:
            from ..utils.native import _load

            lib = _load()
        except Exception:
            lib = None
    if lib is None:
        cls = kg.class_of[data]
        for lvl, remap in enumerate(kg.pair_maps):
            c = kg.level_classes[lvl]
            a, b = cls[0::2].astype(np.int64), cls[1::2].astype(np.int64)
            cls = remap[a * c + b]
        return cls.astype(np.int32)

    import ctypes

    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lut8 = np.ascontiguousarray(kg.class_of, dtype=np.uint8)
    remaps = [
        np.ascontiguousarray(r, dtype=np.int32) for r in kg.pair_maps
    ]

    def run(chunk: np.ndarray, out: np.ndarray) -> None:
        n = len(chunk) // 2
        lib.kgram_level1(
            chunk.ctypes.data_as(u8p), n, lut8.ctypes.data_as(u8p),
            remaps[0].ctypes.data_as(i32p), kg.level_classes[0],
            out.ctypes.data_as(i32p),
        )
        cur = out
        for lvl in range(1, len(remaps)):
            n //= 2
            lib.kgram_pair(
                cur.ctypes.data_as(i32p), n,
                remaps[lvl].ctypes.data_as(i32p), kg.level_classes[lvl],
                cur.ctypes.data_as(i32p),  # in-place: out[i] from in[2i],2i+1
            )
            cur = cur[:n]

    # groups of k bytes are independent — split at a k-aligned boundary and
    # map the halves concurrently (the GIL is released inside ctypes calls)
    if len(data) >= (1 << 22):
        import threading

        half = ((len(data) // 2) // kg.k) * kg.k
        out1 = np.empty(half // 2, np.int32)
        out2 = np.empty((len(data) - half) // 2, np.int32)
        t = threading.Thread(target=run, args=(data[:half], out1))
        t.start()
        run(data[half:], out2)
        t.join()
        return np.concatenate(
            [out1[: half // kg.k], out2[: (len(data) - half) // kg.k]]
        )
    out = np.empty(len(data) // 2, np.int32)
    run(data, out)
    return out[: len(data) // kg.k]


class KgramScanResult(NamedTuple):
    final_state: jnp.ndarray  # () int32
    total: jnp.ndarray        # () int32 total matches
    converged: jnp.ndarray
    iterations: jnp.ndarray   # () int32 full passes executed


def make_kgram_step(
    table: jnp.ndarray, acc_table: jnp.ndarray, acc_bound: int | None = None
):
    """Build ``step(state, cls_t) -> (next_state, acc)`` for NB parallel
    lanes — the k-gram analogue of ``dfa_fast._mm_step`` with the accept
    count riding the same GEMM.  Shared by the single-device scan below and
    the (data, seq)-mesh distributed scan (``parallel/dist_scan.py``).

    When the caller promises acc values <= acc_bound (k, known statically),
    transition and accept pack into ONE value T*mult + A — one select
    instead of two.  Packing follows the same exactness rule as every
    table (``dfa_fast.table_encoding``): packed values must stay
    bf16-exact (<= 256).  Above that the unpacked tables are used, whose
    entries (state ids and per-step accept counts) stay individually
    small: bf16, byte-split bf16, or f32 with HIGHEST precision.
    """
    from .dfa_fast import BF16_EXACT_MAX, mm_dtype, one_hot_dot, split_states

    c, s = table.shape
    iota_c = jax.lax.broadcasted_iota(jnp.int32, (1, c), 1)
    iota_s = jax.lax.broadcasted_iota(jnp.int32, (1, s), 1)

    if split_states(s):
        # byte-split bf16 (dfa_fast.table_encoding): [Tl | Th | A]
        # columns in ONE 3S-wide GEMM instead of the multi-pass f32
        # HIGHEST route.  Per-step accept counts are <= k <= 256
        # (build_kgram levels stay tiny), so A is bf16-exact unsplit.
        ta3 = jnp.concatenate(
            [table % 256, table // 256, acc_table], axis=1
        ).astype(jnp.bfloat16)

        def step(state, cls_t):
            oh_c = (cls_t[:, None] == iota_c).astype(jnp.bfloat16)
            rows = one_hot_dot(oh_c, ta3)
            oh_x = (state[:, None] == iota_s).astype(jnp.float32)
            lo = jnp.sum(rows[:, :s] * oh_x, axis=-1)
            hi = jnp.sum(rows[:, s:2 * s] * oh_x, axis=-1)
            acc = jnp.sum(rows[:, 2 * s:] * oh_x, axis=-1)
            return (lo + 256.0 * hi).astype(jnp.int32), acc.astype(jnp.int32)

        return step

    mult = 0
    if acc_bound is not None:
        mult = 1
        while mult <= acc_bound:
            mult *= 2
        if (s - 1) * mult + acc_bound > BF16_EXACT_MAX:
            mult = 0  # beyond bf16's exact range: use the unpacked tables
    if mult:
        packed_max = (s - 1) * mult + acc_bound
        pk_i = table * mult + acc_table  # (C, S)
        mmdt = mm_dtype(packed_max)
        pk = pk_i.astype(mmdt)

        def step(state, cls_t):
            oh_c = (cls_t[:, None] == iota_c).astype(mmdt)
            rows = one_hot_dot(oh_c, pk)
            oh_x = (state[:, None] == iota_s).astype(jnp.float32)
            v = jnp.sum(rows * oh_x, axis=-1).astype(jnp.int32)
            return v // mult, v % mult
    else:
        # exactness rule shared with the other engines; accept counts per
        # step are bounded by k (build_kgram caps levels well below 256)
        ta_i = jnp.concatenate([table, acc_table], axis=1)
        mmdt = mm_dtype(s)
        ta = ta_i.astype(mmdt)

        def step(state, cls_t):
            oh_c = (cls_t[:, None] == iota_c).astype(mmdt)
            rows = one_hot_dot(oh_c, ta)
            oh_x = (state[:, None] == iota_s).astype(jnp.float32)
            nxt = jnp.sum(rows[:, :s] * oh_x, axis=-1).astype(jnp.int32)
            acc = jnp.sum(rows[:, s:] * oh_x, axis=-1).astype(jnp.int32)
            return nxt, acc

    return step


def kgram_pass_full(
    table: jnp.ndarray,
    acc_table: jnp.ndarray,
    cls_seq: jnp.ndarray,   # (B, NB) scan columns
    entries: jnp.ndarray,   # (NB,) entry states
    acc_bound: int | None = None,
):
    """One full chain pass over NB lanes: final states + per-lane accept
    totals, both (NB,).  The accept row rides the same (NB, C) @ (C, 2S)
    GEMM as the transitions."""
    step = make_kgram_step(table, acc_table, acc_bound)

    def body(carry, cl):
        st, tot = carry
        nxt, acc = step(st, cl)
        return (nxt, tot + acc), None

    (finals, totals), _ = jax.lax.scan(
        body, (entries, jnp.zeros_like(entries)), cls_seq
    )
    return finals, totals


def _speculative_entries(blocks: jnp.ndarray, step, start, overlap: int):
    """Entry guesses for all block lanes: each lane replays the PREVIOUS
    block's last ``overlap`` steps from the start state (lane 0 pinned to
    the true start) — shared by the k-gram counting and pair-mask scans."""
    num_blocks, b = blocks.shape
    ov = min(overlap, b)
    entries0 = jnp.full((num_blocks,), start, dtype=jnp.int32)
    if ov <= 0:
        return entries0
    ov_seq = jnp.concatenate(
        [blocks[:1, b - ov:], blocks[:-1, b - ov:]], axis=0
    ).T  # (ov, NB); lane 0's rows are junk — its entry is forced below

    def ov_body(st, cl):
        return step(st, cl)[0], None

    spec, _ = jax.lax.scan(ov_body, entries0, ov_seq)
    return spec.at[0].set(start)


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_blocks", "max_iters", "overlap", "acc_bound"
    ),
)
def dfa_scan_kgram(
    table: jnp.ndarray,       # (C_k, S) int32
    acc_table: jnp.ndarray,   # (C_k, S) int32
    classes_k: jnp.ndarray,   # (L/k,) int32 k-gram class ids
    num_blocks: int = 65536,
    start: int = 0,
    max_iters: int = 16,
    overlap: int = 16,
    acc_bound: int | None = None,
) -> KgramScanResult:
    """Speculative chain scan over k-gram steps; returns final state + exact
    total match count.

    Inner loop: ONE fused (NB, C)@(C, 2S) one-hot GEMM per step yields both
    the transition row and the accept-count row, followed by a
    select-reduce.

    Block seams — overlap speculation, exact by verification: each lane
    first scans the last ``overlap`` steps of the PREVIOUS block from the
    start state; real automata synchronize within that window, so the
    resulting entry guesses are correct and verified by a single induction
    check (lane 0's entry is exact; ``finals[l-1] == entries[l]`` for all l
    then proves every lane scanned from its true entry).  The verification
    is the convergence test of a Jacobi fixpoint loop whose first iterate is
    the speculated entry vector: synchronizing inputs finish in ONE full
    pass (+ the overlap prescan, ``overlap/B`` extra work), adversarial
    ones (e.g. parity counters) fall back to plain Jacobi iteration and
    remain exact whenever ``converged`` is True.  The reference engine has
    no analogue — its chain is serial per char (``Design/FPGA.v:733-737``).
    """
    l = classes_k.shape[0]
    assert l % num_blocks == 0
    b = l // num_blocks
    blocks = classes_k.astype(jnp.int32).reshape(num_blocks, b)
    cls_seq = blocks.T  # (B, NB) scan columns
    start = jnp.asarray(start, jnp.int32)
    step = make_kgram_step(table, acc_table, acc_bound)

    # --- speculation prescan: lane l replays the tail of block l-1
    entries0 = _speculative_entries(blocks, step, start, overlap)

    # --- full passes until the entry vector is a fixpoint; the totals of
    # the converging pass were computed from the true entries, so they are
    # the exact answer.
    def full_body(carry, cl):
        st, tot = carry
        nxt, acc = step(st, cl)
        return (nxt, tot + acc), None

    def pass_full(entries):
        (finals, totals), _ = jax.lax.scan(
            full_body, (entries, jnp.zeros_like(entries)), cls_seq
        )
        return finals, totals

    def cond(carry):
        return jnp.logical_and(~carry[3], carry[4] < max_iters)

    def body(carry):
        entries, _, _, _, it = carry
        finals, totals = pass_full(entries)
        new_entries = jnp.concatenate([start[None], finals[:-1]])
        done = jnp.all(new_entries == entries)
        return new_entries, finals, totals, done, it + 1

    zero = jnp.zeros((num_blocks,), jnp.int32)
    _, finals, totals, converged, iters = jax.lax.while_loop(
        cond,
        body,
        (entries0, zero, zero, jnp.array(False), jnp.array(0, jnp.int32)),
    )
    return KgramScanResult(
        final_state=finals[-1],
        total=totals.sum(),
        converged=converged,
        iterations=iters,
    )
