"""ctypes bindings for the native (C++) golden scanners.

Mirrors the Python oracles' semantics for corpus-scale conformance
diffing.  The library is built from ``native/golden_scan.cpp`` on first
use (plain C ABI + ctypes, no pybind11) into ``native/build/``, under a
name keyed by the hash of the sources, so a fresh checkout or an edited
source always gets a library built on this machine from these sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

__all__ = [
    "native_available",
    "nfa_scan_native",
    "dfa_scan_native",
    "dfa_scan_multi_native",
    "dfa_scan_speculative_native",
    "anchored_spans_native",
    "nfa_match_positions_native",
]

_LIB = None
_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native")
)
_SOURCES = ("golden_scan.cpp", "build.sh")


def library_path() -> str:
    """Path of the library built from the current sources: the file name
    carries a hash of ``golden_scan.cpp`` and ``build.sh``, so any edit to
    either selects (and builds) a new library."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(
        _NATIVE_DIR, "build", f"libgolden_scan-{h.hexdigest()[:16]}.so"
    )


def _build(so: str) -> None:
    """Compile into a private temporary name and rename it into place, so
    concurrent first users (test workers) never load a half-written
    library."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["sh", os.path.join(_NATIVE_DIR, "build.sh"), tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not os.path.exists(so):
        _build(so)
    lib = ctypes.CDLL(so)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.nfa_scan.restype = ctypes.c_int
    lib.nfa_scan.argtypes = [
        i32p, i32p, u8p, ctypes.c_int64, ctypes.c_int64,
        u8p, ctypes.c_int64, i64p, i32p, ctypes.c_int64,
    ]
    lib.dfa_scan.restype = ctypes.c_int32
    lib.dfa_scan.argtypes = [
        i32p, i32p, u8p, ctypes.c_int64,
        u8p, ctypes.c_int64, ctypes.c_int32, i64p, u8p,
    ]
    lib.dfa_scan_multi.restype = None
    lib.dfa_scan_multi.argtypes = [
        i32p, i32p, u8p, ctypes.c_int64,
        u8p, i64p, ctypes.c_int64, i32p, i64p, i32p,
    ]
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.dfa_scan_multi16.restype = None
    lib.dfa_scan_multi16.argtypes = [
        i16p, i32p, u8p, ctypes.c_int64,
        u8p, i64p, ctypes.c_int64, i32p, i64p, i32p,
    ]
    lib.lazy_walk.restype = ctypes.c_int64
    lib.lazy_walk.argtypes = [
        i32p, ctypes.c_int64, u8p, u8p, u8p, u8p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), i64p,
    ]
    lib.kgram_level1.restype = None
    lib.kgram_level1.argtypes = [
        u8p, ctypes.c_int64, u8p, i32p, ctypes.c_int64, i32p,
    ]
    lib.kgram_pair.restype = None
    lib.kgram_pair.argtypes = [
        i32p, ctypes.c_int64, i32p, ctypes.c_int64, i32p,
    ]
    lib.lazy_walk_multi.restype = ctypes.c_int64
    lib.lazy_walk_multi.argtypes = [
        i32p, ctypes.c_int64, u8p, u8p, u8p, u8p,
        i64p, i64p, i32p, ctypes.c_int64, i64p, ctypes.c_int32,
        ctypes.c_int64,
    ]
    lib.anchored_spans.restype = ctypes.c_int64
    lib.anchored_spans.argtypes = [
        i32p, u8p, u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        u8p, ctypes.c_int64, i64p, ctypes.c_int64, i64p, ctypes.c_int64,
    ]
    lib.nfa_match_positions.restype = ctypes.c_int64
    lib.nfa_match_positions.argtypes = [
        i32p, i32p, u8p, ctypes.c_int64, ctypes.c_int64,
        u8p, ctypes.c_int64, i32p, ctypes.c_int64, i64p, ctypes.c_int64,
    ]
    _LIB = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def nfa_scan_native(
    delta: np.ndarray,      # (C, S+1, K) int32
    class_of: np.ndarray,   # (256,) int32
    accept: np.ndarray,     # (S+1,) bool/uint8
    stream: np.ndarray,     # (len,) uint8
    active: np.ndarray | None = None,
    counts: np.ndarray | None = None,
    active_cap: int = 1024,
):
    """Returns (counts (S+1,) int64, final_active (cap,) int32).

    Raises on active-set overflow (mirrors the device engine's flag)."""
    lib = _load()
    c, s1, k = delta.shape
    s = s1 - 1
    delta = np.ascontiguousarray(delta, dtype=np.int32)
    class_of = np.ascontiguousarray(class_of, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    if counts is None:
        counts = np.zeros(s + 1, dtype=np.int64)
    if active is None:
        active = np.full(active_cap, s, dtype=np.int32)
        active[0] = 0
    active = np.ascontiguousarray(active, dtype=np.int32)
    rc = lib.nfa_scan(
        _ptr(delta, ctypes.c_int32), _ptr(class_of, ctypes.c_int32),
        _ptr(accept8, ctypes.c_uint8), s, k,
        _ptr(stream, ctypes.c_uint8), len(stream),
        _ptr(counts, ctypes.c_int64), _ptr(active, ctypes.c_int32), len(active),
    )
    if rc:
        raise RuntimeError("native nfa_scan: active-set capacity exceeded")
    return counts, active


def dfa_scan_native(
    table: np.ndarray,      # (C, S) int32
    class_of: np.ndarray,   # (256,) int32
    accept: np.ndarray,     # (S,) bool/uint8
    stream: np.ndarray,     # (len,) uint8
    start: int = 0,
    want_mask: bool = True,
):
    """Returns (counts (S,) int64, match_mask (len,) bool | None, final)."""
    lib = _load()
    c, s = table.shape
    _check_table_domain(np.asarray(table), s)
    table = np.ascontiguousarray(table, dtype=np.int32)
    class_of = np.ascontiguousarray(class_of, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    counts = np.zeros(s, dtype=np.int64)
    mask = np.zeros(len(stream), dtype=np.uint8) if want_mask else None
    final = lib.dfa_scan(
        _ptr(table, ctypes.c_int32), _ptr(class_of, ctypes.c_int32),
        _ptr(accept8, ctypes.c_uint8), s,
        _ptr(stream, ctypes.c_uint8), len(stream), start,
        _ptr(counts, ctypes.c_int64),
        _ptr(mask, ctypes.c_uint8) if want_mask else None,
    )
    return counts, (mask.astype(bool) if want_mask else None), int(final)


def _check_table_domain(table: np.ndarray, s: int) -> None:
    """SURVEY.md §5.2 guard, host side: the C walkers index
    ``table[class*S + state]`` unchecked, so an out-of-domain transition
    target (corrupt build, truncated file) must raise HERE — parity with
    the device path's ``domain_ok`` flag — instead of walking off the
    counts/accept arrays."""
    if not ((table >= 0) & (table < s)).all():
        raise RuntimeError(
            "native DFA walk: transition table contains out-of-domain "
            "state ids (SURVEY.md §5.2 guard) — corrupt table"
        )


#: small FIFO memo for int16 table downcasts keyed by the SOURCE array's
#: identity (a strong ref to the source rides along, so the id cannot be
#: recycled while the entry lives).  Re-converting per call measured a
#: C*S copy (snort_16: 2.7 MB read + 1.4 MB write) on every chunk/probe
#: rep — momentarily evicting the very cache the int16 layout protects.
_TAB16_MEMO: dict = {}


def _as_table16(table: np.ndarray) -> np.ndarray:
    key = id(table)
    hit = _TAB16_MEMO.get(key)
    if hit is not None and hit[0] is table:
        return hit[1]
    conv = np.ascontiguousarray(table, dtype=np.int16)
    if len(_TAB16_MEMO) >= 8:
        _TAB16_MEMO.pop(next(iter(_TAB16_MEMO)))
    _TAB16_MEMO[key] = (table, conv)
    return conv


def dfa_scan_multi_native(
    table: np.ndarray,      # (C, S) int32
    class_of: np.ndarray,   # (256,) int32
    accept: np.ndarray,     # (S,) bool/uint8
    streams: list,          # list of uint8 arrays / bytes
    starts: np.ndarray | int = 0,
):
    """Interleaved multi-cursor dense-DFA walk (host half of the engine
    router, ``ops/router.py``): per-stream per-state counts + final states
    in ONE native call.  Single-cursor ``dfa_scan_native`` is dependency-
    chain bound; 16-way interleaving hides the table-load latency.
    Returns (counts (n, S) int64, finals (n,) int32)."""
    lib = _load()
    c, s = table.shape
    _check_table_domain(np.asarray(table), s)
    # int16 tables when every state id fits (all shipped rulesets): half
    # the cache footprint once (C, S) spills L2 — snort_16 (S=9,514,
    # C=74) shrinks from 2.7 MB to 1.4 MB
    use16 = s < (1 << 15)
    table = (_as_table16(table) if use16
             else np.ascontiguousarray(table, dtype=np.int32))
    entry = lib.dfa_scan_multi16 if use16 else lib.dfa_scan_multi
    tptr_t = ctypes.c_int16 if use16 else ctypes.c_int32
    class_of = np.ascontiguousarray(class_of, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    bufs = [np.ascontiguousarray(
        np.frombuffer(st, dtype=np.uint8) if isinstance(st, (bytes, bytearray))
        else st, dtype=np.uint8) for st in streams]
    n = len(bufs)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    concat = (np.concatenate(bufs) if n else np.zeros(0, np.uint8))
    concat = np.ascontiguousarray(concat, dtype=np.uint8)
    if np.isscalar(starts) or getattr(starts, "ndim", 1) == 0:
        starts = np.full(n, int(starts), dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    counts = np.zeros((n, s), dtype=np.int64)
    finals = np.zeros(n, dtype=np.int32)

    def _run(lo: int, hi: int) -> None:
        # ctypes releases the GIL for the call's duration, so stream-range
        # slices run truly concurrently (different output rows: no races)
        off = offsets[lo : hi + 1].copy()
        base = int(off[0])
        off -= base
        sub = np.ascontiguousarray(concat[base : base + int(off[-1])])
        st_slice = np.ascontiguousarray(starts[lo:hi])
        c_slice = np.zeros((hi - lo, s), dtype=np.int64)
        f_slice = np.zeros(hi - lo, dtype=np.int32)
        entry(
            _ptr(table, tptr_t), _ptr(class_of, ctypes.c_int32),
            _ptr(accept8, ctypes.c_uint8), s,
            _ptr(sub, ctypes.c_uint8), _ptr(off, ctypes.c_int64), hi - lo,
            _ptr(st_slice, ctypes.c_int32),
            _ptr(c_slice, ctypes.c_int64), _ptr(f_slice, ctypes.c_int32),
        )
        counts[lo:hi] = c_slice
        finals[lo:hi] = f_slice

    nthreads = min(os.cpu_count() or 1, n)
    if n == 0:
        pass
    elif nthreads <= 1 or int(offsets[-1]) < (1 << 21):
        _run(0, n)  # threading overhead beats the win on small inputs
    else:
        # balance by BYTES, not stream count (uneven stream lengths)
        from concurrent.futures import ThreadPoolExecutor

        target = int(offsets[-1]) / nthreads
        cuts = [0]
        for t_i in range(1, nthreads):
            cut = int(np.searchsorted(offsets, t_i * target))
            cuts.append(max(cuts[-1], min(cut, n)))
        cuts.append(n)
        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            list(ex.map(lambda ab: _run(*ab),
                        [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]))
    return counts, finals


def dfa_scan_speculative_native(
    table: np.ndarray,      # (C, S) int32
    class_of: np.ndarray,   # (256,) int32
    accept: np.ndarray,     # (S,) bool/uint8
    stream: np.ndarray,
    start: int = 0,
    segments: int = 32,
    overlap: int = 64,
):
    """SINGLE-stream host counting scan at multi-cursor rate — the device
    engine's speculation trick (``ops/dfa_fast.py``) mirrored on the host:
    split the stream into segments, guess each segment's entry state by
    replaying the previous segment's last ``overlap`` bytes from the start
    state, walk ALL segments as independent interleaved cursors
    (``dfa_scan_multi``), then verify the seam induction
    ``finals[i-1] == entries[i]``.  Mis-speculated segments re-walk with
    corrected entries — one round when the automaton synchronizes within
    ``overlap`` bytes (the measured common case for IDS automata), with a
    serial fallback if the fixpoint doesn't close.  Exact by the same
    induction argument as the device engine.

    Returns (counts (S,) int64, final int)."""
    stream = np.ascontiguousarray(
        np.frombuffer(stream, dtype=np.uint8)
        if isinstance(stream, (bytes, bytearray)) else stream,
        dtype=np.uint8,
    )
    n = len(stream)
    seg = n // max(segments, 1)
    if segments <= 1 or seg < 4 * max(overlap, 16):
        c, _, f = dfa_scan_native(table, class_of, accept, stream,
                                  start=start, want_mask=False)
        return c, f
    bounds = [i * seg for i in range(segments)] + [n]
    parts = [stream[bounds[i]:bounds[i + 1]] for i in range(segments)]
    # entry guesses: replay each previous segment's tail from `start`
    tails = [stream[max(b - overlap, 0):b] for b in bounds[1:-1]]
    _, tail_finals = dfa_scan_multi_native(
        table, class_of, accept, tails, starts=start
    )
    entries = np.empty(segments, np.int32)
    entries[0] = start
    entries[1:] = tail_finals
    counts, finals = dfa_scan_multi_native(
        table, class_of, accept, parts, starts=entries
    )
    for _ in range(segments):
        bad = np.nonzero(finals[:-1] != entries[1:])[0]
        if len(bad) == 0:
            return counts.sum(axis=0), int(finals[-1])
        redo = bad + 1
        entries[redo] = finals[redo - 1]
        c2, f2 = dfa_scan_multi_native(
            table, class_of, accept, [parts[i] for i in redo],
            starts=entries[redo],
        )
        counts[redo] = c2
        finals[redo] = f2
    # fixpoint did not close (non-synchronizing automaton): exact serial
    c, _, f = dfa_scan_native(table, class_of, accept, stream,
                              start=start, want_mask=False)
    return c, f


def anchored_spans_native(
    table: np.ndarray,       # (256, S) int32, raw-byte indexed anchored DFA
    accept: np.ndarray,      # (S,) bool/uint8
    accept_eof: np.ndarray,  # (S,) bool/uint8
    start_state: int,
    dead: int,
    stream: np.ndarray,      # (len,) uint8
    starts: np.ndarray,      # sorted candidate start offsets
) -> np.ndarray:
    """Longest anchored match per start with non-overlap suppression;
    returns an (n, 2) int64 span array (the finditer forward stage)."""
    lib = _load()
    _, s = table.shape
    table = np.ascontiguousarray(table, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    eof8 = np.ascontiguousarray(accept_eof, dtype=np.uint8)
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    cap = max(16, len(starts))
    while True:
        out = np.empty((cap, 2), dtype=np.int64)
        n = lib.anchored_spans(
            _ptr(table, ctypes.c_int32), _ptr(accept8, ctypes.c_uint8),
            _ptr(eof8, ctypes.c_uint8), int(start_state), int(dead), s,
            _ptr(stream, ctypes.c_uint8), len(stream),
            _ptr(starts, ctypes.c_int64), len(starts),
            _ptr(out, ctypes.c_int64), cap,
        )
        if n >= 0:
            return out[:n]
        cap *= 2  # unreachable in practice (spans <= starts), kept for safety


def nfa_match_positions_native(
    delta: np.ndarray,      # (C, S+1, K) int32
    class_of: np.ndarray,   # (256,) int32
    accept: np.ndarray,     # (S+1,) bool/uint8
    stream: np.ndarray,     # (len,) uint8
    active: np.ndarray | None = None,
    active_cap: int = 1024,
) -> np.ndarray:
    """Byte offsets where an accepting state is active (oracle timing:
    one char late, final-position accept dropped).  Returns int64 offsets."""
    lib = _load()
    c, s1, k = delta.shape
    s = s1 - 1
    delta = np.ascontiguousarray(delta, dtype=np.int32)
    class_of = np.ascontiguousarray(class_of, dtype=np.int32)
    accept8 = np.ascontiguousarray(accept, dtype=np.uint8)
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    if active is None:
        active = np.full(active_cap, s, dtype=np.int32)
        active[0] = 0
    active = np.ascontiguousarray(active, dtype=np.int32)
    cap = max(1024, len(stream) // 4)
    while True:
        out = np.empty(cap, dtype=np.int64)
        n = lib.nfa_match_positions(
            _ptr(delta, ctypes.c_int32), _ptr(class_of, ctypes.c_int32),
            _ptr(accept8, ctypes.c_uint8), s, k,
            _ptr(stream, ctypes.c_uint8), len(stream),
            _ptr(active, ctypes.c_int32), len(active),
            _ptr(out, ctypes.c_int64), cap,
        )
        if n == -2:
            raise RuntimeError("native nfa_match_positions: active-set "
                               "capacity exceeded")
        if n >= 0:
            return out[:n]
        cap = min(cap * 4, len(stream) + 1)
