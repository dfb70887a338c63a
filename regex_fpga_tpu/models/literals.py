"""Aho–Corasick multi-literal compiler: a set of literal byte strings →
one dense DFA, scanned by the fast device engine with per-pattern attribution.

IDS rulesets (the reference's domain — its two ``.coe`` images derive from
Snort and l7-filter rules, SURVEY.md §2.1 #13-14) are dominated by literal
content strings; Aho–Corasick is the classic multi-pattern automaton for
them.  The reference has no compiler at all (§0), so this is new surface:
we build the goto/failure trie on the host, resolve failure links into a
dense (256, S) delta table (the AC automaton IS a DFA once failures are
resolved), and hand it to ``ops.build_dfa_tables`` — the same gather-free
one-hot-matmul engines that scan compiled regexes then scan thousand-
pattern literal sets at identical throughput.

Match semantics: every occurrence of every pattern is reported (overlaps
and nested suffixes included, like Snort content matching — NOT the
leftmost-longest span semantics of the regex path).  A state's output set
is the set of patterns ending there (its suffix chain), so per-pattern
counts are an exact (S × P) membership-matrix product over per-state
counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .regex import CompiledDfa

__all__ = ["AhoCorasick", "build_aho_corasick"]


@dataclasses.dataclass(frozen=True)
class AhoCorasick:
    """Failure-resolved Aho–Corasick automaton over S trie states.

    ``dfa`` plugs into ``api.DfaMatcher`` / ``ops.build_dfa_tables``
    unchanged; ``outputs``/``member`` carry the multi-pattern structure the
    plain DFA lacks."""

    dfa: CompiledDfa
    patterns: list[bytes]
    #: outputs[s] = tuple of pattern indices ending at state s (suffix chain)
    outputs: tuple[tuple[int, ...], ...]
    #: CSR of ``outputs`` (indptr (S+1,), indices (nnz,)): community-scale
    #: rulesets reach S~10^5, P~10^4 — the former dense (S, P) membership
    #: matrix would be ~1 GB and make per-payload attribution an O(S*P)
    #: matmul; the sparse fold is O(active states) per payload
    out_indptr: np.ndarray
    out_indices: np.ndarray

    @property
    def num_states(self) -> int:
        return self.dfa.num_states

    @property
    def member(self) -> np.ndarray:
        """(S, P) uint8 membership matrix, built on demand (small sets
        only — property-test/diagnostic surface, not the scan path)."""
        m = np.zeros((self.num_states, len(self.patterns)), dtype=np.uint8)
        for s, o in enumerate(self.outputs):
            m[s, list(o)] = 1
        return m

    def pattern_counts(self, state_counts: np.ndarray) -> np.ndarray:
        """Fold per-state match histogram(s) into per-pattern counts.
        Accepts (S,) or (n, S); sparse accumulation over NONZERO states
        (a payload visits few accept states, so this is O(hits))."""
        sc = np.asarray(state_counts, dtype=np.int64)
        if sc.ndim == 1:
            return self.pattern_counts(sc[None])[0]
        out = np.zeros((sc.shape[0], len(self.patterns)), dtype=np.int64)
        for r in range(sc.shape[0]):
            for s in np.nonzero(sc[r])[0]:
                a, b = self.out_indptr[s], self.out_indptr[s + 1]
                out[r, self.out_indices[a:b]] += sc[r, s]
        return out


def build_aho_corasick(patterns) -> AhoCorasick:
    """Compile literal byte strings into a failure-resolved AC automaton.

    Empty patterns are rejected (they would match at every position and the
    trie root would be accepting — use the regex path for nullable
    patterns).  Duplicate patterns share trie states but keep distinct
    pattern ids in the output sets.
    """
    pats = [p.encode("utf-8") if isinstance(p, str) else bytes(p)
            for p in patterns]
    if not pats:
        raise ValueError("empty pattern list")
    if any(len(p) == 0 for p in pats):
        raise ValueError("empty literal pattern")

    # --- trie (goto function) ---------------------------------------------
    # children[s] maps byte -> state; state 0 is the root
    children: list[dict[int, int]] = [{}]
    out: list[list[int]] = [[]]
    for pid, p in enumerate(pats):
        s = 0
        for b in p:
            t = children[s].get(b)
            if t is None:
                t = len(children)
                children.append({})
                out.append([])
                children[s][b] = t
            s = t
        out[s].append(pid)

    n = len(children)
    # --- failure links (BFS) + dense delta --------------------------------
    fail = np.zeros(n, dtype=np.int64)
    table = np.zeros((256, n), dtype=np.int32)  # delta[b, s]
    queue: list[int] = []
    for b, t in children[0].items():
        table[b, 0] = t
        queue.append(t)
    # root's missing bytes self-loop to root (already 0)
    qi = 0
    while qi < len(queue):
        s = queue[qi]
        qi += 1
        f = int(fail[s])
        # inherit the suffix chain's outputs so every occurrence reports
        out[s].extend(out[f])
        for b, t in children[s].items():
            fail[t] = table[b, f]
            queue.append(t)
        # dense resolution: missing edges follow the failure state's row
        row_f = table[:, f].copy()
        for b in children[s]:
            row_f[b] = children[s][b]
        table[:, s] = row_f

    accept = np.array([bool(o) for o in out], dtype=bool)
    indptr = np.zeros(n + 1, dtype=np.int64)
    for s, o in enumerate(out):
        indptr[s + 1] = indptr[s] + len(o)
    indices = np.fromiter(
        (pid for o in out for pid in o), dtype=np.int64, count=int(indptr[-1])
    )
    dfa = CompiledDfa(
        table=table, accept=accept, start=0, dead=-1, accept_eof=None
    )
    return AhoCorasick(
        dfa=dfa,
        patterns=pats,
        outputs=tuple(tuple(o) for o in out),
        out_indptr=indptr,
        out_indices=indices,
    )
