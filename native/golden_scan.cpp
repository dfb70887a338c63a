// Fast CPU golden scanners for conformance diffing.
//
// The Python oracle (regex_fpga_tpu/models/oracle.py) is the semantic root
// but runs at ~100 KB/s — far too slow to diff a device engine against
// multi-GB corpora.  This native scanner implements the same match
// semantics (reference Design/FPGA.v: accept = out-degree 0, counted one
// char late, per-state counters; SURVEY.md SS3.3) at ~10^8 bytes/s:
//
//  - NFA: bounded active-set walk over a dense per-(class,state) successor
//    table (same layout as ops/tables.py NfaTables, K-slot fan-out).
//  - DFA: single-chain table walk (same layout as DfaTables).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: see native/build.sh (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// NFA scan.
//   delta:    (C, S+1, K) int32, sentinel = S
//   class_of: (256,) int32
//   accept:   (S+1,) uint8 (0/1)
//   stream:   (len,) uint8
//   counts:   (S+1,) int64 out (accumulated; caller zeroes)
//   active_io: (active_cap,) int32 in/out — initial active list
//     (sentinel-padded); overwritten with the final active list.
// Returns 0 on success, 1 on active-set overflow (bound exceeded).
int nfa_scan(const int32_t* delta, const int32_t* class_of,
             const uint8_t* accept, int64_t S, int64_t K,
             const uint8_t* stream, int64_t len,
             int64_t* counts, int32_t* active_io, int64_t active_cap) {
  std::vector<int32_t> cur(active_io, active_io + active_cap);
  std::vector<int32_t> nxt;
  nxt.reserve(active_cap * K);
  // membership bitmap for dedupe
  std::vector<uint8_t> in_next(S + 1, 0);
  int64_t ncur = 0;
  while (ncur < active_cap && cur[ncur] != S) ncur++;
  cur.resize(ncur);

  for (int64_t pos = 0; pos < len; ++pos) {
    const int64_t cls = class_of[stream[pos]];
    const int32_t* drow = delta + cls * (S + 1) * K;
    nxt.clear();
    for (int32_t s : cur) {
      if (accept[s]) counts[s]++;
      const int32_t* cell = drow + (int64_t)s * K;
      for (int64_t k = 0; k < K; ++k) {
        const int32_t t = cell[k];
        if (t != S && !in_next[t]) {
          in_next[t] = 1;
          nxt.push_back(t);
        }
      }
    }
    for (int32_t t : nxt) in_next[t] = 0;
    if ((int64_t)nxt.size() > active_cap) return 1;
    cur.swap(nxt);
  }
  // write back final active list (sorted for determinism)
  std::vector<int32_t> fin(cur);
  std::sort(fin.begin(), fin.end());
  for (int64_t i = 0; i < active_cap; ++i)
    active_io[i] = i < (int64_t)fin.size() ? fin[i] : (int32_t)S;
  return 0;
}

// DFA scan.
//   table:    (C, S) int32
//   class_of: (256,) int32
//   accept:   (S,) uint8
//   counts:   (S,) int64 out
//   match_mask: (len,) uint8 out or nullptr
// Returns the final state.
int32_t dfa_scan(const int32_t* table, const int32_t* class_of,
                 const uint8_t* accept, int64_t S,
                 const uint8_t* stream, int64_t len, int32_t start,
                 int64_t* counts, uint8_t* match_mask) {
  int32_t s = start;
  for (int64_t pos = 0; pos < len; ++pos) {
    const uint8_t a = accept[s];
    if (a) counts[s]++;  // accepts are rare: branch beats the RMW (r5)
    if (match_mask) match_mask[pos] = a;
    s = table[(int64_t)class_of[stream[pos]] * S + s];
  }
  return s;
}

// Multi-stream dense-DFA walk with INTERLEAVED cursors — the host half of
// the api-level host-vs-device engine router (ops/router.py).  The
// single-cursor dfa_scan above is bound by its load->index dependency
// chain (~0.15 GB/s); walking W streams round-robin puts W independent
// chains in flight so the core's load-level parallelism hides the table
// latency, the same trick (and measured 2-3.5x) as walk_multi_impl below
// for the lazy engine.  Tables stay class-major like dfa_scan; (C,S)
// int32 for realistic S (S=836, C=36 -> 120 KB) sits in L2.
//   table: (C, S) int32; class_of: (256,) int32; accept: (S,) uint8
//   stream:  all payloads concatenated; offsets: (n_streams+1,) int64
//   starts:  (n_streams,) int32 per-stream start state
//   counts:  (n_streams, S) int64 out (one-char-late accept timing,
//            final-state accept NOT counted — identical to dfa_scan)
//   finals:  (n_streams,) int32 out
}  // extern "C" (template below needs C++ linkage; reopened after)

// r5 walker optimizations, measured single-core at reference shapes
// (probe in the commit message; aggregate 2-core rates scale the same):
// * accept-gated BRANCH instead of the unconditional counts
//   read-modify-write — accepts are rare, so the ~never-taken branch
//   removes a random-index RMW per byte (S=2794: 0.211 -> 0.405 GB/s);
// * int16 transition tables when S < 32768 (every shipped ruleset) —
//   halves the table's cache footprint, decisive once (C, S) spills L2
//   (S=9514 snort_16: 0.281 -> 0.452 GB/s with the branch; S=836 is
//   L2-resident either way and gains only from the branch).
// The int32 entry point stays for S >= 32768; utils/native.py picks.
template <typename TableT>
static void dfa_scan_multi_impl(
    const TableT* __restrict table,
    const int32_t* __restrict class_of,
    const uint8_t* __restrict accept, int64_t S,
    const uint8_t* __restrict stream,
    const int64_t* __restrict offsets, int64_t n_streams,
    const int32_t* __restrict starts,
    int64_t* __restrict counts, int32_t* __restrict finals) {
  constexpr int64_t W = 16;
  for (int64_t g = 0; g < n_streams; g += W) {
    const int64_t w = (n_streams - g) < W ? (n_streams - g) : W;
    int64_t p[W], e[W];
    int32_t s[W], idx[W];
    int64_t na = 0;
    for (int64_t c = 0; c < w; ++c) {
      p[c] = offsets[g + c];
      e[c] = offsets[g + c + 1];
      s[c] = starts[g + c];
      if (p[c] < e[c]) idx[na++] = (int32_t)c;
    }
    // lockstep rounds: gather the live cursors, advance ALL of them for
    // the minimum remaining length in a tight inner loop (a per-byte
    // ring-membership test measured away most of the interleaving win),
    // re-gather, repeat.  Each round retires at least one cursor, so
    // rounds <= w.
    while (true) {
      na = 0;
      for (int64_t c = 0; c < w; ++c)
        if (p[c] < e[c]) idx[na++] = (int32_t)c;
      if (na == 0) break;
      if (na == 1) {  // last straggler: plain single-cursor walk
        const int32_t c = idx[0];
        int32_t st = s[c];
        int64_t* row = counts + (int64_t)(g + c) * S;
        for (int64_t i = p[c]; i < e[c]; ++i) {
          if (accept[st]) row[st]++;
          st = (int32_t)table[(int64_t)class_of[stream[i]] * S + st];
        }
        s[c] = st;
        p[c] = e[c];
        break;
      }
      int64_t common = INT64_MAX;
      for (int64_t j = 0; j < na; ++j)
        if (e[idx[j]] - p[idx[j]] < common) common = e[idx[j]] - p[idx[j]];
      for (int64_t i = 0; i < common; ++i) {
        for (int64_t j = 0; j < na; ++j) {
          const int32_t c = idx[j];
          const int32_t st = s[c];
          if (accept[st]) counts[(int64_t)(g + c) * S + st]++;
          s[c] = (int32_t)table[(int64_t)class_of[stream[p[c]++]] * S + st];
        }
      }
    }
    for (int64_t c = 0; c < w; ++c) finals[g + c] = s[c];
  }
}

extern "C" {
void dfa_scan_multi(const int32_t* table, const int32_t* class_of,
                    const uint8_t* accept, int64_t S,
                    const uint8_t* stream, const int64_t* offsets,
                    int64_t n_streams, const int32_t* starts,
                    int64_t* counts, int32_t* finals) {
  dfa_scan_multi_impl<int32_t>(table, class_of, accept, S, stream,
                               offsets, n_streams, starts, counts, finals);
}

// int16 table variant (S < 32768): same semantics, half the footprint
void dfa_scan_multi16(const int16_t* table, const int32_t* class_of,
                      const uint8_t* accept, int64_t S,
                      const uint8_t* stream, const int64_t* offsets,
                      int64_t n_streams, const int32_t* starts,
                      int64_t* counts, int32_t* finals) {
  dfa_scan_multi_impl<int16_t>(table, class_of, accept, S, stream,
                               offsets, n_streams, starts, counts, finals);
}
}  // extern "C"

extern "C" {  // remaining C entry points

// Lazy-DFA table walk: follow an incrementally-built subset-DFA table until
// the stream ends or an un-expanded state is reached (the Python side then
// expands and resumes).  Counts per-subset-state visits.
//   table:    (cap, C) int32 STATE-MAJOR — one state's whole class row sits
//             in 1-2 cache lines, so hot hub states stay resident; cell -1 =
//             unexplored (never read for expanded states)
//   expanded: (cap,) uint8 — 1 if the state's row is valid
//   lut:      (256,) uint8 byte -> class id
//   stream:   (len,) raw bytes (class mapping fused into the walk)
//   visits:   (cap,) int64 — accumulated per-state visit counts
// Returns the number of bytes consumed; *io_sid is updated in place.
int64_t lazy_walk(const int32_t* table, int64_t C,
                  const uint8_t* expanded, const uint8_t* lut,
                  const uint8_t* accepting, const uint8_t* stream,
                  int64_t len, int32_t* io_sid, int64_t* visits) {
  int32_t sid = *io_sid;
  int64_t pos = 0;
  for (; pos < len; ++pos) {
    if (!expanded[sid]) break;
    // only ACCEPTING subset-state visits are ever consumed
    // (accept_counts maps them to per-NFA-state match counts); gating
    // the random-index RMW on the rare accept flag removes most of the
    // walk's store traffic (r5; same trick as dfa_scan_multi above)
    if (accepting[sid]) visits[sid]++;
    sid = table[(int64_t)sid * C + lut[stream[pos]]];
  }
  *io_sid = sid;
  return pos;
}

// k-gram class mapping (host ingest for ops/kgram.py) — numpy fancy
// indexing measured ~83 MB/s for this; these sequential streaming passes
// run at memory speed.
//   kgram_level1: out[i] = remap[lut[data[2i]] * c + lut[data[2i+1]]]
//   kgram_pair:   out[i] = remap[in[2i] * c + in[2i+1]]
void kgram_level1(const uint8_t* data, int64_t n_pairs, const uint8_t* lut,
                  const int32_t* remap, int64_t c, int32_t* out) {
  for (int64_t i = 0; i < n_pairs; ++i)
    out[i] = remap[(int64_t)lut[data[2 * i]] * c + lut[data[2 * i + 1]]];
}

void kgram_pair(const int32_t* in, int64_t n_pairs, const int32_t* remap,
                int64_t c, int32_t* out) {
  for (int64_t i = 0; i < n_pairs; ++i)
    out[i] = remap[(int64_t)in[2 * i] * c + in[2 * i + 1]];
}

}  // extern "C" (resumed below — templates need C++ linkage)

template <bool COUNT>
static int64_t walk_multi_impl(const int32_t* __restrict table, int64_t C,
                               const uint8_t* __restrict expanded,
                               const uint8_t* __restrict lut,
                               const uint8_t* __restrict accepting,
                               const uint8_t* __restrict stream,
                               int64_t* __restrict pos,
                               const int64_t* __restrict end,
                               int32_t* __restrict sids, int64_t W,
                               int64_t* __restrict visits,
                               int64_t visits_stride) {
  constexpr int64_t MAXW = 512;
  if (W > MAXW) W = MAXW;
  // cursor state lives on the stack so the hot loop keeps it in registers /
  // L1 regardless of aliasing between the caller's int32/int64 buffers
  int64_t p[MAXW];
  int32_t s[MAXW];
  int32_t idx[MAXW];
  int64_t na = 0;
  for (int64_t c = 0; c < W; ++c) {
    p[c] = pos[c];
    s[c] = sids[c];
    if (p[c] < end[c]) idx[na++] = (int32_t)c;
  }
  while (na) {
    int64_t alive = na;
    for (int64_t j = 0; j < alive; ++j) {
      const int32_t c = idx[j];
      const int32_t st = s[c];
      if (!expanded[st] || p[c] >= end[c]) {   // blocked or finished:
        idx[j--] = idx[--alive];               // compact out of the ring
        continue;
      }
      if (COUNT && accepting[st]) visits[(int64_t)c * visits_stride + st]++;
      s[c] = table[(int64_t)st * C + lut[stream[p[c]++]]];
    }
    if (alive == na) continue;  // all still running
    // some cursor left the ring this sweep; if none remain, stop
    na = alive;
  }
  int64_t blocked = 0;
  for (int64_t c = 0; c < W; ++c) {
    pos[c] = p[c];
    sids[c] = s[c];
    if (p[c] < end[c]) ++blocked;
  }
  return blocked;
}

extern "C" {

// Anchored longest-match span extraction with non-overlap suppression —
// the forward stage of api.Matcher.finditer (POSIX leftmost-longest).
// The backward (match-start) pass runs on the device; this walks the
// anchored DFA from each candidate start, keeps the longest end, and
// suppresses starts inside an earlier span, exactly mirroring the Python
// reference loop in api.py (which runs at ~1 MB/s on match-dense corpora).
//   table:      (256, S) int32, RAW-byte indexed (anchored DFA)
//   accept:     (S,) uint8;  accept_eof: (S,) uint8 (end-anchored accepts)
//   starts:     (n_starts,) int64 sorted candidate start offsets
//   out_spans:  (max_spans, 2) int64
// Returns the number of spans written; -1 if max_spans was too small.
int64_t anchored_spans(const int32_t* table, const uint8_t* accept,
                       const uint8_t* accept_eof, int32_t start_state,
                       int32_t dead, int64_t S,
                       const uint8_t* stream, int64_t len,
                       const int64_t* starts, int64_t n_starts,
                       int64_t* out_spans, int64_t max_spans) {
  int64_t n_out = 0;
  int64_t p = 0;  // next allowed start (non-overlap suppression)
  for (int64_t si = 0; si < n_starts; ++si) {
    const int64_t s0 = starts[si];
    if (s0 < p) continue;
    int32_t st = start_state;
    int64_t last_end = accept[st] ? s0 : -1;
    for (int64_t i = s0; i < len; ++i) {
      st = table[(int64_t)stream[i] * S + st];
      if (st == dead) break;
      if (accept[st]) last_end = i + 1;
    }
    if (st != dead && accept_eof[st] && !accept[st])
      last_end = len;  // end-anchored: match closes at EOF only
    if (last_end >= 0) {
      if (n_out == max_spans) return -1;
      out_spans[2 * n_out] = s0;
      out_spans[2 * n_out + 1] = last_end;
      ++n_out;
      p = last_end > s0 ? last_end : s0 + 1;  // empty match: advance 1 byte
    }
  }
  return n_out;
}

// NFA match positions: byte offsets where some ACTIVE state is accepting
// (the reference's one-char-late count timing; the position AFTER the last
// byte is never reported, matching the harness stop — SURVEY.md SS3.3).
// Layout identical to nfa_scan above.  out_pos: (max_pos,) int64.
// Returns count; -1 if max_pos too small; -2 on active-set overflow.
int64_t nfa_match_positions(const int32_t* delta, const int32_t* class_of,
                            const uint8_t* accept, int64_t S, int64_t K,
                            const uint8_t* stream, int64_t len,
                            int32_t* active_io, int64_t active_cap,
                            int64_t* out_pos, int64_t max_pos) {
  std::vector<int32_t> cur(active_io, active_io + active_cap);
  std::vector<int32_t> nxt;
  nxt.reserve(active_cap * K);
  std::vector<uint8_t> in_next(S + 1, 0);
  int64_t ncur = 0;
  while (ncur < active_cap && cur[ncur] != S) ncur++;
  cur.resize(ncur);

  int64_t n_out = 0;
  for (int64_t pos = 0; pos < len; ++pos) {
    const int64_t cls = class_of[stream[pos]];
    const int32_t* drow = delta + cls * (S + 1) * K;
    nxt.clear();
    bool acc = false;
    for (int32_t s : cur) {
      acc |= accept[s] != 0;
      const int32_t* cell = drow + (int64_t)s * K;
      for (int64_t k = 0; k < K; ++k) {
        const int32_t t = cell[k];
        if (t != S && !in_next[t]) {
          in_next[t] = 1;
          nxt.push_back(t);
        }
      }
    }
    if (acc) {
      if (n_out == max_pos) return -1;
      out_pos[n_out++] = pos;
    }
    for (int32_t t : nxt) in_next[t] = 0;
    if ((int64_t)nxt.size() > active_cap) return -2;
    cur.swap(nxt);
  }
  std::vector<int32_t> fin(cur);
  std::sort(fin.begin(), fin.end());
  for (int64_t i = 0; i < active_cap; ++i)
    active_io[i] = i < (int64_t)fin.size() ? fin[i] : (int32_t)S;
  return n_out;
}

// Multi-cursor lazy-DFA walk — W independent cursors advanced round-robin
// one byte each, so their dependent table loads overlap in the memory
// system (the serial walk above is latency-bound: one load per byte).
//   table/expanded: as lazy_walk (state-major)
//   lut/stream: as lazy_walk; cursor c walks [pos[c], end[c])
//   pos:   (W,) int64 in/out
//   sids:  (W,) int32 in/out
//   visits: int64 — visits[c*visits_stride + state] bumped per byte when
//          count != 0.  stride 0 = one shared histogram (caller threads
//          pass disjoint buffers and merge); stride = cap gives exact
//          per-cursor histograms (batch mode: one independent stream per
//          cursor; disjoint rows are naturally thread-safe)
// Returns the number of cursors blocked on an un-expanded state (0 means
// every cursor reached its end).  W is capped at 512.
int64_t lazy_walk_multi(const int32_t* table, int64_t C,
                        const uint8_t* expanded, const uint8_t* lut,
                        const uint8_t* accepting, const uint8_t* stream,
                        int64_t* pos, const int64_t* end, int32_t* sids,
                        int64_t W, int64_t* visits, int32_t count,
                        int64_t visits_stride) {
  return count
      ? walk_multi_impl<true>(table, C, expanded, lut, accepting, stream,
                              pos, end, sids, W, visits, visits_stride)
      : walk_multi_impl<false>(table, C, expanded, lut, accepting, stream,
                               pos, end, sids, W, visits, visits_stride);
}

}  // extern "C"
