"""Snort ``.rules`` front-end: parse rules, scan with the AC prefilter +
per-rule verification pipeline.

The reference's second ruleset image, ``CSR_BlockMem_snort_16.coe``, derives
from Snort IDS rules (`/root/reference/Block_Mem/`, SURVEY.md §2.1 #14), but
the compiler that produced it was never published.  This module closes the
loop on the *source* side: read real Snort rule files and scan traffic with
the same two-stage architecture Snort itself uses —

  1. **multi-pattern prefilter** (device): every rule's ``content``
     literals go into one Aho–Corasick automaton (``models/literals.py``)
     scanned by the fast device engines; a rule is a candidate only if ALL its
     non-negated contents occur in the stream.  Case-insensitive
     (``nocase``) contents are handled by a second automaton over the
     case-folded stream.
  2. **per-rule verification** (host, candidates only): ordered occurrence
     of the contents (each must match after the previous one ends), absence
     of negated contents, and the rule's ``pcre`` (if present) checked with
     this framework's own DFA regex engine where the pattern compiles
     (PCRE constructs outside the supported subset leave the rule
     content-verified only, flagged in the result).

Supported + ENFORCED rule options: ``msg``, ``sid``, ``content`` (with
``|hex|`` escapes, ``!`` negation, the ``nocase`` modifier, and the
positional modifiers ``offset``/``depth`` — absolute window from payload
start — and ``distance``/``within`` — window relative to the previous
content match's end), ``pcre``, and the byte-level options ``byte_test``
and ``byte_jump`` (binary big/little-endian and ``string`` decimal/hex/oct
conversion, ``relative``, ``bitmask``, and byte_jump's ``multiplier``/
``align``/``from_beginning``/``from_end``/``post_offset`` — pure host span
arithmetic in the ordered verify walk, ``api.SnortMatcher._verify``), plus
``byte_extract`` (bind a converted payload value to a NAME usable by later
byte ops, content windows, and ``isdataat`` in the same rule) and
``isdataat`` (payload-extent assertion, ``!`` negation, ``relative``) and
``dsize`` (payload-size predicate; inclusive range per Snort 2.9).
The verifier backtracks across content occurrences, so a rule matches
whenever ANY assignment of occurrences satisfies every window
(greedy-first would wrongly refuse some rules); byte_extract bindings ride
the same walk as an immutable environment, so they backtrack correctly
too.  HTTP sticky buffers (``http_uri``/``http_method``/``http_header``/
``http_client_body``/``http_cookie`` + the ``raw_`` aliases) are ENFORCED
against a conservative verbatim carve of one request per payload
(``models/http.py``): buffered contents search only their buffer slice
with buffer-relative windows and per-buffer cursors; byte ops chained
relative to a buffered content are outside the model and flagged instead
of approximated.  Remaining options (flow/flowbits, ``dce`` byte ops,
``fast_pattern:only``, …) are preserved in ``SnortRule.options`` but not
enforced — this is a stream scanner, not a full packet IDS;
``api.SnortMatcher.enforcement_report()`` says per rule which category it
landed in.
"""

from __future__ import annotations

import dataclasses
import re as _pyre

__all__ = [
    "SnortContent",
    "ByteTest",
    "ByteJump",
    "ByteExtract",
    "IsDataAt",
    "SnortRule",
    "parse_snort_rules",
    "load_snort_rules",
]


@dataclasses.dataclass(frozen=True)
class SnortContent:
    pattern: bytes
    nocase: bool = False
    negated: bool = False
    #: positional modifiers (ENFORCED by the matcher, ``api.SnortMatcher``):
    #: ``offset``/``depth`` window the search absolutely from payload start
    #: (depth is measured from offset, per Snort); ``distance``/``within``
    #: window it relative to the END of the previous content match
    #: (``within`` bounds the current match's END, Suricata-compatible).
    #: None = unconstrained.  Variable (byte_extract) values stay None.
    offset: int | None = None
    depth: int | None = None
    distance: int | None = None
    within: int | None = None
    #: HTTP sticky buffer (``http_uri``/``http_method``/``http_header``/
    #: ``http_client_body``/``http_cookie`` modifiers; the ``raw_`` forms
    #: map to the same carve since this scanner never normalizes —
    #: ``models/http.py``).  None = the raw payload.  Windows/cursors for
    #: buffered contents are BUFFER-relative (Snort per-buffer DOE).
    buffer: str | None = None


@dataclasses.dataclass(frozen=True)
class ByteTest:
    """``byte_test:<count>,<op>,<value>,<offset>[,mods]`` — read ``count``
    bytes at ``offset`` (absolute, or relative to the previous content
    match's end), convert (binary big/little endian, or ASCII ``string``
    in ``base``), optionally AND+shift by ``bitmask``, and compare against
    ``value``.  Zero-width: the verify cursor does not move.  A read past
    either payload edge fails the rule (Snort semantics)."""

    count: int
    op: str               # '<' '>' '=' '<=' '>=' '&' '^'
    negate: bool
    value: int | str      # str = byte_extract variable name
    offset: int | str
    relative: bool = False
    endian: str = "big"   # "big" | "little"
    string: bool = False
    base: int = 10        # 10 | 16 | 8 (string conversion)
    bitmask: int | None = None


@dataclasses.dataclass(frozen=True)
class ByteExtract:
    """``byte_extract:<count>,<offset>,<name>[,mods]`` — read + convert
    like ``ByteTest`` and BIND the value to ``name``; later options in the
    SAME rule may reference it (``byte_test`` value/offset, ``byte_jump``
    offset, content ``offset``/``depth``/``distance``/``within``,
    ``isdataat``).  Moves the verify cursor to the END of the extracted
    bytes (Snort DOE-pointer semantics — relative ops after an extract
    anchor there); a read outside the payload fails the rule.  Bindings
    participate in backtracking naturally (the verify walk threads an
    immutable env)."""

    count: int
    offset: int | str      # may itself reference an earlier variable
    name: str
    relative: bool = False
    multiplier: int = 1
    endian: str = "big"
    string: bool = False
    base: int = 10


@dataclasses.dataclass(frozen=True)
class IsDataAt:
    """``isdataat:<n>[,relative]`` (``!`` negation) — assert the payload
    has a byte at position ``n`` (absolute, or from the cursor under
    ``relative``).  ``n`` may reference a ``byte_extract`` variable."""

    pos: int | str
    relative: bool = False
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class ByteJump:
    """``byte_jump:<count>,<offset>[,mods]`` — read ``count`` bytes at
    ``offset`` (absolute or ``relative``), convert like ``ByteTest``,
    apply ``bitmask`` then ``multiplier`` then ``align`` (round up to a
    4-byte boundary), and move the verify cursor to
    ``read_end + value + post_offset`` (or payload start/end +
    ``value + post_offset`` under ``from_beginning``/``from_end``).
    A cursor landing outside the payload fails the rule."""

    count: int
    offset: int | str     # str = byte_extract variable name
    relative: bool = False
    multiplier: int = 1
    endian: str = "big"
    string: bool = False
    base: int = 10
    align: bool = False
    from_beginning: bool = False
    from_end: bool = False
    post_offset: int = 0
    bitmask: int | None = None


#: Snort2 content modifier -> buffer name (models/http.py carve).  The
#: raw_ forms alias the cooked ones: every buffer here is already a
#: verbatim payload slice (no normalization stage exists to differ from).
HTTP_BUFFER_OPTS = {
    # http_uri matches the NORMALIZED URI (percent-decode + path
    # compression, models/http.py::normalize_uri — Snort default
    # config); http_raw_uri is the verbatim payload slice.  They are
    # distinct buffer domains with separate DOE cursors.
    "http_uri": "uri", "http_raw_uri": "raw_uri",
    "http_method": "method",
    "http_header": "header", "http_raw_header": "header",
    "http_client_body": "client_body",
    "http_cookie": "cookie", "http_raw_cookie": "cookie",
}


def _int_tok(s: str) -> int:
    s = s.strip()
    neg = s.startswith("-")
    t = s[1:] if neg else s
    v = int(t, 16) if t.lower().startswith("0x") else int(t, 10)
    return -v if neg else v


def _int_or_var(s: str, names: frozenset | set) -> int | str:
    """Numeric literal, or the NAME of an earlier ``byte_extract``
    variable in the same rule; raises ValueError otherwise."""
    try:
        return _int_tok(s)
    except ValueError:
        t = s.strip()
        if names and t in names:
            return t
        raise


def parse_byte_test(val: str, names: frozenset | set = frozenset()
                    ) -> ByteTest | None:
    """Parse a ``byte_test`` option value; None when outside the enforced
    subset (``dce``, undefined variables, unknown modifiers) — the rule
    then stays content/pcre-verified and ``enforcement_report`` flags it.
    ``names`` holds byte_extract variables defined earlier in the rule
    (legal in the value/offset fields)."""
    parts = [p.strip() for p in val.split(",")]
    if len(parts) < 4:
        return None
    try:
        count = int(parts[0])
        op = parts[1]
        negate = op.startswith("!")
        if negate:
            op = op[1:] or "="
        if op not in ("<", ">", "=", "<=", ">=", "&", "^"):
            return None
        value = _int_or_var(parts[2], names)
        offset = _int_or_var(parts[3], names)
    except ValueError:
        return None
    relative, endian, string, base, bitmask = False, "big", False, 10, None
    for mraw in parts[4:]:
        m = mraw.lower()
        if m == "relative":
            relative = True
        elif m in ("big", "little"):
            endian = m
        elif m == "string":
            string = True
        elif m in ("hex", "dec", "oct"):
            base = {"hex": 16, "dec": 10, "oct": 8}[m]
        elif m.startswith("bitmask"):
            toks = mraw.split()
            if len(toks) != 2:
                return None
            try:
                bitmask = _int_tok(toks[1])
            except ValueError:
                return None
            if bitmask <= 0:
                return None
        else:
            return None  # dce / byte_extract var / unknown: unenforced
    if not (1 <= count <= (10 if string else 4)):
        return None
    return ByteTest(count=count, op=op, negate=negate, value=value,
                    offset=offset, relative=relative, endian=endian,
                    string=string, base=base, bitmask=bitmask)


def parse_byte_jump(val: str, names: frozenset | set = frozenset()
                    ) -> ByteJump | None:
    """Parse a ``byte_jump`` option value; None when outside the enforced
    subset (see ``parse_byte_test``)."""
    parts = [p.strip() for p in val.split(",")]
    if len(parts) < 2:
        return None
    try:
        count = int(parts[0])
        offset = _int_or_var(parts[1], names)
    except ValueError:
        return None
    relative = string = align = from_beginning = from_end = False
    endian, base, multiplier, post_offset, bitmask = "big", 10, 1, 0, None
    for mraw in parts[2:]:
        m = mraw.lower()
        if m == "relative":
            relative = True
        elif m in ("big", "little"):
            endian = m
        elif m == "string":
            string = True
        elif m in ("hex", "dec", "oct"):
            base = {"hex": 16, "dec": 10, "oct": 8}[m]
        elif m == "align":
            align = True
        elif m == "from_beginning":
            from_beginning = True
        elif m == "from_end":
            from_end = True
        elif m.startswith(("multiplier", "post_offset", "bitmask")):
            toks = mraw.split()
            if len(toks) != 2:
                return None
            try:
                v = _int_tok(toks[1])
            except ValueError:
                return None
            if toks[0].lower() == "multiplier":
                if v <= 0:
                    return None
                multiplier = v
            elif toks[0].lower() == "post_offset":
                post_offset = v
            else:
                if v <= 0:
                    return None
                bitmask = v
        else:
            return None
    if count == 0 and from_end:
        pass  # byte_jump:0,...,from_end is legal (pure cursor move)
    elif not (1 <= count <= (10 if string else 4)):
        return None
    return ByteJump(count=count, offset=offset, relative=relative,
                    multiplier=multiplier, endian=endian, string=string,
                    base=base, align=align, from_beginning=from_beginning,
                    from_end=from_end, post_offset=post_offset,
                    bitmask=bitmask)


def parse_byte_extract(val: str, names: frozenset | set = frozenset()
                       ) -> ByteExtract | None:
    """Parse a ``byte_extract`` option value; None outside the subset."""
    parts = [p.strip() for p in val.split(",")]
    if len(parts) < 3:
        return None
    try:
        count = int(parts[0])
        offset = _int_or_var(parts[1], names)
    except ValueError:
        return None
    name = parts[2]
    if not name.isidentifier():
        return None
    relative = string = False
    endian, base, multiplier = "big", 10, 1
    for mraw in parts[3:]:
        m = mraw.lower()
        if m == "relative":
            relative = True
        elif m in ("big", "little"):
            endian = m
        elif m == "string":
            string = True
        elif m in ("hex", "dec", "oct"):
            base = {"hex": 16, "dec": 10, "oct": 8}[m]
        elif m.startswith("multiplier"):
            toks = mraw.split()
            if len(toks) != 2:
                return None
            try:
                multiplier = _int_tok(toks[1])
            except ValueError:
                return None
            if multiplier <= 0:
                return None
        else:
            return None  # align/dce/bitmask etc: unenforced
    if not (1 <= count <= (10 if string else 4)):
        return None
    return ByteExtract(count=count, offset=offset, name=name,
                       relative=relative, multiplier=multiplier,
                       endian=endian, string=string, base=base)


def parse_is_data_at(val: str, names: frozenset | set = frozenset()
                     ) -> IsDataAt | None:
    """Parse an ``isdataat`` option value; None outside the subset."""
    parts = [p.strip() for p in val.split(",")]
    if not parts or not parts[0]:
        return None
    tok = parts[0]
    negate = tok.startswith("!")
    if negate:
        tok = tok[1:].strip()
    try:
        pos = _int_or_var(tok, names)
    except ValueError:
        return None
    relative = False
    for mraw in parts[1:]:
        if mraw.lower() == "relative":
            relative = True
        else:
            return None  # rawbytes etc: unenforced
    return IsDataAt(pos=pos, relative=relative, negate=negate)


@dataclasses.dataclass(frozen=True)
class SnortRule:
    action: str
    proto: str
    header: str                       # the full "src -> dst" header text
    msg: str
    sid: int | None
    contents: tuple[SnortContent, ...]
    pcre: str | None                  # raw /pattern/flags text, or None
    options: tuple[tuple[str, str | None], ...]  # every option, in order
    #: ordered verify program: SnortContent | ByteTest | ByteJump |
    #: ByteExtract | IsDataAt in rule option order (byte ops are
    #: positional — ``relative`` anchors to the op before them).  Empty
    #: for hand-built rules: the matcher falls back to ``contents``.
    verify_ops: tuple = ()
    #: ``dsize`` payload-size predicate: inclusive (lo, hi) bounds with
    #: None = unbounded (``>300`` -> (301, None), ``<300`` -> (None, 299),
    #: ``300`` -> (300, 300), ``300<>400`` -> (300, 400) — Snort 2.9+
    #: treats the range as inclusive).  None = no constraint.
    dsize: tuple | None = None
    #: ``urilen`` URI-length predicate: (lo, hi, mode) with inclusive
    #: bounds (None = unbounded) parsed like ``dsize``; ``mode`` is
    #: ``"norm"`` (default, the Snort 2.9 http_inspect normalized-URI
    #: buffer — models/http.py::normalize_uri) or ``"raw"`` (the verbatim
    #: URI slice).  None = no constraint (unparsed forms are flagged by
    #: ``enforcement_report``).  A payload with no parseable HTTP request
    #: has no URI, so the rule cannot fire (Snort: buffer absent).
    urilen: tuple | None = None
    #: positional content modifiers DROPPED at parse time ("depth:varlen"
    #: strings): the referenced byte_extract variable is undefined, or
    #: defined only AFTER the content the modifier belongs to (the verify
    #: walk evaluates the content first, so the binding could never be
    #: live — Snort requires extracts to precede their uses).  Surfaced
    #: by ``api.SnortMatcher.enforcement_report`` as partial enforcement.
    unenforced_modifiers: tuple = ()


_HEX_CHUNK = _pyre.compile(r"\|([0-9A-Fa-f\s]*)\|")


def _decode_content(text: str) -> bytes:
    """Snort content string → bytes: ``|41 42|`` hex chunks, backslash
    escapes for ``; " \\ :`` and literal bytes otherwise."""
    out = bytearray()
    i = 0
    while i < len(text):
        c = text[i]
        if c == "|":
            m = _HEX_CHUNK.match(text, i)
            if not m:
                raise ValueError(f"unterminated |hex| in content: {text!r}")
            for tok in m.group(1).split():
                if len(tok) % 2:
                    raise ValueError(f"odd-length hex token in content: {tok!r}")
                for j in range(0, len(tok), 2):
                    out.append(int(tok[j:j + 2], 16))
            i = m.end()
        elif c == "\\" and i + 1 < len(text):
            out.append(ord(text[i + 1]))
            i += 2
        else:
            out.append(ord(c))
            i += 1
    return bytes(out)


def _split_options(body: str) -> list[tuple[str, str | None]]:
    """Split a rule body on ``;`` outside quotes; each option is
    ``name[:value]``."""
    opts: list[tuple[str, str | None]] = []
    cur = []
    in_q = False
    i = 0
    while i < len(body):
        c = body[i]
        if c == '"' and (i == 0 or body[i - 1] != "\\"):
            in_q = not in_q
            cur.append(c)
        elif c == ";" and not in_q:
            tok = "".join(cur).strip()
            if tok:
                name, _, val = tok.partition(":")
                opts.append((name.strip(), val.strip() if _ else None))
            cur = []
        else:
            cur.append(c)
        i += 1
    tok = "".join(cur).strip()
    if tok:
        name, _, val = tok.partition(":")
        opts.append((name.strip(), val.strip() if _ else None))
    return opts


def _unquote(val: str) -> tuple[str, bool]:
    """Strip optional leading ``!`` and surrounding quotes; returns
    (text, negated)."""
    negated = False
    v = val.strip()
    if v.startswith("!"):
        negated = True
        v = v[1:].strip()
    if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
        v = v[1:-1]
    return v, negated


def parse_snort_rules(text: str) -> list[SnortRule]:
    """Parse a Snort rules file (comments, blank lines, ``\\`` line
    continuations).  Lines without a ``( ... )`` option body are skipped
    (preprocessor directives, variables)."""
    rules: list[SnortRule] = []
    logical: list[str] = []
    pending = ""
    for raw in text.splitlines():
        line = pending + raw
        pending = ""
        if line.rstrip().endswith("\\"):
            pending = line.rstrip()[:-1]
            continue
        logical.append(line)
    if pending:
        logical.append(pending)

    for line in logical:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        lp = line.find("(")
        rp = line.rfind(")")
        if lp == -1 or rp == -1 or rp < lp:
            continue
        head = line[:lp].split()
        if len(head) < 2:
            continue
        action, proto = head[0], head[1]
        header = " ".join(head[2:])
        opts = _split_options(line[lp + 1 : rp])

        msg = ""
        sid: int | None = None
        pcre: str | None = None
        dsize: tuple | None = None
        urilen: tuple | None = None
        contents: list[SnortContent] = []
        #: SnortContent | ByteTest | ByteJump | ByteExtract | IsDataAt
        ops: list = []
        var_names: set[str] = set()  # byte_extract bindings so far
        #: bindings live BEFORE the latest content was appended — the only
        #: ones its own modifiers may reference (the verify walk evaluates
        #: the content before any later extract, so a later binding could
        #: never be in scope; review r4 finding 1)
        vars_at_last_content: frozenset = frozenset()
        dropped_mods: list[str] = []
        last_content_op = -1  # index into ops of the latest content
        dropped_neg_ops: set = set()  # ops idxs: negated contents whose
        # positional modifier was unresolvable (dropped, not widened)

        def _update_last(new_content: SnortContent) -> None:
            contents[-1] = new_content
            ops[last_content_op] = new_content

        for name, val in opts:
            if name == "msg" and val is not None:
                msg = _unquote(val)[0]
            elif name == "sid" and val is not None:
                try:
                    sid = int(val)
                except ValueError:
                    pass
            elif name == "content" and val is not None:
                s, neg = _unquote(val)
                c = SnortContent(pattern=_decode_content(s), negated=neg)
                contents.append(c)
                ops.append(c)
                last_content_op = len(ops) - 1
                vars_at_last_content = frozenset(var_names)
            elif name == "nocase" and contents:
                _update_last(dataclasses.replace(contents[-1], nocase=True))
            elif name in HTTP_BUFFER_OPTS and contents:
                _update_last(dataclasses.replace(
                    contents[-1], buffer=HTTP_BUFFER_OPTS[name]
                ))
            elif (name in ("offset", "depth", "distance", "within")
                  and contents and val is not None):
                try:
                    _update_last(dataclasses.replace(
                        contents[-1],
                        **{name: _int_or_var(val, vars_at_last_content)}
                    ))
                except ValueError:
                    # undefined variable, or one extracted only AFTER this
                    # content (never in scope when the content evaluates):
                    # modifier dropped and FLAGGED, not silently enforced
                    # against an empty env (which would kill the rule)
                    if contents[-1].negated:
                        # not applying a positional modifier to a NEGATED
                        # content widens its asserted absence to the
                        # whole buffer (false negatives) — mark the op
                        # itself for the drop-not-widen treatment
                        # (resolved below; r5 review finding 1)
                        dropped_neg_ops.add(last_content_op)
                        dropped_mods.append(
                            f"negated content "
                            f"{contents[-1].pattern!r} ({name}:"
                            f"{val.strip()} unresolvable; op dropped, "
                            f"not widened)"
                        )
                    else:
                        dropped_mods.append(f"{name}:{val.strip()}")
            elif name == "byte_test" and val is not None:
                bt = parse_byte_test(val, var_names)
                if bt is not None:
                    ops.append(bt)
                # unparsed: stays in options; buffer-anchored relative
                # ops are dropped by _resolve_buffer_anchors below and the
                # enforcement report flags both
            elif name == "byte_jump" and val is not None:
                bj = parse_byte_jump(val, var_names)
                if bj is not None:
                    ops.append(bj)
            elif name == "byte_extract" and val is not None:
                be = parse_byte_extract(val, var_names)
                if be is not None:
                    var_names.add(be.name)
                    ops.append(be)
            elif name == "isdataat" and val is not None:
                ida = parse_is_data_at(val, var_names)
                if ida is not None:
                    ops.append(ida)
            elif name == "dsize" and val is not None:
                dsize = parse_dsize(val)
                # unparsed forms stay in options; report flags them via
                # the option falling outside the enforced set check below
            elif name == "urilen" and val is not None:
                urilen = parse_urilen(val)
            elif name == "pcre" and val is not None:
                pcre = _unquote(val)[0]
        if dropped_neg_ops:
            dropped = {id(ops[i]) for i in dropped_neg_ops}
            ops = [o for i, o in enumerate(ops) if i not in dropped_neg_ops]
            contents = [c for c in contents if id(c) not in dropped]
        ops = _resolve_buffer_anchors(ops, dropped_mods)
        rules.append(
            SnortRule(
                action=action,
                proto=proto,
                header=header,
                msg=msg,
                sid=sid,
                contents=tuple(contents),
                pcre=pcre,
                options=tuple(opts),
                verify_ops=tuple(ops),
                unenforced_modifiers=tuple(dropped_mods),
                dsize=dsize,
                urilen=urilen,
            )
        )
    return rules


def parse_dsize(val: str) -> tuple | None:
    """``dsize`` value -> inclusive (lo, hi) bounds, or None if unparsed."""
    v = val.strip()
    try:
        if "<>" in v:
            a, b = v.split("<>", 1)
            lo, hi = int(a), int(b)
            return (lo, hi) if lo <= hi else None
        if v.startswith(">"):
            return (int(v[1:]) + 1, None)
        if v.startswith("<"):
            n = int(v[1:])
            return (None, n - 1) if n > 0 else None
        n = int(v)
        return (n, n)
    except ValueError:
        return None


def parse_urilen(val: str) -> tuple | None:
    """``urilen`` value -> (lo, hi, mode) inclusive bounds, or None.

    Grammar (Snort 2.9): ``int | >int | <int | int<>int [, norm|raw]``;
    the buffer defaults to the NORMALIZED URI."""
    v = val.strip()
    mode = "norm"
    if "," in v:
        v, m = (t.strip() for t in v.split(",", 1))
        if m not in ("norm", "raw"):
            return None
        mode = m
    rng = parse_dsize(v)
    if rng is None:
        return None
    return (rng[0], rng[1], mode)


def _resolve_buffer_anchors(ops: list, dropped_mods: list[str]) -> list:
    """POST-parse anchor-domain pass (runs after every modifier has
    mutated its content, so ordering games cannot bypass it — review r4).

    The verify walk keeps the raw-payload cursor and one cursor per HTTP
    buffer.  Snort's semantics after a buffered content are per-buffer
    DOE; shapes this walk cannot reproduce are DROPPED AND FLAGGED rather
    than silently mis-anchored:

    * a relative byte op whose anchor is a buffered content (in rule
      order, regardless of where the ``http_*`` modifier appeared);
    * ``distance``/``within`` on a content whose anchor lives in a
      DIFFERENT domain (raw vs buffer, or two different buffers) — the
      modifiers are stripped, the content itself stays enforced;
    * any later op referencing a variable whose ``byte_extract`` was
      dropped above (the binding could never be live).
    """
    cleaned: list = []
    anchor: object = "raw-start"  # raw cursor at 0: valid raw anchor
    dead_vars: set[str] = set()

    def _refs_dead(op) -> bool:
        vals = []
        if isinstance(op, ByteTest):
            vals = [op.value, op.offset]
        elif isinstance(op, (ByteJump, ByteExtract)):
            vals = [op.offset]
        elif isinstance(op, IsDataAt):
            vals = [op.pos]
        return any(isinstance(v, str) and v in dead_vars for v in vals)

    for op in ops:
        if isinstance(op, SnortContent):
            dom = op.buffer  # None = raw payload
            # offset/depth referencing a dropped byte_extract can never
            # resolve (the verify walk would hit the unresolved-variable
            # sentinel and fail the rule FOREVER — a silent false
            # negative).  Strip and flag, mirroring distance/within
            # (advisor r4 finding 1).
            if any(isinstance(v, str) and v in dead_vars
                   for v in (op.offset, op.depth)):
                if op.negated:
                    # Stripping offset/depth from a NEGATED content would
                    # widen the asserted absence from a window to the
                    # whole buffer (false negatives whenever the pattern
                    # appears anywhere) — same class as the
                    # distance/within case below.  Drop the negation op
                    # entirely: match-more, flagged (r5 review finding 1).
                    dropped_mods.append(
                        f"negated content {op.pattern!r} (offset/depth "
                        f"references a dropped byte_extract; op dropped, "
                        f"not widened)"
                    )
                    continue
                dropped_mods.append(
                    f"offset/depth on content {op.pattern!r} "
                    f"(references a dropped byte_extract)"
                )
                op = dataclasses.replace(
                    op,
                    offset=(None if isinstance(op.offset, str)
                            and op.offset in dead_vars else op.offset),
                    depth=(None if isinstance(op.depth, str)
                           and op.depth in dead_vars else op.depth),
                )
            if op.distance is not None or op.within is not None:
                eff = None if anchor == "raw-start" else anchor
                dead_mod_vals = {
                    v for v in (op.distance, op.within)
                    if isinstance(v, str) and v in dead_vars
                }
                if eff != dom or dead_mod_vals:
                    why = ("crosses buffers" if eff != dom
                           else "references a dropped byte_extract")
                    if op.negated:
                        # Stripping distance/within from a NEGATED
                        # content would WIDEN the asserted absence from a
                        # small window to the whole buffer — the rule
                        # would stop firing whenever the pattern appears
                        # anywhere (IDS false negative).  Drop the
                        # negation op entirely instead: match-more,
                        # flagged (advisor r4 finding 2).  The anchor is
                        # unchanged — negated contents never move any
                        # verify cursor.
                        dropped_mods.append(
                            f"negated content {op.pattern!r} ({why}; "
                            f"op dropped, not widened)"
                        )
                        continue
                    dropped_mods.append(
                        f"distance/within on content {op.pattern!r} "
                        f"({why})"
                    )
                    op = dataclasses.replace(op, distance=None, within=None)
            cleaned.append(op)
            anchor = dom
        elif isinstance(op, (ByteJump, ByteExtract)):
            if (op.relative and anchor not in (None, "raw-start")) \
                    or _refs_dead(op):
                if isinstance(op, ByteExtract):
                    dead_vars.add(op.name)
                continue  # dropped; enforcement report counts it
            cleaned.append(op)
            anchor = None  # moves the RAW cursor
        else:  # ByteTest / IsDataAt: zero-width, anchor unchanged
            if (op.relative and anchor not in (None, "raw-start")) \
                    or _refs_dead(op):
                continue
            cleaned.append(op)
    return cleaned


def load_snort_rules(path: str) -> list[SnortRule]:
    with open(path, "r", errors="surrogateescape") as f:
        return parse_snort_rules(f.read())


def pcre_to_pattern(pcre: str) -> str | None:
    """Best-effort ``/pattern/flags`` → this framework's regex subset.
    Returns None when the flags or constructs are outside the subset
    (caller then relies on content verification alone)."""
    if not pcre.startswith("/"):
        return None
    end = pcre.rfind("/")
    if end <= 0:
        return None
    body, flags = pcre[1:end], pcre[end + 1 :]
    if set(flags) - set("ism"):  # x/R/U/B… not implemented
        return None
    # common PCRE-only constructs the compiler rejects anyway — fail fast
    # (\b IS supported — it routes the rule to the host Pike-VM verifier,
    # as do (?m) line anchors)
    if _pyre.search(r"\(\?<|\(\?=|\(\?!|\\[1-9]", body):
        return None
    prefix = ("(?i)" if "i" in flags else "") \
        + ("(?s)" if "s" in flags else "") \
        + ("(?m)" if "m" in flags else "")
    return prefix + body
