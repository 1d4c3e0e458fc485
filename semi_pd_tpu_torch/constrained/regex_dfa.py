"""Regex → DFA compiler (Thompson NFA + subset construction) (copy of
semi_pd_tpu/constrained/regex_dfa.py, which imports no JAX).

Replaces the reference's external grammar backends (srt/constrained/ —
outlines/xgrammar/llguidance wheels, base_grammar_backend.py:30-110) with a
self-contained engine: none of those packages exist in this environment, and
the serving-side contract is only "per-state allowed-token masks + state
advance", which a DFA provides.

Supported syntax: literals, ``.``, ``[...]``/``[^...]`` classes with ranges,
escapes (\\d \\w \\s \\D \\W \\S and escaped punctuation), groups ``(...)``,
alternation ``|``, quantifiers ``* + ? {m} {m,} {m,n}``, anchors are implicit
(patterns are fully anchored, as in constrained decoding).

Alphabet: unicode codepoints of the pattern plus a catch-all OTHER symbol so
DFAs stay small regardless of vocabulary size.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

EPS = None  # epsilon edge label
OTHER = ""  # private-use: "any character not otherwise named"

_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
)
_SPACE = frozenset(" \t\n\r\f\v")


@dataclasses.dataclass
class _Frag:
    start: int
    accepts: List[int]


class _NFA:
    def __init__(self):
        self.edges: List[List[Tuple[Optional[object], int]]] = []

    def new_state(self) -> int:
        self.edges.append([])
        return len(self.edges) - 1

    def add(self, s: int, label, t: int) -> None:
        self.edges[s].append((label, t))


class CharSet:
    """A set of characters, possibly negated (matches everything else)."""

    __slots__ = ("chars", "negated")

    def __init__(self, chars: FrozenSet[str], negated: bool = False):
        self.chars = chars
        self.negated = negated

    def matches(self, ch: str) -> bool:
        return (ch not in self.chars) if self.negated else (ch in self.chars)

    def __repr__(self):
        return f"CharSet({'^' if self.negated else ''}{sorted(self.chars)[:8]}...)"


class _Parser:
    """Recursive-descent regex parser building an NFA."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.nfa = _NFA()

    def parse(self) -> Tuple[_NFA, int, int]:
        frag = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r} at {self.i}")
        end = self.nfa.new_state()
        for a in frag.accepts:
            self.nfa.add(a, EPS, end)
        return self.nfa, frag.start, end

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _alt(self) -> _Frag:
        frags = [self._concat()]
        while self._peek() == "|":
            self.i += 1
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s = self.nfa.new_state()
        accepts = []
        for f in frags:
            self.nfa.add(s, EPS, f.start)
            accepts.extend(f.accepts)
        return _Frag(s, accepts)

    def _concat(self) -> _Frag:
        frags = []
        while self._peek() is not None and self._peek() not in "|)":
            frags.append(self._repeat())
        if not frags:
            s = self.nfa.new_state()
            return _Frag(s, [s])
        cur = frags[0]
        for nxt in frags[1:]:
            for a in cur.accepts:
                self.nfa.add(a, EPS, nxt.start)
            cur = _Frag(cur.start, nxt.accepts)
        return cur

    def _repeat(self) -> _Frag:
        atom_start = self.i  # local: nested re-parses must not clobber it
        frag = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self.i += 1
                frag = self._star(frag)
            elif c == "+":
                self.i += 1
                frag = self._plus(frag)
            elif c == "?":
                self.i += 1
                frag = self._opt(frag)
            elif c == "{":
                frag = self._counted(frag, atom_start)
            else:
                return frag

    # For counted repetition we re-parse the atom source to build independent
    # copies (NFA fragments can't be shared between repetitions).
    def _copy_atom(self, atom_start: int) -> _Frag:
        save_i = self.i
        self.i = atom_start
        frag = self._atom()
        self.i = save_i
        return frag

    def _counted(self, frag: _Frag, atom_start: int) -> _Frag:
        j = self.p.index("}", self.i)
        spec = self.p[self.i + 1 : j]
        self.i = j + 1
        if "," in spec:
            lo_s, hi_s = spec.split(",", 1)
            lo = int(lo_s) if lo_s else 0
            hi = int(hi_s) if hi_s.strip() else None
        else:
            lo = hi = int(spec)
        parts: List[_Frag] = []
        for _ in range(lo):
            parts.append(self._copy_atom(atom_start))
        if hi is None:
            parts.append(self._star(self._copy_atom(atom_start)))
        else:
            for _ in range(hi - lo):
                parts.append(self._opt(self._copy_atom(atom_start)))
        if not parts:
            s = self.nfa.new_state()
            return _Frag(s, [s])
        cur = parts[0]
        for nxt in parts[1:]:
            for a in cur.accepts:
                self.nfa.add(a, EPS, nxt.start)
            cur = _Frag(cur.start, nxt.accepts)
        return cur

    def _star(self, frag: _Frag) -> _Frag:
        s = self.nfa.new_state()
        self.nfa.add(s, EPS, frag.start)
        for a in frag.accepts:
            self.nfa.add(a, EPS, s)
        return _Frag(s, [s])

    def _plus(self, frag: _Frag) -> _Frag:
        s = self.nfa.new_state()
        for a in frag.accepts:
            self.nfa.add(a, EPS, s)
        self.nfa.add(s, EPS, frag.start)
        return _Frag(frag.start, [s])

    def _opt(self, frag: _Frag) -> _Frag:
        s = self.nfa.new_state()
        e = self.nfa.new_state()
        self.nfa.add(s, EPS, frag.start)
        self.nfa.add(s, EPS, e)
        for a in frag.accepts:
            self.nfa.add(a, EPS, e)
        return _Frag(s, frag.accepts + [e])

    def _atom(self) -> _Frag:
        c = self._peek()
        if c == "(":
            self.i += 1
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2
            frag = self._alt()
            if self._peek() != ")":
                raise ValueError("unbalanced paren")
            self.i += 1
            return frag
        if c == "[":
            cs = self._charclass()
            return self._edge(cs)
        if c == ".":
            self.i += 1
            return self._edge(CharSet(frozenset("\n"), negated=True))
        if c == "\\":
            self.i += 1
            return self._edge(self._escape(self.p[self.i - 0]))
        self.i += 1
        return self._edge(CharSet(frozenset(c)))

    def _escape(self, c: str) -> CharSet:
        self.i += 1
        if c == "x":  # \xHH
            hh = self.p[self.i : self.i + 2]
            self.i += 2
            return CharSet(frozenset(chr(int(hh, 16))))
        if c == "u":  # \uHHHH
            hh = self.p[self.i : self.i + 4]
            self.i += 4
            return CharSet(frozenset(chr(int(hh, 16))))
        if c == "d":
            return CharSet(_DIGITS)
        if c == "D":
            return CharSet(_DIGITS, negated=True)
        if c == "w":
            return CharSet(_WORD)
        if c == "W":
            return CharSet(_WORD, negated=True)
        if c == "s":
            return CharSet(_SPACE)
        if c == "S":
            return CharSet(_SPACE, negated=True)
        if c == "n":
            return CharSet(frozenset("\n"))
        if c == "t":
            return CharSet(frozenset("\t"))
        if c == "r":
            return CharSet(frozenset("\r"))
        return CharSet(frozenset(c))

    def _charclass(self) -> CharSet:
        assert self.p[self.i] == "["
        self.i += 1
        negated = False
        if self._peek() == "^":
            negated = True
            self.i += 1
        chars: Set[str] = set()

        def class_atom():
            """One class element: a literal char, or an escape. Returns
            ('char', c) for range-capable single chars or ('set', chars)."""
            c = self.p[self.i]
            if c == "\\":
                self.i += 1
                cs = self._escape(self.p[self.i])
                if cs.negated:
                    raise ValueError("negated escape in class unsupported")
                if len(cs.chars) == 1:
                    return ("char", next(iter(cs.chars)))
                return ("set", cs.chars)
            self.i += 1
            return ("char", c)

        while self._peek() != "]":
            if self._peek() is None:
                raise ValueError("unterminated char class")
            kind, val = class_atom()
            if kind == "set":
                chars |= val
                continue
            if self._peek() == "-" and self.p[self.i + 1 : self.i + 2] not in ("]", ""):
                self.i += 1  # consume '-'
                kind2, hi = class_atom()
                if kind2 != "char":
                    raise ValueError("bad range endpoint")
                chars |= {chr(x) for x in range(ord(val), ord(hi) + 1)}
            else:
                chars.add(val)
        self.i += 1
        return CharSet(frozenset(chars), negated)

    def _edge(self, cs: CharSet) -> _Frag:
        s = self.nfa.new_state()
        e = self.nfa.new_state()
        self.nfa.add(s, cs, e)
        return _Frag(s, [e])


class DFA:
    """transitions: list per state of dict char->state (+ OTHER fallback);
    accept: set of accepting states. State 0 is the start. ``alphabet`` holds
    the explicitly named characters: a named char with no entry is DEAD (it
    must not fall back to the OTHER edge — that edge means "any char NOT in
    the alphabet")."""

    def __init__(self, transitions, accepts, alphabet=frozenset()):
        self.transitions = transitions
        self.accepts = accepts
        self.alphabet = alphabet

    def step(self, state: int, ch: str) -> int:
        """-1 = dead."""
        t = self.transitions[state]
        nxt = t.get(ch)
        if nxt is None:
            if ch in self.alphabet:
                return -1
            nxt = t.get(OTHER, -1)
        return nxt

    def step_str(self, state: int, s: str) -> int:
        for ch in s:
            if state < 0:
                return -1
            state = self.step(state, ch)
        return state

    @property
    def num_states(self):
        return len(self.transitions)


def compile_regex(pattern: str) -> DFA:
    nfa, start, end = _Parser(pattern).parse()

    # Alphabet: all named chars across edges + OTHER
    named: Set[str] = set()
    for edges in nfa.edges:
        for label, _ in edges:
            if isinstance(label, CharSet):
                named |= label.chars
    alphabet = sorted(named)

    def eclosure(states: FrozenSet[int]) -> FrozenSet[int]:
        stack = list(states)
        out = set(states)
        while stack:
            s = stack.pop()
            for label, t in nfa.edges[s]:
                if label is EPS and t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    def move(states: FrozenSet[int], ch: str) -> FrozenSet[int]:
        out = set()
        for s in states:
            for label, t in nfa.edges[s]:
                if isinstance(label, CharSet) and label.matches(ch):
                    out.add(t)
        return frozenset(out)

    start_set = eclosure(frozenset([start]))
    ids: Dict[FrozenSet[int], int] = {start_set: 0}
    work = [start_set]
    transitions: List[Dict[str, int]] = [{}]
    accepts: Set[int] = set()
    if end in start_set:
        accepts.add(0)

    while work:
        cur = work.pop()
        cid = ids[cur]
        symbols = alphabet + [OTHER]
        for ch in symbols:
            nxt = eclosure(move(cur, ch))
            if not nxt:
                continue
            if nxt not in ids:
                ids[nxt] = len(transitions)
                transitions.append({})
                work.append(nxt)
                if end in nxt:
                    accepts.add(ids[nxt])
            transitions[cid][ch] = ids[nxt]
    return DFA(transitions, accepts, frozenset(alphabet))
