"""EBNF (GBNF-style) grammars → pushdown-automaton token masks (copy of
semi_pd_tpu/constrained/ebnf.py, which imports no JAX).

Closes the grammar-kind set next to regex_dfa.py and json_schema.py
(reference: srt/constrained/base_grammar_backend.py:30-110 dispatches
json/regex/ebnf; the ebnf kind goes to the xgrammar backend, :183). The
reference delegates to the xgrammar wheel; none of those packages exist
here, so this is a from-scratch context-free engine speaking the same
protocol the scheduler already uses (per-state vocab mask + state advance,
grammar.py).

Syntax (the GBNF dialect xgrammar/llama.cpp popularized):

    root  ::= ws expr
    expr  ::= term (("+" | "-") ws term)*
    num   ::= [0-9]+ ws
    ws    ::= [ \\t]*

- rules ``name ::= body`` (first rule or ``root`` is the start symbol)
- quoted literals ``"..."`` with escapes (\\n \\t \\r \\\\ \\" \\xHH \\uHHHH)
- char classes ``[a-z0-9]`` / ``[^...]`` with ranges and the same escapes
- grouping ``(...)``, alternation ``|``, quantifiers ``* + ? {m} {m,n} {m,}``
- ``#`` comments

Execution model: the grammar is normalized to sequences of symbols
(terminal CharSet | rule ref). A matcher *state* is a set of PDA
configurations, each a (persistent, hashable) stack of pending symbols;
char transitions pop a matching terminal and epsilon-close rule expansions.
States are interned to ints so the token-level layer (TokenPDA) can cache
per-state masks. Token masks are computed by walking a trie of the
tokenizer vocabulary against the PDA — only prefixes the grammar can
accept are explored, so mask cost scales with the grammar's branching, not
the vocab size.

Left recursion (direct or via nullable prefixes) makes naive top-down
expansion diverge; it is detected at compile time and rejected with a
clear error (same documented restriction as llama.cpp GBNF; the reference
xgrammar handles it via Earley — rewrite such rules right-recursively).
"""

from __future__ import annotations

import logging
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from semi_pd_tpu_torch.constrained.regex_dfa import CharSet

logger = logging.getLogger(__name__)

_SPACE = " \t\r\n"


class Rule:
    """A nonterminal: list of alternatives, each a tuple of symbols.
    Symbols are CharSet (terminal) or Rule (reference). Rules are compared
    by identity (each grammar interns its symbol objects once)."""

    __slots__ = ("name", "alts")

    def __init__(self, name: str):
        self.name = name
        self.alts: List[Tuple[object, ...]] = []

    def __repr__(self):
        return f"Rule({self.name})"


class _EBNFParser:
    def __init__(self, text: str):
        self.text = text
        self.i = 0
        self.rules: Dict[str, Rule] = {}
        self._aux = 0

    # ---------------------------------------------------------- lexing
    def _ws(self, newlines: bool = True) -> None:
        t, n = self.text, len(self.text)
        while self.i < n:
            c = t[self.i]
            if c == "#":
                while self.i < n and t[self.i] != "\n":
                    self.i += 1
            elif c in _SPACE and (newlines or c not in "\r\n"):
                self.i += 1
            else:
                return

    def _peek(self) -> Optional[str]:
        return self.text[self.i] if self.i < len(self.text) else None

    def _name(self) -> str:
        j = self.i
        while self.i < len(self.text) and (
            self.text[self.i].isalnum() or self.text[self.i] in "_-"
        ):
            self.i += 1
        if j == self.i:
            raise ValueError(f"expected rule name at offset {j}")
        return self.text[j : self.i]

    # ---------------------------------------------------------- grammar
    def parse(self) -> Tuple[Dict[str, Rule], str]:
        start = None
        while True:
            self._ws()
            if self._peek() is None:
                break
            name = self._name()
            self._ws()
            if self.text[self.i : self.i + 3] == "::=":
                self.i += 3
            elif self._peek() == "=":
                self.i += 1
            else:
                raise ValueError(f"expected '::=' after rule {name!r}")
            body = self._alternation(name)
            rule = self._rule(name)
            rule.alts.extend(body)
            if start is None:
                start = name
        if start is None:
            raise ValueError("empty grammar")
        if "root" in self.rules:
            start = "root"
        for r in self.rules.values():
            if not r.alts:
                raise ValueError(f"rule {r.name!r} referenced but never defined")
        return self.rules, start

    def _rule(self, name: str) -> Rule:
        r = self.rules.get(name)
        if r is None:
            r = self.rules[name] = Rule(name)
        return r

    def _aux_rule(self, base: str) -> Rule:
        self._aux += 1
        r = Rule(f"{base}${self._aux}")
        self.rules[r.name] = r
        return r

    def _alternation(self, ctx: str) -> List[Tuple[object, ...]]:
        alts = [self._sequence(ctx)]
        while True:
            self._ws(newlines=False)
            if self._peek() == "|":
                self.i += 1
                alts.append(self._sequence(ctx))
            elif self._peek() in ("\n", "\r"):
                # newline ends the rule unless the next line continues with |
                j = self.i
                self._ws()
                if self._peek() == "|":
                    self.i += 1
                    alts.append(self._sequence(ctx))
                else:
                    self.i = j
                    return alts
            else:
                return alts

    def _sequence(self, ctx: str) -> Tuple[object, ...]:
        syms: List[object] = []
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c is None or c in "|)\n\r":
                return tuple(syms)
            syms.extend(self._item(ctx))

    def _item(self, ctx: str) -> Tuple[object, ...]:
        base = self._atom(ctx)
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c == "*":
                self.i += 1
                base = (self._star(ctx, base),)
            elif c == "+":
                self.i += 1
                rep = self._star(ctx, base)
                base = base + (rep,)
            elif c == "?":
                self.i += 1
                aux = self._aux_rule(ctx)
                aux.alts = [base, ()]
                base = (aux,)
            elif c == "{":
                j = self.text.index("}", self.i)
                spec = self.text[self.i + 1 : j]
                self.i = j + 1
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s) if lo_s.strip() else 0
                    hi = int(hi_s) if hi_s.strip() else None
                else:
                    lo = hi = int(spec)
                parts: Tuple[object, ...] = base * lo
                if hi is None:
                    parts = parts + (self._star(ctx, base),)
                else:
                    opt: Tuple[object, ...] = ()
                    for _ in range(hi - lo):
                        aux = self._aux_rule(ctx)
                        aux.alts = [base + opt, ()]
                        opt = (aux,)
                    parts = parts + opt
                base = parts
            else:
                return base

    def _star(self, ctx: str, body: Tuple[object, ...]) -> Rule:
        """body* as a right-recursive aux rule: R ::= body R | ε"""
        aux = self._aux_rule(ctx)
        aux.alts = [body + (aux,), ()]
        return aux

    def _atom(self, ctx: str) -> Tuple[object, ...]:
        c = self._peek()
        if c == "(":
            self.i += 1
            alts = self._alternation(ctx)
            self._ws()
            if self._peek() != ")":
                raise ValueError(f"unbalanced '(' near offset {self.i}")
            self.i += 1
            if len(alts) == 1:
                return alts[0]
            aux = self._aux_rule(ctx)
            aux.alts = alts
            return (aux,)
        if c == '"':
            return tuple(CharSet(frozenset(ch)) for ch in self._quoted())
        if c == "[":
            return (self._charclass(),)
        name = self._name()
        return (self._rule(name),)

    def _quoted(self) -> str:
        assert self.text[self.i] == '"'
        self.i += 1
        out = []
        while True:
            c = self._peek()
            if c is None:
                raise ValueError("unterminated string literal")
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                self.i += 1
                out.append(self._escape_char())
            else:
                out.append(c)
                self.i += 1

    def _escape_char(self) -> str:
        c = self.text[self.i]
        self.i += 1
        if c == "n":
            return "\n"
        if c == "t":
            return "\t"
        if c == "r":
            return "\r"
        if c == "x":
            hh = self.text[self.i : self.i + 2]
            self.i += 2
            return chr(int(hh, 16))
        if c == "u":
            hh = self.text[self.i : self.i + 4]
            self.i += 4
            return chr(int(hh, 16))
        return c  # \\ \" \] \- etc.

    def _charclass(self) -> CharSet:
        assert self.text[self.i] == "["
        self.i += 1
        negated = False
        if self._peek() == "^":
            negated = True
            self.i += 1
        chars: Set[str] = set()
        while self._peek() != "]":
            if self._peek() is None:
                raise ValueError("unterminated char class")
            if self._peek() == "\\":
                self.i += 1
                lo = self._escape_char()
            else:
                lo = self.text[self.i]
                self.i += 1
            if self._peek() == "-" and self.text[self.i + 1 : self.i + 2] not in ("]", ""):
                self.i += 1
                if self._peek() == "\\":
                    self.i += 1
                    hi = self._escape_char()
                else:
                    hi = self.text[self.i]
                    self.i += 1
                chars |= {chr(x) for x in range(ord(lo), ord(hi) + 1)}
            else:
                chars.add(lo)
        self.i += 1
        return CharSet(frozenset(chars), negated)


def parse_ebnf(text: str) -> Tuple[Dict[str, Rule], str]:
    rules, start = _EBNFParser(text).parse()
    _reject_left_recursion(rules)
    return rules, start


def _reject_left_recursion(rules: Dict[str, Rule]) -> None:
    """Top-down expansion diverges on left recursion; detect it statically
    (leftmost-reachability through nullable prefixes) and raise."""
    nullable: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for r in rules.values():
            if r.name in nullable:
                continue
            for alt in r.alts:
                if all(isinstance(s, Rule) and s.name in nullable for s in alt):
                    nullable.add(r.name)
                    changed = True
                    break
    # left_refs[A] = rules that can appear leftmost in an expansion of A
    left: Dict[str, Set[str]] = {n: set() for n in rules}
    for r in rules.values():
        for alt in r.alts:
            for s in alt:
                if not isinstance(s, Rule):
                    break
                left[r.name].add(s.name)
                if s.name not in nullable:
                    break
    # transitive closure; self-loop = left recursion
    for name in rules:
        seen: Set[str] = set()
        work = list(left[name])
        while work:
            n = work.pop()
            if n == name:
                raise ValueError(
                    f"rule {name!r} is left-recursive; rewrite it "
                    "right-recursively (e.g. expr ::= term ((\"+\") term)*)"
                )
            if n in seen:
                continue
            seen.add(n)
            work.extend(left[n])


# ===================================================================== PDA

_MAX_CLOSURE = 100_000  # safety valve against pathological expansion


def _closure(configs: FrozenSet[Tuple[object, ...]]) -> FrozenSet[Tuple[object, ...]]:
    """Expand every config whose stack top is a rule until all tops are
    terminals (or the stack is empty = accepting)."""
    out: Set[Tuple[object, ...]] = set()
    work = list(configs)
    seen: Set[Tuple[object, ...]] = set(work)
    n = 0
    while work:
        n += 1
        if n > _MAX_CLOSURE:
            raise ValueError("grammar expansion exploded (recursion too deep?)")
        cfg = work.pop()
        if not cfg or not isinstance(cfg[0], Rule):
            out.add(cfg)
            continue
        rule, rest = cfg[0], cfg[1:]
        for alt in rule.alts:
            nxt = alt + rest
            if nxt not in seen:
                seen.add(nxt)
                work.append(nxt)
    return frozenset(out)


def _step_char(
    configs: FrozenSet[Tuple[object, ...]], ch: str
) -> FrozenSet[Tuple[object, ...]]:
    out = set()
    for cfg in configs:
        if cfg and isinstance(cfg[0], CharSet) and cfg[0].matches(ch):
            out.add(cfg[1:])
    return _closure(frozenset(out)) if out else frozenset()


class _TrieNode:
    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: Dict[str, _TrieNode] = {}
        self.token_ids: List[int] = []


def build_vocab_trie(token_strs: List[str]) -> _TrieNode:
    root = _TrieNode()
    for tid, s in enumerate(token_strs):
        if not s:
            continue
        node = root
        for ch in s:
            nxt = node.children.get(ch)
            if nxt is None:
                nxt = node.children[ch] = _TrieNode()
            node = nxt
        node.token_ids.append(tid)
    return root


class TokenPDA:
    """Token-level view of the grammar PDA — same surface as
    grammar.TokenDFA: ``state_table(state) -> (mask[V] bool, next[V] i32)``,
    ``is_accepting(state)``, ``eos_ids``. States are interned config-sets."""

    def __init__(self, ebnf_text: str, token_strs: List[str], eos_ids: List[int],
                 vocab_trie: Optional[_TrieNode] = None):
        rules, start = parse_ebnf(ebnf_text)
        self.vocab = len(token_strs)
        self.eos_ids = [e for e in eos_ids if e < self.vocab]
        self.trie = vocab_trie if vocab_trie is not None else build_vocab_trie(token_strs)
        self._states: List[FrozenSet[Tuple[object, ...]]] = []
        self._ids: Dict[FrozenSet[Tuple[object, ...]], int] = {}
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        s0 = _closure(frozenset([(rules[start],)]))
        assert self._intern(s0) == 0

    def _intern(self, configs: FrozenSet[Tuple[object, ...]]) -> int:
        sid = self._ids.get(configs)
        if sid is None:
            sid = len(self._states)
            self._ids[configs] = sid
            self._states.append(configs)
        return sid

    def is_accepting(self, state: int) -> bool:
        return () in self._states[state]

    def state_table(self, state: int) -> Tuple[np.ndarray, np.ndarray]:
        hit = self._cache.get(state)
        if hit is not None:
            return hit
        mask = np.zeros(self.vocab, dtype=bool)
        nxt = np.full(self.vocab, -1, dtype=np.int32)
        # Depth-first walk of (vocab-trie node × PDA config-set); dead
        # config-sets prune whole subtries, so cost tracks the grammar's
        # branching factor rather than |V|.
        work: List[Tuple[_TrieNode, FrozenSet]] = [(self.trie, self._states[state])]
        while work:
            node, cfgs = work.pop()
            if node.token_ids:
                sid = self._intern(cfgs)
                for tid in node.token_ids:
                    mask[tid] = True
                    nxt[tid] = sid
            for ch, child in node.children.items():
                nc = _step_char(cfgs, ch)
                if nc:
                    work.append((child, nc))
        if self.is_accepting(state):
            for e in self.eos_ids:
                mask[e] = True
        self._cache[state] = (mask, nxt)
        return mask, nxt
