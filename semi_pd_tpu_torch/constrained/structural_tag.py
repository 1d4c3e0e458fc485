"""Structural-tag constrained decoding (copy of
semi_pd_tpu/constrained/structural_tag.py, which imports no JAX).

Reference: xgrammar's ``compile_structural_tag`` used by
``srt/constrained/xgrammar_backend.py:162-179`` and exposed through the
OpenAI adapter (``response_format.type == "structural_tag"``,
``srt/openai_api/adapter.py:993-996``) and SamplingParams
(``srt/sampling/sampling_params.py:72``, grammar-queue dispatch
``srt/managers/scheduler.py:806-816``).

Spec (JSON string, same shape the reference accepts)::

    {"structures": [{"begin": "<tool>", "schema": {...}, "end": "</tool>"}],
     "triggers": ["<tool>"]}

Semantics: generation is *unconstrained* until the emitted text contains a
trigger string; at that point the output is forced to complete one of the
structures whose ``begin`` starts with that trigger — the remainder of
``begin``, a JSON body constrained by ``schema``, then the literal ``end``
— after which scanning resumes (structures may repeat). EOS is allowed only
outside a structure.

Implementation: a character-level automaton composed from pieces this repo
already has —

- free mode is an Aho-Corasick automaton over the trigger strings (so a
  trigger straddling token boundaries is still detected),
- each trigger-completing trie node owns a continuation DFA compiled with
  ``regex_dfa.compile_regex`` from ``escape(begin-remainder) +
  schema_to_regex(schema) + escape(end)`` (alternation over all structures
  the node's matched triggers map to),
- completing a continuation returns to the free-mode root ("greedy exit":
  if a schema could itself contain the ``end`` literal inside a string
  value, the shortest completion wins — the one ambiguity a PDA could
  track that a DFA composition cannot; detected at compile time with a
  loud warning, see ``_check_greedy_exit_ambiguity``).

The class exposes the ``regex_dfa.DFA`` stepping interface
(``step``/``step_str``/``accepts`` with ``in``) so ``grammar.TokenDFA``
lifts it to token-level masks unchanged.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

from semi_pd_tpu_torch.constrained.json_schema import schema_to_regex
from semi_pd_tpu_torch.constrained.regex_dfa import compile_regex


class _TrieNode:
    __slots__ = ("children", "fail", "path", "matched")

    def __init__(self, path: str):
        self.children: Dict[str, int] = {}
        self.fail: int = 0
        self.path = path
        self.matched: List[str] = []  # triggers that are suffixes of path


def _build_trie(triggers: List[str]) -> List[_TrieNode]:
    nodes = [_TrieNode("")]
    for t in triggers:
        cur = 0
        for ch in t:
            nxt = nodes[cur].children.get(ch)
            if nxt is None:
                nodes.append(_TrieNode(nodes[cur].path + ch))
                nxt = len(nodes) - 1
                nodes[cur].children[ch] = nxt
            cur = nxt
        nodes[cur].matched.append(t)
    # BFS failure links; propagate matched sets down the fail chain.
    order: List[int] = []
    for ch, c in nodes[0].children.items():
        nodes[c].fail = 0
        order.append(c)
    i = 0
    while i < len(order):
        u = order[i]
        i += 1
        for ch, c in nodes[u].children.items():
            f = nodes[u].fail
            while f and ch not in nodes[f].children:
                f = nodes[f].fail
            nodes[c].fail = nodes[f].children.get(ch, 0)
            if nodes[c].fail == c:  # root self-edge guard
                nodes[c].fail = 0
            nodes[c].matched = nodes[c].matched + nodes[nodes[c].fail].matched
            order.append(c)
    return nodes


class _Accepts:
    """`state in accepts` ⇔ the state is in free mode (EOS legal there)."""

    def __init__(self, owner: "StructuralTagDFA"):
        self._owner = owner

    def __contains__(self, state: int) -> bool:
        return self._owner.is_free(state)


class StructuralTagDFA:
    def __init__(self, spec: str):
        tag = json.loads(spec)
        structures = tag.get("structures") or []
        triggers = [t for t in (tag.get("triggers") or []) if t]
        if not structures:
            raise ValueError("structural_tag needs at least one structure")
        if not triggers:
            raise ValueError("structural_tag needs at least one trigger")
        for s in structures:
            if not s.get("begin") or not s.get("end"):
                raise ValueError("structure begin/end must be non-empty")
            if not any(s["begin"].startswith(t) for t in triggers):
                raise ValueError(
                    f"structure begin {s['begin']!r} matches no trigger")

        self._trie = _build_trie(triggers)
        # Per trie node with matched triggers: the continuation DFA over
        # begin-remainder + schema + end, alternated across all structures
        # any matched trigger maps to.
        self._cont = {}
        for nid, node in enumerate(self._trie):
            if not node.matched:
                continue
            alts = []
            for t in node.matched:
                for s in structures:
                    if not s["begin"].startswith(t):
                        continue
                    schema = s.get("schema")
                    body = ("(?:" + schema_to_regex(schema) + ")"
                            if schema is not None else "")
                    alts.append(re.escape(s["begin"][len(t):]) + body
                                + re.escape(s["end"]))
            if not alts:
                continue
            self._cont[nid] = compile_regex("(?:" + "|".join(alts) + ")"
                                            if len(alts) > 1 else alts[0])
        for s in structures:
            self._check_greedy_exit_ambiguity(s)
        # States: interned (kind, a, b) tuples. 0 = free root.
        self._states: List[Tuple[str, int, int]] = []
        self._ids: Dict[Tuple[str, int, int], int] = {}
        self._step_memo: Dict[Tuple[int, str], int] = {}
        self._intern(("f", 0, 0))
        self.accepts = _Accepts(self)

    def _check_greedy_exit_ambiguity(self, s: dict) -> None:
        """Greedy exit takes the SHORTEST accepting completion. If the
        literal ``end`` string is matchable *inside* the schema body (e.g. a
        free-form string value can contain "</tool>"), the automaton leaves
        the structure at the first occurrence — diverging from xgrammar's
        PDA semantics. Detect that at compile time (DFA reachability: some
        live schema state survives stepping every char of ``end``) and warn
        loudly instead of relying on a docstring note."""
        schema = s.get("schema")
        if schema is None:
            return
        end = s["end"]
        body = compile_regex("(?:" + schema_to_regex(schema) + ")")
        # Reachable = all states of the compiled DFA (compile_regex only
        # materializes reachable states); a state is ambiguity-evidence if
        # stepping the full end literal from it stays alive or accepts.
        for st in range(body.num_states):
            if body.step_str(st, end) >= 0:
                import logging

                logging.getLogger(__name__).warning(
                    "structural_tag: end literal %r is matchable inside the "
                    "schema body of structure %r; greedy exit will close the "
                    "structure at the FIRST occurrence of %r, diverging from "
                    "xgrammar PDA semantics. Constrain the schema's string "
                    "values (e.g. pattern excluding %r) to avoid this.",
                    end, s.get("begin"), end, end)
                return

    def _intern(self, key: Tuple[str, int, int]) -> int:
        sid = self._ids.get(key)
        if sid is None:
            sid = len(self._states)
            self._states.append(key)
            self._ids[key] = sid
        return sid

    def is_free(self, state: int) -> bool:
        return 0 <= state < len(self._states) and self._states[state][0] == "f"

    def _enter(self, nid: int) -> int:
        """Transition taken the instant a trigger completes at trie node nid."""
        cont = self._cont.get(nid)
        if cont is None:  # trigger with no mapped structure: stay free
            return self._intern(("f", nid, 0))
        if 0 in cont.accepts:  # degenerate empty continuation
            return 0
        return self._intern(("s", nid, 0))

    def step(self, state: int, ch: str) -> int:
        memo = self._step_memo.get((state, ch))
        if memo is not None:
            return memo
        kind, a, b = self._states[state]
        if kind == "f":
            trie = self._trie
            u = a
            while u and ch not in trie[u].children:
                u = trie[u].fail
            u = trie[u].children.get(ch, 0)
            out = self._enter(u) if trie[u].matched else self._intern(("f", u, 0))
        else:
            cont = self._cont[a]
            ns = cont.step(b, ch)
            if ns < 0:
                out = -1
            elif ns in cont.accepts:
                out = 0  # structure complete -> free root (greedy exit)
            else:
                out = self._intern(("s", a, ns))
        self._step_memo[(state, ch)] = out
        return out

    def step_str(self, state: int, s: str) -> int:
        for ch in s:
            if state < 0:
                return -1
            state = self.step(state, ch)
        return state

    @property
    def num_states(self) -> int:
        return len(self._states)


def compile_structural_tag(spec: str) -> StructuralTagDFA:
    return StructuralTagDFA(spec)
