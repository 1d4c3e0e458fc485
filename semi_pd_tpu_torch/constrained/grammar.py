"""Token-level grammar matching over a character DFA (copy of
semi_pd_tpu/constrained/grammar.py, which imports no JAX).

Reference: srt/constrained/base_grammar_backend.py:30-110 — the vocab-mask
protocol every backend implements (allocate/fill/apply mask + move state +
jump-forward). Here the backend is our own DFA (regex_dfa.py); this module
lifts it from characters to tokenizer tokens:

- ``TokenDFA`` precomputes, per DFA state (lazily, cached), the set of vocab
  tokens whose *full character sequence* keeps the DFA alive, plus the
  resulting state (token-level transition).
- ``GrammarMatcher`` is the per-request cursor: vocab mask for the sampler,
  advance on the sampled token, jump-forward detection (single-allowed-token
  chains can be emitted without model forwards — reference
  outlines jump-forward, base_grammar_backend.py:187).
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from semi_pd_tpu_torch.constrained.json_schema import schema_to_regex
from semi_pd_tpu_torch.constrained.regex_dfa import DFA, compile_regex

logger = logging.getLogger(__name__)


class TokenDFA:
    def __init__(self, dfa: DFA, token_strs: List[str], eos_ids: List[int]):
        self.dfa = dfa
        self.token_strs = token_strs
        self.vocab = len(token_strs)
        self.eos_ids = [e for e in eos_ids if e < self.vocab]
        # state -> (mask [V] bool, next_state [V] int32)
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def state_table(self, state: int) -> Tuple[np.ndarray, np.ndarray]:
        hit = self._cache.get(state)
        if hit is not None:
            return hit
        mask = np.zeros(self.vocab, dtype=bool)
        nxt = np.full(self.vocab, -1, dtype=np.int32)
        step_str = self.dfa.step_str
        for tid, s in enumerate(self.token_strs):
            if not s:
                continue
            ns = step_str(state, s)
            if ns >= 0:
                mask[tid] = True
                nxt[tid] = ns
        # EOS allowed exactly in accepting states
        if state in self.dfa.accepts:
            for e in self.eos_ids:
                mask[e] = True
        self._cache[state] = (mask, nxt)
        return mask, nxt

    def is_accepting(self, state: int) -> bool:
        return state in self.dfa.accepts


class GrammarMatcher:
    """Per-request grammar cursor (reference: the per-req grammar objects
    held on Req and queried by the scheduler, scheduler.py:1424)."""

    def __init__(self, tdfa: TokenDFA):
        self.tdfa = tdfa
        self.state = 0
        self.finished = False

    def vocab_mask(self) -> np.ndarray:
        mask, _ = self.tdfa.state_table(self.state)
        return mask

    def accept_token(self, tid: int) -> bool:
        if self.finished:
            return True
        if tid in self.tdfa.eos_ids:
            ok = self.tdfa.is_accepting(self.state)
            self.finished = True
            return ok
        mask, nxt = self.tdfa.state_table(self.state)
        if tid >= len(mask) or not mask[tid]:
            return False
        self.state = int(nxt[tid])
        return True

    def is_terminated(self) -> bool:
        return self.finished or self.tdfa.is_accepting(self.state)

    def jump_forward_tokens(self, limit: int = 64) -> list:
        """Chain of FORCED tokens from the current state: while exactly one
        token is grammatically allowed, it can be emitted without a model
        forward (reference: outlines jump-forward, base_grammar_backend.py
        try_jump_forward). Pure lookahead — does not advance this matcher."""
        out = []
        state, finished = self.state, self.finished
        while not finished and len(out) < limit:
            mask, nxt = self.tdfa.state_table(state)
            allowed = np.flatnonzero(mask)
            if len(allowed) != 1:
                break
            tid = int(allowed[0])
            out.append(tid)
            if tid in self.tdfa.eos_ids:
                finished = True
            else:
                state = int(nxt[tid])
        return out


class GrammarCompiler:
    """Tokenizer-bound compiler with caching (reference: backend cache in
    base_grammar_backend.py)."""

    def __init__(self, tokenizer, eos_ids: List[int],
                 json_whitespace_pattern: Optional[str] = None,
                 disk_cache_dir: Optional[str] = None):
        self.eos_ids = eos_ids
        self._cache: Dict[Tuple[str, str], TokenDFA] = {}
        self.token_strs = _token_strings(tokenizer)
        self._vocab_trie = None  # built on first ebnf grammar, then shared
        self.json_whitespace_pattern = json_whitespace_pattern
        # DFA disk cache (role of the reference's outlines disk cache,
        # --disable-outlines-disk-cache): regex->DFA subset construction for
        # a deep JSON schema can take seconds; cache keyed by pattern hash.
        self.disk_cache_dir = disk_cache_dir

    def _compile_regex(self, pattern: str) -> DFA:
        if not self.disk_cache_dir:
            return compile_regex(pattern)
        import hashlib
        import os
        import pickle

        key = hashlib.sha256(pattern.encode()).hexdigest()[:32]
        path = os.path.join(self.disk_cache_dir, f"dfa_{key}.pkl")
        try:
            with open(path, "rb") as f:
                t, a, al = pickle.load(f)
            return DFA(t, a, al)
        except (OSError, pickle.PickleError, ValueError, EOFError):
            pass
        dfa = compile_regex(pattern)
        try:
            os.makedirs(self.disk_cache_dir, exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump((dfa.transitions, dfa.accepts, dfa.alphabet), f)
            os.replace(tmp, path)  # atomic vs concurrent servers
        except OSError as e:
            logger.warning("grammar disk cache write failed: %s", e)
        return dfa

    def compile(self, kind: str, spec: str):
        key = (kind, spec)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if kind == "regex":
            pattern = spec
        elif kind == "json_schema":
            import json as _json

            pattern = schema_to_regex(
                _json.loads(spec),
                whitespace_pattern=self.json_whitespace_pattern)
        elif kind == "structural_tag":
            from semi_pd_tpu_torch.constrained.structural_tag import (
                compile_structural_tag,
            )

            tdfa = TokenDFA(compile_structural_tag(spec), self.token_strs,
                            self.eos_ids)
            self._cache[key] = tdfa
            return tdfa
        elif kind == "ebnf":
            from semi_pd_tpu_torch.constrained.ebnf import TokenPDA, build_vocab_trie

            if self._vocab_trie is None:
                self._vocab_trie = build_vocab_trie(self.token_strs)
            tpda = TokenPDA(
                spec, self.token_strs, self.eos_ids, vocab_trie=self._vocab_trie
            )
            self._cache[key] = tpda
            return tpda
        else:
            raise ValueError(f"unknown grammar kind {kind}")
        dfa = self._compile_regex(pattern)
        tdfa = TokenDFA(dfa, self.token_strs, self.eos_ids)
        self._cache[key] = tdfa
        return tdfa

    def matcher(self, kind: str, spec: str) -> GrammarMatcher:
        return GrammarMatcher(self.compile(kind, spec))


def _token_strings(tokenizer) -> List[str]:
    """Decoded text of each vocab id (what appending that token adds)."""
    vocab = tokenizer.vocab_size if hasattr(tokenizer, "vocab_size") else len(tokenizer)
    try:
        n = len(tokenizer)
    except TypeError:
        n = vocab
    strs = []
    specials = set(getattr(tokenizer, "all_special_ids", []) or [])
    # convert_ids_to_tokens + byte decoder is faster; decode() is correct and
    # simple — vocabs up to 128k take a few seconds once per server.
    for tid in range(n):
        if tid in specials:
            strs.append("")
            continue
        try:
            strs.append(tokenizer.decode([tid]))
        except Exception:  # noqa: BLE001
            strs.append("")
    return strs
