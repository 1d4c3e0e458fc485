"""The port's constrained and penalized serving against the JAX Engine on
the CPU: the same weights (the JAX engine's random parameters carried into
the port with ``load_jax_params``), the same character tokenizer object
given to both engines' grammar compilers, and the same greedy requests,
colocated and semi-PD (a fixed prefill chunk budget, so both schedule
alike):

- penalties (repetition, frequency, presence);
- a regex, a JSON schema, an EBNF grammar and a structural tag, each with
  jump-forward on and off;
- an OpenAI-style ``logit_bias``, and a ``disallow_tokens`` processor over a
  regex (the bias path, the grammar's bans folded in as -inf);
- top-k log-probs;
- one regex request in an EAGLE and in an NGRAM serve: while it runs, every
  round falls back to a plain decode step, as in JAX.

Each case serves its requests in one batch with a plain request beside
them. Token lists must be equal, as must the jump-forward counts and, under
speculation, the rounds and accepted drafts; log-probs and top-k values
within 1e-4 (float32), top-k ids equal. Grammar outputs that finished are
checked against their grammar. Every engine pair is built once per module
and given fresh schedulers per case.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.scheduler import Scheduler as JaxScheduler
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.scheduler import Scheduler
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

TOL = 1e-4


class CharTokenizer:
    """A tokenizer object over ``n`` ids: id i < 95 is the printable
    character chr(32 + i), ``eos_token_id`` decodes to nothing, and the ids
    above it are 2-3 character strings over a small alphabet drawn from a
    seed (multi-character tokens, as a real vocabulary has)."""

    ALPHABET = 'abcxyz0123456789{}":, ['

    def __init__(self, n: int = 512, eos: int = 95, seed: int = 5):
        self.vocab_size = n
        self.eos_token_id = eos
        self.all_special_ids = [eos]
        rng = np.random.default_rng(seed)
        strs = [chr(32 + i) for i in range(min(n, 95))]
        while len(strs) < n:
            k = int(rng.integers(2, 4))
            strs.append("".join(self.ALPHABET[j]
                                for j in rng.integers(0, len(self.ALPHABET), k)))
        strs[eos] = ""
        self.strs = strs

    def __len__(self):
        return self.vocab_size

    def decode(self, ids, **kw):
        return "".join(self.strs[i] for i in ids if 0 <= i < self.vocab_size)


CFG = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
           intermediate_size=512, num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=2, head_dim=64, max_position_embeddings=512,
           context_length=512, rope_theta=10000.0, dtype="float32")
SERVE = dict(page_size=16, max_total_tokens=4096, chunked_prefill_size=64,
             decode_bs_buckets=[4], disable_outlines_disk_cache=True)

REGEX = r"(ab|cd)=[0-9]{2,4};(x|yz)"
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"},
                         "tag": {"type": "string", "enum": ["xy", "zz"]},
                         "n": {"type": "integer"}},
          "required": ["ok", "tag", "n"]}
EBNF = 'root ::= "sum(" num ("," num){0,2} ")=" num\nnum ::= [0-9]{1,3}\n'


def _prompts(vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in (20, 70, 9)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the many small ops from
    stalling when the test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg=CFG, serve=SERVE, tok=None, predictive=None):
    """A JAX and a port Engine on the same weights and tokenizer object
    (``predictive``: turns the JAX numpy trees into predictive ones first,
    the speculating pairs)."""
    tok = tok or CharTokenizer(cfg["vocab_size"])
    # the JAX Engine serves a processor other than logit_bias only on request;
    # the port serves every registered one
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               enable_custom_logit_processor=True, **serve),
                     model_config=JaxModelConfig(**cfg), tokenizer=tok)
    teng = Engine(ServerArgs(random_weights=True, device="cpu", **serve), ModelConfig(**cfg),
                  tokenizer=tok, device="cpu")
    jr, tr = jeng.runner, teng.runner
    params = jax.tree.map(np.asarray, jr.params)
    if predictive is not None:
        draft = jax.tree.map(np.asarray, jr.draft_params) if jr.draft_model else None
        predictive(params, draft)
        if draft is not None:
            jr.draft_params = jax.tree.map(jnp.asarray, draft)
            tr.draft_model.load_jax_params(draft)
    jr.params = jax.tree.map(jnp.asarray, params)
    tr.model.load_jax_params(params)
    return jeng, teng, tok


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _reset(pair, semi_pd, jump_forward=True):
    """Fresh schedulers on both engines over the same runners and compiled
    programs: colocated or semi-PD, jump-forward on or off."""
    jeng, teng = pair[:2]
    for eng, sched in ((jeng, JaxScheduler), (teng, Scheduler)):
        assert eng.flush_cache()  # idle, no leak
        args = dataclasses.replace(eng.server_args, enable_semi_pd=semi_pd,
                                   prefill_chunk_budget_tokens=32 if semi_pd else None,
                                   disable_jump_forward=not jump_forward)
        eng.server_args, eng.scheduler = args, sched(args, eng.runner)
    return pair


def serve(eng, items, port: bool):
    """Serve ``items``, (input_ids, sampling dict, top_logprobs_num), in
    one batch, each with its own sampling parameters (as concurrent
    clients send them), with log-probs."""
    SP = SamplingParams if port else JaxSamplingParams
    reqs = [eng.make_request(input_ids=ids, sampling_params=SP(**sp), return_logprob=True,
                             top_logprobs_num=k) for ids, sp, k in items]
    with eng._lock:
        for r in reqs:
            eng.scheduler.add_request(r)
        eng._run_until_done(reqs)
    return [eng._to_output(r) for r in reqs]


def assert_same(jout, tout):
    """Tokens equal; log-probs and top-k values within TOL, ids equal."""
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
    for j, t in zip(jout, tout):
        jm, tm = j["meta_info"], t["meta_info"]
        assert tm["finish_reason"] == jm["finish_reason"]
        np.testing.assert_allclose(tm["output_logprobs"], jm["output_logprobs"], atol=TOL)
        if jm["output_top_logprobs"] is None:
            assert tm["output_top_logprobs"] is None
            continue
        assert len(tm["output_top_logprobs"]) == len(jm["output_top_logprobs"]) > 0
        for (tv, ti), (jv, ji) in zip(tm["output_top_logprobs"], jm["output_top_logprobs"]):
            assert ti == ji
            np.testing.assert_allclose(tv, jv, atol=TOL)


def _check_grammar(kind, text, spec):
    if kind == "regex":
        assert re.fullmatch(REGEX, text), text
    elif kind == "json_schema":
        doc = json.loads(text)
        assert set(doc) == {"ok", "tag", "n"} and doc["tag"] in ("xy", "zz"), doc
    elif kind == "ebnf":
        assert re.fullmatch(r"sum\([0-9]{1,3}(,[0-9]{1,3}){0,2}\)=[0-9]{1,3}", text), text


def _free_char(pair):
    """The first character the model emits unconstrained after prompt 0
    (the structural tag's trigger, so that the structure is entered)."""
    jeng, teng, tok = pair
    out = serve(jeng, [(_prompts()[0], dict(max_new_tokens=1, temperature=0.0,
                                              ignore_eos=True), 0)], port=False)
    return tok.decode(out[0]["output_ids"])[:1] or "a"


GRAMMARS = ["regex", "json_schema", "ebnf", "structural_tag"]


@pytest.mark.parametrize("jump_forward", [True, False], ids=["jf", "no_jf"])
@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
@pytest.mark.parametrize("kind", GRAMMARS)
def test_grammar_serving_matches_jax(kind, semi_pd, jump_forward, pair):
    """Two requests under one grammar and a plain one: the JAX Engine's
    tokens and log-probs, jump-forward counts included; finished outputs
    match their grammar."""
    spec = {"regex": REGEX, "json_schema": json.dumps(SCHEMA), "ebnf": EBNF}.get(kind)
    if kind == "structural_tag":
        trig = _free_char(_reset(pair, False))
        spec = json.dumps({"structures": [{"begin": trig + "[", "schema": {"enum": [3, 7]},
                                           "end": "]"}], "triggers": [trig]})
    jeng, teng, tok = _reset(pair, semi_pd, jump_forward)
    p = _prompts()
    sp = dict(max_new_tokens=40, temperature=0.0, **{kind: spec})
    plain = dict(max_new_tokens=12, temperature=0.0, ignore_eos=True)
    items = [(p[0], sp, 0), (p[1], sp, 0), (p[2], plain, 0)]
    jout = serve(jeng, items, port=False)
    tout = serve(teng, items, port=True)
    assert_same(jout, tout)
    assert teng.scheduler.n_jump_tokens == jeng.scheduler.n_jump_tokens
    if not jump_forward:
        assert teng.scheduler.n_jump_tokens == 0
    elif kind != "structural_tag":
        assert teng.scheduler.n_jump_tokens > 0  # each grammar has a forced run
    for o in tout[:2]:
        if o["meta_info"]["finish_reason"] == "stop_token":  # the grammar ended
            _check_grammar(kind, tok.decode(o["output_ids"]), spec)
    assert teng.flush_cache() and jeng.flush_cache()  # check_memory() inside


SAMPLING_CASES = {
    "penalties": (dict(repetition_penalty=1.2, frequency_penalty=0.5,
                       presence_penalty=0.3), 0),
    "logit_bias": (dict(custom_logit_processor="logit_bias",
                        custom_params={"logit_bias": {"17": 6.0, "40": 3.5, "3": -100.0}}), 0),
    "processor_over_grammar": (dict(regex=REGEX, custom_logit_processor="disallow_tokens",
                                    custom_params={"token_ids": [65, 66, 18]}), 0),
    "top_logprobs": (dict(repetition_penalty=1.1), 3),
}


@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
@pytest.mark.parametrize("case", sorted(SAMPLING_CASES))
def test_sampling_serving_matches_jax(case, semi_pd, pair):
    """Penalties, a logit bias, a processor over a grammar (no
    jump-forward: a processor sees every position) and top-k log-probs,
    two requests of the case beside a plain one in one batch: the JAX
    Engine's tokens, log-probs and top-k."""
    jeng, teng, tok = _reset(pair, semi_pd)
    extra, k = SAMPLING_CASES[case]
    p = _prompts(seed=1)
    sp = dict(max_new_tokens=24, temperature=0.0, ignore_eos=True, **extra)
    plain = dict(max_new_tokens=16, temperature=0.0, ignore_eos=True)
    items = [(p[0], sp, k), (p[1], sp, k), (p[2], plain, 0)]
    jout = serve(jeng, items, port=False)
    tout = serve(teng, items, port=True)
    assert_same(jout, tout)
    assert teng.scheduler.n_jump_tokens == jeng.scheduler.n_jump_tokens == 0
    if case == "logit_bias":
        assert 3 not in tout[0]["output_ids"] + tout[1]["output_ids"]
    if case == "processor_over_grammar":
        assert not {65, 66, 18} & set(tout[0]["output_ids"] + tout[1]["output_ids"])
    if case == "top_logprobs":
        assert all(len(v) == k for v, _ in tout[0]["meta_info"]["output_top_logprobs"])
        assert tout[2]["meta_info"]["output_top_logprobs"] is None
    assert teng.flush_cache() and jeng.flush_cache()


@pytest.mark.parametrize("name", ["no_such_processor", "gASV" + "x" * 40])
def test_engine_refuses_an_unregistered_processor(name, pair):
    """The port serves every registered processor with no server option
    (the JAX Engine wants ``enable_custom_logit_processor``); a name that
    is not registered, or a pickled callable, fails at the request."""
    _, teng, _ = pair
    sp = SamplingParams(max_new_tokens=4, custom_logit_processor=name)
    with pytest.raises(ValueError, match="pickled|unknown custom logit processor"):
        teng.make_request([1, 2, 3], sp)
    assert teng.make_request([1, 2, 3], dataclasses.replace(
        sp, custom_logit_processor="thinking_budget")).sampling_params.custom_logit_processor


# ----------------------------------------------------------- speculation
SPEC_CFG = dict(CFG, vocab_size=64, num_attention_heads=8, num_key_value_heads=8)
SPEC_SERVE = dict(page_size=16, max_total_tokens=2048, chunked_prefill_size=32,
                  decode_bs_buckets=[4], disable_outlines_disk_cache=True)
SPEC_ALGOS = {"eagle": dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=3),
              "ngram": dict(speculative_algorithm="NGRAM", speculative_num_draft_tokens=3)}
SPEC_REGEX = r"[A-F]{2}=[0-9]{2,3};"


def _predictive(params, draft):
    """Make EAGLE accept drafts (in place): the target's final norm ones,
    the draft's fc passing the token embedding through."""
    H = SPEC_CFG["hidden_size"]
    params["final_norm"] = np.ones_like(params["final_norm"])
    if draft is not None:
        fc = np.array(draft["fc"]["w"])
        fc[:H] = np.eye(H, dtype=fc.dtype)
        fc[H:] *= 0.01
        draft["fc"]["w"] = fc


@pytest.fixture(scope="module")
def spec_pairs():
    cache = {}

    def get(algo):
        if algo not in cache:
            cache[algo] = _pair(SPEC_CFG, dict(SPEC_SERVE, **SPEC_ALGOS[algo]),
                                CharTokenizer(64, eos=63), predictive=_predictive)
        return cache[algo]

    yield get
    cache.clear()


@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
@pytest.mark.parametrize("algo", sorted(SPEC_ALGOS))
def test_speculating_serve_falls_back_for_a_constrained_request(algo, semi_pd, spec_pairs):
    """A regex request beside two plain ones under EAGLE and NGRAM: while
    it runs every round falls back to a plain decode step, after it the
    rounds resume; tokens, rounds and accepted drafts as the JAX
    Engine's."""
    pair = spec_pairs(algo)
    jeng, teng, tok = _reset(pair, semi_pd)
    rng = np.random.default_rng(7)
    p = [rng.integers(0, 63, size=n).tolist() for n in (10, 23, 40)]
    plain = dict(max_new_tokens=20, temperature=0.0, ignore_eos=True)
    con = dict(max_new_tokens=8, temperature=0.0, regex=SPEC_REGEX)
    items = [(p[0], con, 0), (p[1], plain, 0), (p[2], plain, 0)]
    jout = serve(jeng, items, port=False)
    decode0 = teng.runner.step_counts["decode"]
    tout = serve(teng, items, port=True)
    assert [o["output_ids"] for o in tout] == [o["output_ids"] for o in jout]
    s, js = teng.scheduler, jeng.scheduler
    assert (s.n_spec_steps, s.n_spec_accepted) == (js.n_spec_steps, js.n_spec_accepted)
    assert s.n_spec_steps > 0  # rounds ran after the constrained request
    assert teng.runner.step_counts["decode"] > decode0  # plain decode steps while it ran
    assert teng.flush_cache() and jeng.flush_cache()
