"""The port's sampler extensions, the scheduler's per-step host arrays, the
score and encode steps, and the decode graphs' step variants, against the
JAX package on the CPU with the same numpy inputs:

- ``apply_penalties``, the dense counts scattered from a penalty histogram
  and ``top_logprobs`` within 1e-5 (float32); ``sample`` greedy with
  penalties, a bool mask, a float32 bias and their pairs: tokens equal;
- the scheduler's ``_penalty_arrays`` (a retracted request's folded
  output, a histogram truncated at 512 distinct tokens) and ``_vocab_mask``
  (grammars, a finished grammar, processors over a grammar, a processor
  that bans every grammar-legal token): array for array;
- a grammar cursor of each kind (regex, JSON schema, EBNF, structural tag)
  walked along the same tokens in both packages: masks, jump-forward
  chains and termination equal;
- ``Engine.score`` with a top-k on Llama, Gemma-2 and DeepSeek-V2 (the
  models' ``all_logits``), ``generate(return_logprob, max_new_tokens=0)``
  and ``Engine.encode`` on Llama, within 1e-4; an embedding engine refuses
  to generate;
- every step variant (a bool mask, a bias, penalties, a top-k, and all at
  once) through the decode graphs' static buffers (the ``EagerGraphs``
  double of tests/test_torch_cuda_graph.py) equals the eager step exactly,
  each under its own key, the plain key unchanged; a served batch with a
  grammar, penalized, biased or top-k request replays every decode step
  and gives the eager engine's tokens.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.constrained.grammar import GrammarCompiler as JaxGrammarCompiler
from semi_pd_tpu.ops import sampling as jax_sampling
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.req import Req as JaxReq
from semi_pd_tpu.runtime.scheduler import Scheduler as JaxScheduler
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.constrained.grammar import GrammarCompiler
from semi_pd_tpu_torch.ops import sampling
from semi_pd_tpu_torch.runtime.batch import build_decode_batch
from semi_pd_tpu_torch.runtime.cuda_graph_runner import DecodeGraphs, StepVariant, decode_key
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.req import Req
from semi_pd_tpu_torch.runtime.scheduler import Scheduler
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams
from test_torch_constrained import CFG, EBNF, REGEX, SCHEMA, CharTokenizer, serve
from test_torch_cuda_graph import EagerGraphs
from test_torch_gemma2 import _cfg as gemma2_cfg
from test_torch_gemma2 import _jax_cfg as gemma2_jax_cfg
from test_torch_mla import _cfg as deepseek_cfg

B, V = 6, 97


def _params(rng, B=B, greedy=True):
    """Sampling arrays of B rows (numpy), penalties on, top-k/p/min-p off."""
    return dict(
        temperature=np.zeros(B, np.float32) if greedy else rng.uniform(0.5, 1.5, B).astype(np.float32),
        top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
        min_p=np.zeros(B, np.float32),
        presence_penalty=rng.uniform(0, 1, B).astype(np.float32),
        frequency_penalty=rng.uniform(0, 1, B).astype(np.float32),
        repetition_penalty=rng.uniform(1, 1.5, B).astype(np.float32))


def _both(p):
    """The port's and JAX's SamplingArrays of the numpy dict ``p``."""
    return (sampling.SamplingArrays(**{k: torch.from_numpy(v) for k, v in p.items()}),
            jax_sampling.SamplingArrays(**{k: jnp.asarray(v) for k, v in p.items()}))


def _histogram(rng, B=B, H=16, V=V):
    ids = np.full((B, H), -1, np.int32)
    counts = np.zeros((B, H), np.int32)
    prompt = np.zeros((B, H), bool)
    for i in range(B - 1):  # the last row unpenalized (all padding)
        n = int(rng.integers(1, H + 1))
        ids[i, :n] = rng.choice(V, size=n, replace=False)
        counts[i, :n] = rng.integers(0, 4, size=n)
        prompt[i, :n] = rng.random(n) < 0.5
    return ids, counts, prompt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_penalties_and_dense_counts_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    ids, counts, prompt = _histogram(rng)
    tp, jp = _both(_params(rng))
    tc, tm = sampling.dense_penalty_counts(
        sampling.PenaltyArrays(*map(torch.from_numpy, (ids, counts, prompt))), B, V)
    # JAX's scatter (ops/sampling.py:80-91)
    rows = np.broadcast_to(np.arange(B)[:, None], ids.shape)
    jc = jnp.zeros((B, V), jnp.int32).at[rows, np.maximum(ids, 0)].add(
        np.where(ids >= 0, counts, 0))
    jm = jnp.zeros((B, V), bool).at[rows, np.maximum(ids, 0)].max((ids >= 0) & prompt)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    got = sampling.apply_penalties(torch.from_numpy(logits), tc, tm, tp)
    want = jax_sampling.apply_penalties(jnp.asarray(logits), jc, jm, jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("all_greedy", [True, False], ids=["all_greedy", "flagged"])
@pytest.mark.parametrize("variant", ["penalties", "mask", "bias", "penalties+mask",
                                     "penalties+bias"])
def test_sample_greedy_matches_jax(variant, all_greedy):
    """Greedy rows under penalties, a grammar mask and a logit bias: the
    JAX sampler's tokens (with ``all_greedy`` skipping the sort, and
    without)."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    tp, jp = _both(_params(rng))
    pen = mask = None
    if "penalties" in variant:
        pen = _histogram(rng)
    if "mask" in variant:
        mask = rng.random((B, V)) < 0.3
        mask[:, 0] = True  # at least one legal token a row
    if "bias" in variant:
        mask = rng.uniform(-3, 3, (B, V)).astype(np.float32)
        mask[rng.random((B, V)) < 0.5] = -np.inf
        mask[:, 1] = 0.0
    got = sampling.sample(
        torch.from_numpy(logits), tp, torch.Generator().manual_seed(0), all_greedy,
        None if mask is None else torch.from_numpy(mask),
        None if pen is None else sampling.PenaltyArrays(*map(torch.from_numpy, pen)))
    want = jax_sampling.sample(
        jnp.asarray(logits), jp, jax.random.PRNGKey(0),
        None if mask is None else jnp.asarray(mask),
        None if pen is None else jax_sampling.PenaltyArrays(*map(jnp.asarray, pen)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if pen is None and mask is not None:  # the constraint changed some argmax
        assert not np.array_equal(got.numpy(), logits.argmax(-1))


@pytest.mark.parametrize("k", [1, 5, 32])
def test_top_logprobs_match_jax(k):
    rng = np.random.default_rng(k)
    logits = (rng.standard_normal((B, 300)) * 4).astype(np.float32)
    vals, ids = sampling.top_logprobs(torch.from_numpy(logits), k)
    jvals, jids = jax_sampling.top_logprobs(jnp.asarray(logits), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-5, rtol=0)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32


# ------------------------------------------------------- scheduler arrays
def _req_pair(i, prompt, out, sp):
    """A port and a JAX request with the same prompt, outputs and
    sampling parameters."""
    r = Req(rid=f"r{i}", input_ids=list(prompt), sampling_params=SamplingParams(**sp))
    jr = JaxReq(rid=f"r{i}", input_ids=list(prompt), sampling_params=JaxSamplingParams(**sp))
    for x in (r, jr):
        x.output_ids = list(out)
    return r, jr


def test_penalty_arrays_match_jax():
    """Histograms of penalized requests (generated counts, prompt-set
    membership), an unpenalized row, a retracted request whose output was
    folded into its input, and a request past 512 distinct tokens
    (prompt-set entries dropped first)."""
    rng = np.random.default_rng(4)
    pen = dict(repetition_penalty=1.2, frequency_penalty=0.4)
    pairs = [
        _req_pair(0, rng.integers(0, 50, 30), rng.integers(0, 50, 12), pen),
        _req_pair(1, rng.integers(0, 50, 8), [3, 3, 3, 7], dict()),
        _req_pair(2, rng.integers(0, 2000, 900), rng.integers(0, 2000, 40),
                  dict(presence_penalty=0.5)),
        _req_pair(3, rng.integers(0, 80, 20), rng.integers(0, 80, 6), pen),
    ]
    for x in pairs[3]:  # retraction folded 6 generated tokens into the input
        x.input_ids = x.input_ids + x.output_ids
        x.n_retracted_output = len(x.output_ids)
        x.output_ids = [11, 11]
    stub = lambda: types.SimpleNamespace(PENALTY_HIST=512, _penalty_trunc_warned=False)
    got = Scheduler._penalty_arrays(stub(), [p[0] for p in pairs], 8)
    want = JaxScheduler._penalty_arrays(stub(), [p[1] for p in pairs], 8)
    assert Scheduler.PENALTY_HIST == JaxScheduler.PENALTY_HIST == 512
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (8, 512) and a.dtype == b.dtype
    assert (got.hist_ids[2] >= 0).all()  # truncated at 512
    assert Scheduler._penalty_arrays(stub(), [pairs[1][0]], 4) is None


@pytest.fixture(scope="module")
def compilers():
    tok = CharTokenizer(512)
    return (GrammarCompiler(tok, [95]), JaxGrammarCompiler(tok, [95])), tok


SPECS = {"regex": REGEX, "json_schema": json.dumps(SCHEMA), "ebnf": EBNF,
         "structural_tag": json.dumps({"structures": [{"begin": "<f>", "schema": {"enum": [1, 2]},
                                                       "end": "</f>"}],
                                       "triggers": ["<f>"]})}


@pytest.mark.parametrize("case", ["grammar", "processors", "bans_everything"])
def test_vocab_mask_matches_jax(case, compilers):
    """The [B, V] mask of a batch (V past the tokenizer's 512: padded
    columns banned): bool for grammars alone (a finished grammar's row and
    a plain row all legal); a float32 bias when a processor is active,
    grammar bans as -inf; a processor banning every grammar-legal token is
    ignored for that row."""
    (gc, jgc), tok = compilers
    stub = types.SimpleNamespace(runner=types.SimpleNamespace(
        model_config=types.SimpleNamespace(vocab_size=520)))
    rng = np.random.default_rng(5)
    items = [(dict(regex=REGEX), [ord("a") - 32]), (dict(), []),
             (dict(regex=REGEX), [ord("c") - 32, ord("d") - 32, ord("=") - 32]),
             (dict(ebnf=EBNF), [])]
    if case == "processors":
        items += [(dict(custom_logit_processor="logit_bias",
                        custom_params={"logit_bias": {"5": 2.0, "600": 1.0}}), []),
                  (dict(json_schema=SPECS["json_schema"], custom_logit_processor="disallow_tokens",
                        custom_params={"token_ids": [91, 2]}), [])]
    if case == "bans_everything":
        items = [(dict(regex=REGEX, custom_logit_processor="thinking_budget",
                       custom_params={"budget": 0, "end_token_id": 3}), [])]
    reqs = ([], [])
    for i, (sp, walk) in enumerate(items):
        pair = _req_pair(i, rng.integers(0, 512, 5), [], sp)
        for x, comp, lst in zip(pair, (gc, jgc), reqs):
            for kind in ("regex", "json_schema", "ebnf"):
                if sp.get(kind):
                    x.grammar = comp.matcher(kind, sp[kind])
            for t in walk:
                assert x.grammar.accept_token(t)
                x.output_ids.append(t)
            lst.append(x)
    if case == "grammar":  # a finished grammar: its row is all legal
        for x in (reqs[0][2], reqs[1][2]):
            for t in [ord(c) - 32 for c in "12;x"] + [95]:
                assert x.grammar.accept_token(t)
            assert x.grammar.finished
    got = Scheduler._vocab_mask(stub, reqs[0], 8)
    want = JaxScheduler._vocab_mask(stub, reqs[1], 8)
    assert got.dtype == want.dtype == (bool if case == "grammar" else np.float32)
    np.testing.assert_array_equal(got, want)
    if case == "grammar":
        assert got[1].all() and got[2].all() and not got[0, 512:].any()


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_grammar_cursor_and_jump_forward_match_jax(kind, compilers):
    """One cursor of each kind in both packages, walked along the same
    tokens (the lowest-id legal token, or a seeded pick among the legal
    ones): masks, jump-forward chains and termination equal at every step;
    the walk meets a forced run (a chain of at least 2)."""
    (gc, jgc), tok = compilers
    m, jm = gc.matcher(kind, SPECS[kind]), jgc.matcher(kind, SPECS[kind])
    rng = np.random.default_rng(6)
    chains = []
    for step in range(30):
        mask, jmask = m.vocab_mask(), jm.vocab_mask()
        np.testing.assert_array_equal(mask, jmask)
        jf, jjf = m.jump_forward_tokens(), jm.jump_forward_tokens()
        assert jf == jjf
        chains.append(len(jf))
        assert m.is_terminated() == jm.is_terminated() and m.finished == jm.finished
        if m.finished:
            break
        legal = np.flatnonzero(mask)
        if kind == "structural_tag" and 2 <= step < 5:
            t = tok.strs.index("<f>"[step - 2])  # the trigger: enter the structure
        else:
            t = int(legal[0] if step % 2 else rng.choice(legal))
        assert m.accept_token(t) == jm.accept_token(t)
    assert max(chains) >= 2


# ------------------------------------------------------------ score / encode
MODELS = {
    "llama": (CFG, dict(page_size=16, max_total_tokens=2048, chunked_prefill_size=128)),
    "gemma2": (None, dict(page_size=4, max_total_tokens=1024, chunked_prefill_size=128)),
    "deepseek_v2": (deepseek_cfg("v2"), dict(page_size=16, max_total_tokens=2048,
                                            chunked_prefill_size=128)),
}


def _model_pair(name):
    cfg, serve_args = MODELS[name]
    if name == "gemma2":
        jmc, mc = gemma2_jax_cfg(), gemma2_cfg()
    else:
        jmc, mc = JaxModelConfig(**cfg), ModelConfig(**cfg)
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               dtype="float32", **serve_args),
                     model_config=jmc)
    teng = Engine(ServerArgs(random_weights=True, device="cpu", **serve_args), mc, device="cpu")
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    return jeng, teng


@pytest.mark.parametrize("name", sorted(MODELS))
def test_score_with_top_k_matches_jax(name):
    """Teacher-forced input log-probs of two prompts in one extend batch,
    from position 3, with each position's top-4: within 1e-4, ids and
    tokens equal; the pages go back (check_memory)."""
    jeng, teng = _model_pair(name)
    vocab = teng.runner.model_config.vocab_size
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (23, 61)]
    got = teng.score(input_ids=prompts, logprob_start_len=3, top_logprobs_num=4)
    want = jeng.score(input_ids=prompts, logprob_start_len=3, top_logprobs_num=4)
    assert [len(g) for g in got] == [20, 58]
    for g, w in zip(got, want):
        for (lp, tid, (tv, ti)), (jlp, jtid, (jtv, jti)) in zip(g, w):
            assert tid == jtid and ti == jti
            np.testing.assert_allclose([lp] + tv, [jlp] + jtv, atol=1e-4, rtol=0)
    assert teng.flush_cache() and jeng.flush_cache()


def test_score_generate_mode_and_encode_match_jax():
    """Llama: ``score`` without a top-k, ``generate(return_logprob=True,
    max_new_tokens=0)`` (the same scores), and ``encode``'s unit-norm
    embeddings, within 1e-4 of the JAX Engine's."""
    jeng, teng = _model_pair("llama")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (17, 40, 5)]
    got = teng.score(input_ids=prompts[0])
    want = jeng.score(input_ids=prompts[0])
    assert [t for _, t in got] == [t for _, t in want] == prompts[0][1:]
    np.testing.assert_allclose([l for l, _ in got], [l for l, _ in want], atol=1e-4, rtol=0)
    sp = dict(max_new_tokens=0)
    out = teng.generate(input_ids=prompts, sampling_params=sp, return_logprob=True)
    jout = jeng.generate(input_ids=prompts, sampling_params=sp, return_logprob=True)
    for o, jo in zip(out, jout):
        a, b = o["meta_info"]["input_token_logprobs"], jo["meta_info"]["input_token_logprobs"]
        assert [t for _, t in a] == [t for _, t in b]
        np.testing.assert_allclose([l for l, _ in a], [l for l, _ in b], atol=1e-4, rtol=0)
    emb = np.asarray(teng.encode(input_ids=prompts))
    jemb = np.asarray(jeng.encode(input_ids=prompts))
    assert emb.shape == (3, CFG["hidden_size"])
    np.testing.assert_allclose(emb, jemb, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
    single = teng.encode(input_ids=prompts[1])
    np.testing.assert_allclose(single, emb[1], atol=1e-5)
    assert teng.flush_cache() and jeng.flush_cache()


def test_embedding_engine_refuses_generate():
    eng = Engine(ServerArgs(random_weights=True, device="cpu", is_embedding=True, page_size=16,
                            max_total_tokens=1024, chunked_prefill_size=64),
                 ModelConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="embedding mode"):
        eng.generate(input_ids=[1, 2, 3], sampling_params=dict(max_new_tokens=4))
    with pytest.raises(ValueError, match="embedding mode"):
        eng.make_request([1, 2, 3], SamplingParams(max_new_tokens=2))
    assert len(eng.encode(input_ids=[1, 2, 3])) == CFG["hidden_size"]
    assert eng.flush_cache()


# ------------------------------------------------------------ step variants
VARIANTS = {"bool": StepVariant(mask="bool"), "bias": StepVariant(mask="bias"),
            "penalties": StepVariant(penalties=True), "top_k": StepVariant(top_k=3),
            "all": StepVariant(mask="bias", penalties=True, top_k=5)}


def _graph_engine():
    eng = Engine(ServerArgs(random_weights=True, device="cpu", page_size=16,
                            max_total_tokens=2048, chunked_prefill_size=64),
                 ModelConfig(**CFG), device="cpu")
    eng.runner.graphs = DecodeGraphs(eng.runner, EagerGraphs())
    g = torch.Generator().manual_seed(0)
    buf = eng.runner.kv_cache.buffer
    buf.copy_(torch.randn(buf.shape, generator=g))
    return eng


def _variant_batch(eng, variant, lens, seed):
    """A decode batch of requests with the given KV lengths and the host
    arrays of ``variant``: a mask or bias [B, V], a penalty histogram."""
    runner, sched = eng.runner, eng.scheduler
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(lens):
        r = Req(rid=f"v{seed}-{i}", input_ids=rng.integers(0, 512, size=int(n)).tolist(),
                sampling_params=SamplingParams(temperature=0.0, repetition_penalty=1.3,
                                               frequency_penalty=0.2))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(int(n) + 1) // 16))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = r.prompt_len
        r.output_ids = rng.integers(0, 512, size=3).tolist()
        r.prefilled_len -= 2  # three outputs: kv_len back at n
        reqs.append(r)
    hb = build_decode_batch(reqs, runner.req_pool.page_table, 16, sched.b_buckets,
                            sched.p_buckets)
    mask = None
    if variant.mask == "bool":
        mask = rng.random((hb.B, 512)) < 0.2
    elif variant.mask == "bias":
        mask = rng.uniform(-4, 4, (hb.B, 512)).astype(np.float32)
        mask[rng.random((hb.B, 512)) < 0.3] = -np.inf
    pen = sched._penalty_arrays(reqs, hb.B) if variant.penalties else None
    return hb, mask, pen


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_step_variant_through_graphs_equals_the_eager_step(name):
    """A decode step with a mask, a bias, penalties, a top-k or all of them
    through its key's static buffers equals the eager step exactly, on two
    batches of one key (the second replay reads its own inputs); the key
    is the plain one with the variant after it, and the plain step keeps
    the plain key."""
    variant = VARIANTS[name]
    eng = _graph_engine()
    runner = eng.runner
    for seed, lens in ((1, [40, 3, 90, 17, 60]), (2, [70, 33, 5, 100, 8, 51])):
        hb, mask, pen = _variant_batch(eng, variant, lens, seed)
        args = (hb, variant.top_k, mask, pen) if variant.top_k else (hb, mask, pen)
        step = runner.step_topk_host if variant.top_k else runner.step_host
        got = step(*args)
        graphs, runner.graphs = runner.graphs, None
        try:
            want = step(*args)
        finally:
            runner.graphs = graphs
        assert len(got) == len(want) == (4 if variant.top_k else 2)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    shapes = hb.pack()[2]
    assert list(runner.graphs.graphs) == [decode_key(shapes, True, variant)]
    assert decode_key(shapes, True, variant) == decode_key(shapes, True) + (variant,)
    assert runner.graphs.stats["captures"] == 1 and runner.graphs.stats["replays"] == 2
    # the plain step: its own key, the four-field one
    runner.step_packed(hb)
    assert decode_key(shapes, True) in runner.graphs.graphs
    assert len(decode_key(shapes, True)) == 4


@pytest.mark.parametrize("case", ["regex", "penalties", "logit_bias", "top_logprobs"])
def test_served_variant_steps_replay_and_give_the_eager_tokens(case):
    """An Engine on the graph double serving a masked, penalized, biased or
    top-k request beside a plain one: every decode step is replayed (the
    variant's keys among the graphs), and the tokens, log-probs and top-k
    equal the same engine's with decode graphs off."""
    eng = _graph_engine()
    eng.tokenizer = CharTokenizer(512)
    sp = {"regex": dict(regex=REGEX), "penalties": dict(repetition_penalty=1.3),
          "logit_bias": dict(custom_logit_processor="logit_bias",
                             custom_params={"logit_bias": {"9": 4.0}}),
          "top_logprobs": dict()}[case]
    k = 3 if case == "top_logprobs" else 0
    rng = np.random.default_rng(10)
    p = [rng.integers(0, 512, size=n).tolist() for n in (12, 50)]
    items = [(p[0], dict(max_new_tokens=10, temperature=0.0, ignore_eos=True, **sp), k),
             (p[1], dict(max_new_tokens=10, temperature=0.0, ignore_eos=True), 0)]
    if case == "regex":
        items[0][1].pop("ignore_eos")
    runner = eng.runner
    outs = []
    for graphs in (runner.graphs, None):
        eng.scheduler = Scheduler(eng.server_args, runner)
        runner.graphs = graphs
        d0 = runner.step_counts["decode"]
        outs.append(serve(eng, items, port=True))
        if graphs is not None:
            assert graphs.stats["replays"] == runner.step_counts["decode"] - d0 > 0
            assert any(len(key) == 5 for key in graphs.graphs)
        assert eng.flush_cache()
    a, b = outs
    assert [o["output_ids"] for o in a] == [o["output_ids"] for o in b]
    for x, y in zip(a, b):
        assert x["meta_info"]["output_logprobs"] == y["meta_info"]["output_logprobs"]
        assert x["meta_info"]["output_top_logprobs"] == y["meta_info"]["output_top_logprobs"]
