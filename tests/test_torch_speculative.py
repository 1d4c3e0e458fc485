"""The port's speculative decoding (NGRAM, EAGLE chain, EAGLE tree) against
the JAX package on the CPU, with the same numpy inputs and weights:

- ``ngram_draft``; ``verify_and_accept``: greedy rows exactly as JAX's,
  sampled rows checked for structure, for both relaxation thresholds and,
  by Monte Carlo on a vocabulary of 5, for the distribution of the token
  they commit (exact rejection sampling commits the target's own);
- both verify batch builders, field for field;
- ``EagleDraftModel``: its ``init_params(seed)`` draws the JAX numbers, and
  one ``step`` (decode-shaped over the 5D draft pool) gives JAX's hidden;
- ``eagle_round`` and ``eagle_tree_round`` on the same pools and weights:
  tokens, accept lengths, the next hidden states, and both pools after the
  tree's compaction and the refresh;
- the Engine: greedy tokens and ``n_spec_accepted`` equal to the JAX
  Engine's for NGRAM, EAGLE chain and EAGLE tree, colocated and semi-PD
  (a long prompt chunk-prefilling beside the speculating requests, with a
  fixed prefill chunk budget so that both engines schedule alike), and the
  port's tokens equal to its own non-speculating serve; a stop token inside
  an accepted run; chunked prefill with a radix hit; an FR-Spec map file;
  the refresh off; sampled requests under a tree (chain rounds);
  ``check_memory`` after each serve; releasing and re-making the pools;
- the refusals (a draft checkpoint, an unknown algorithm), and the draft
  NEXTN picks on a Llama target and EAGLE on a DeepSeek one.

The EAGLE weights are made predictive (the target's final norm set to ones,
the draft's fc passing the token embedding through), so that rounds accept
drafts and the compaction and the refresh are exercised; both packages get
the same numbers.

Model: Hq 8, Hkv 8, head_dim 64 (the chunked pool, as Llama-3.2-1B; the
draft's 5D pool at head_dim 64 takes the merged kernels' path), hidden 256,
2 layers, vocab 64, float32. Tolerances: float32 hidden states and pools
2e-5 (the same float32 products in another order); tokens and accept
lengths exact.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.ops.sampling import SamplingArrays as JaxSamplingArrays
from semi_pd_tpu.runtime import batch as jax_batch
from semi_pd_tpu.runtime import speculative as jax_spec
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.req import Req as JaxReq
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from semi_pd_tpu.speculative import eagle as jax_eagle
from semi_pd_tpu.speculative.tree import default_tree_template as jax_tree

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.ops.sampling import SamplingArrays
from semi_pd_tpu_torch.runtime import batch as port_batch
from semi_pd_tpu_torch.runtime import speculative as port_spec
from semi_pd_tpu_torch.runtime.cuda_graph_runner import RoundGraphs
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.req import Req
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams
from semi_pd_tpu_torch.speculative import eagle as port_eagle
from semi_pd_tpu_torch.speculative.tree import default_tree_template
from test_torch_round_graphs import EagerRounds

CFG = dict(architecture="LlamaForCausalLM", vocab_size=64, hidden_size=256,
           intermediate_size=512, num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=8, head_dim=64, max_position_embeddings=512,
           context_length=512, rope_theta=10000.0, dtype="float32")
# one decode bucket, one prefill bucket and prompts whose verify windows
# stay within 8 pages: few distinct shapes for the JAX engine to compile
SERVE = dict(page_size=16, max_total_tokens=2048, chunked_prefill_size=32,
             decode_bs_buckets=[4])
ALGOS = {"ngram": dict(speculative_algorithm="NGRAM", speculative_num_draft_tokens=3),
         "chain": dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=3),
         "tree": dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=4,
                      speculative_eagle_topk=4),
         # branching (2, 1, 1), 7 nodes: the side cases' tree, cheaper for
         # the JAX engine to compile than the (4, 2, 1, 1) one
         "small_tree": dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=3,
                            speculative_eagle_topk=2)}
MAIN_ALGOS = ("chain", "ngram", "tree")
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast alone and
    keeps the many small ops from stalling when the test workers share the
    CPU (8 threads each ran them up to 10x slower there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- NGRAM
@pytest.mark.parametrize("hist", [[1, 2, 3, 1, 2], [5, 5, 5, 5], [1, 2, 3, 4],
                                  [7, 1, 2, 9, 9, 1, 2], [3], [4, 8, 4, 8, 4]])
@pytest.mark.parametrize("gamma", [1, 3])
def test_ngram_draft_matches_jax(hist, gamma):
    sp = dict(temperature=0.0)
    tr = Req(rid="a", input_ids=hist[:2], sampling_params=SamplingParams(**sp))
    tr.output_ids = hist[2:]
    jr = JaxReq(rid="a", input_ids=hist[:2], sampling_params=JaxSamplingParams(**sp))
    jr.output_ids = hist[2:]
    assert port_spec.ngram_draft(tr, gamma) == jax_spec.ngram_draft(jr, gamma)


# ------------------------------------------------------------ verify_and_accept
def _sampling(temps, B):
    t = np.zeros(B, np.float32)
    t[: len(temps)] = temps
    z = np.zeros(B, np.float32)
    return (SamplingArrays(torch.from_numpy(t), torch.zeros(B, dtype=torch.int32),
                           torch.ones(B), torch.from_numpy(z), torch.from_numpy(z),
                           torch.from_numpy(z), torch.ones(B)),
            JaxSamplingArrays(jnp.asarray(t), jnp.zeros(B, jnp.int32), jnp.ones(B),
                              jnp.asarray(z), jnp.asarray(z), jnp.asarray(z), jnp.ones(B)))


def test_verify_and_accept_greedy_matches_jax():
    """Greedy rows: accept while the target's argmax equals the draft, then
    the argmax as the correction or bonus; padded drafts (-1) and short
    draft_lens stop the run."""
    rng = np.random.default_rng(0)
    B, g, V = 6, 3, 17
    logits = rng.normal(size=(B * (g + 1), V)).astype(np.float32)
    am = logits.reshape(B, g + 1, V).argmax(-1)
    drafts = rng.integers(0, V, size=(B, g)).astype(np.int32)
    drafts[0] = am[0, :g]  # all accepted: the bonus row
    drafts[1, :2] = am[1, :2]  # 2 accepted
    drafts[2, 1:] = am[2, 1:g]  # first rejected
    drafts[3] = am[3, :g]
    drafts[4] = am[4, :g]
    drafts[4, 2] = -1  # a padded draft
    lens = np.array([3, 3, 3, 1, 2, 0], np.int32)
    ts, js = _sampling([0.0] * B, B)
    gen = torch.Generator().manual_seed(0)
    a, n = port_spec.verify_and_accept(torch.from_numpy(logits), torch.from_numpy(drafts),
                                       torch.from_numpy(lens), ts, gen, g)
    ja, jn = jax_spec.verify_and_accept(jnp.asarray(logits), jnp.asarray(drafts),
                                        jnp.asarray(lens), js, jax.random.PRNGKey(0), g)
    assert a.tolist() == np.asarray(ja).tolist() == [3, 2, 0, 1, 2, 0]
    assert n.tolist() == np.asarray(jn).tolist()
    assert a.dtype == n.dtype == torch.int32


@pytest.mark.parametrize("single,acc", [(1.0, 1.0), (0.5, 1.0), (1.0, 0.25)])
def test_verify_and_accept_sampled_structure_and_thresholds(single, acc):
    """Sampled rows: accept_len within [0, draft_len], tokens in range, and
    a draft whose target probability passes a relaxed threshold (above
    threshold_single, or p / threshold_acc >= 1) is always accepted, as
    JAX's acceptance gives."""
    rng = np.random.default_rng(1)
    B, g, V = 64, 3, 11
    logits = rng.normal(size=(B, g + 1, V)).astype(np.float32)
    drafts = rng.integers(0, V, size=(B, g)).astype(np.int32)
    # rows 0-15: a draft the target gives 0.6 of its mass at every position
    for b in range(16):
        for j in range(g):
            logits[b, j] = -3.0
            logits[b, j, drafts[b, j]] = np.log(0.6 / 0.4 * (V - 1)) - 3.0
    lens = rng.integers(0, g + 1, size=B).astype(np.int32)
    lens[:16] = g
    ts, js = _sampling([1.0] * B, B)
    gen = torch.Generator().manual_seed(1)
    kw = dict(threshold_single=single, threshold_acc=acc)
    a, n = port_spec.verify_and_accept(torch.from_numpy(logits.reshape(-1, V)),
                                       torch.from_numpy(drafts), torch.from_numpy(lens), ts,
                                       gen, g, **kw)
    ja, _ = jax_spec.verify_and_accept(jnp.asarray(logits.reshape(-1, V)),
                                       jnp.asarray(drafts), jnp.asarray(lens), js,
                                       jax.random.PRNGKey(1), g, **kw)
    a, ja = a.numpy(), np.asarray(ja)
    assert ((0 <= a) & (a <= lens)).all() and ((0 <= n.numpy()) & (n.numpy() < V)).all()
    relaxed = single < 0.6 or 0.6 / acc >= 1.0
    if relaxed:  # p = 0.6 passes: every draft of rows 0-15 is accepted, in both
        assert (a[:16] == g).all() and (ja[:16] == g).all()
    else:
        assert (a[:16] < g).any()  # 0.6^3: some row rejects


def test_verify_and_accept_commits_the_target_distribution():
    """Exact rejection sampling against a deterministic draft commits each
    token with the target's own probability (Leviathan et al.): over 40000
    rows of gamma 1 on a vocabulary of 5, the committed first token's
    frequencies stay within 4.5 standard errors of p."""
    B, V = 40000, 5
    p = np.array([0.4, 0.25, 0.2, 0.1, 0.05])
    logits = np.tile(np.log(p)[None, None], (B, 2, 1)).astype(np.float32)
    drafts = np.full((B, 1), 1, np.int32)  # always draft token 1
    ts, _ = _sampling([1.0] * B, B)
    gen = torch.Generator().manual_seed(3)
    a, n = port_spec.verify_and_accept(torch.from_numpy(logits.reshape(-1, V)),
                                       torch.from_numpy(drafts),
                                       torch.ones(B, dtype=torch.int32), ts, gen, 1)
    first = np.where(a.numpy() == 1, 1, n.numpy())
    freq = np.bincount(first, minlength=V) / B
    se = np.sqrt(p * (1 - p) / B)
    assert (np.abs(freq - p) <= 4.5 * se).all(), (freq, p)
    # a rejection never commits the rejected draft
    assert not ((a.numpy() == 0) & (n.numpy() == 1)).any()


# ----------------------------------------------------------------- builders
def _req_pair(i, kv_len, pages, slot, out=2):
    ids = list(range(3, 3 + kv_len - out + 1))
    sp = dict(temperature=0.0)
    reqs = []
    for R, SP in ((Req, SamplingParams), (JaxReq, JaxSamplingParams)):
        r = R(rid=f"r{i}", input_ids=list(ids), sampling_params=SP(**sp))
        r.prefilled_len = len(ids)
        r.output_ids = [7 + i] * out
        r.pages, r.req_slot = list(pages), slot
        reqs.append(r)
    return reqs


def _host_state(kv_lens, n_extra, seed=0, page_size=16):
    """Requests of the given kv lengths with pages for ``n_extra`` more
    positions (shuffled page ids) in both packages, and the page table."""
    rng = np.random.default_rng(seed)
    need = [-(-(k + n_extra + 1) // page_size) for k in kv_lens]
    perm = rng.permutation(np.arange(1, sum(need) + 1))
    table = np.zeros((8, 16), np.int32)
    port, jaxr, used = [], [], 0
    for i, (k, n) in enumerate(zip(kv_lens, need)):
        pages = perm[used:used + n].tolist()
        used += n
        table[i + 1, :n] = pages
        tr, jr = _req_pair(i, k, pages, i + 1)
        assert tr.kv_len == jr.kv_len == k
        port.append(tr)
        jaxr.append(jr)
    return port, jaxr, table, sum(need) + 1


def _same_batch(hb, jb):
    for f in ("input_ids", "q_req_idx", "q_pos", "out_slots", "page_table", "kv_lens",
              "logits_idx", "mask_pos", "win_base", "extend_lens", "T", "B", "maxP"):
        a, b = getattr(hb, f), getattr(jb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)


@pytest.mark.parametrize("gamma", [1, 3])
def test_spec_verify_batch_matches_jax(gamma):
    port, jaxr, table, _ = _host_state([20, 47, 31], gamma + 1)
    drafts = [[5, 6, 7][:gamma], [], [9][:gamma]]
    args = (gamma, table, 16, [1, 2, 4, 8], [8, 16])
    hb, d, n = port_batch.build_spec_verify_batch(port, drafts, *args)
    jb, jd, jn = jax_batch.build_spec_verify_batch(jaxr, drafts, *args)
    _same_batch(hb, jb)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(n, jn)
    fb = hb.to_device("cpu")
    assert fb.mask_pos is None
    # every request's rows start at its row 0's slot, however short its draft
    np.testing.assert_array_equal(fb.attn_meta.q_start.numpy()[:3], [r.kv_len for r in port])


@pytest.mark.parametrize("topk,gamma", [(2, 2), (4, 4)])
def test_tree_verify_batch_matches_jax(topk, gamma):
    tree = default_tree_template(topk, gamma)
    port, jaxr, table, _ = _host_state([20, 47, 31], tree.num_nodes)
    args = (table, 16, [1, 2, 4, 8], [8, 16])
    hb = port_batch.build_tree_verify_batch(port, tree, *args)
    jb = jax_batch.build_tree_verify_batch(jaxr, jax_tree(topk, gamma), *args)
    _same_batch(hb, jb)
    fb = hb.to_device("cpu")
    # the work list's q_start is the slot-order start of each window
    np.testing.assert_array_equal(fb.attn_meta.q_start.numpy()[:3], hb.win_base[:3])
    np.testing.assert_array_equal(fb.mask_pos.numpy(), hb.mask_pos)


# ----------------------------------------------------------------- EAGLE
def _predictive(jparams, jdraft):
    """Make EAGLE accept (in place, numpy trees): the target's final norm
    ones, so its argmax is the head's over its last hidden; the draft's fc
    passing the token embedding through (and a small share of the fed
    hidden), so the draft's head sees mostly that embedding."""
    H = CFG["hidden_size"]
    jparams["final_norm"] = np.ones_like(jparams["final_norm"])
    fc = np.array(jdraft["fc"]["w"])
    fc[:H] = np.eye(H, dtype=fc.dtype)
    fc[H:] *= 0.01
    jdraft["fc"]["w"] = fc


def _engines(algo, **extra):
    """A JAX and a port Engine for ``algo`` holding the same predictive
    weights."""
    spec = dict(ALGOS[algo], **extra)
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True,
                                               **SERVE, **spec),
                     model_config=JaxModelConfig(**CFG))
    teng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE, **spec),
                  ModelConfig(**CFG), device="cpu")
    jr, tr = jeng.runner, teng.runner
    params = jax.tree.map(np.asarray, jr.params)
    if jr.draft_model is not None:
        draft = jax.tree.map(np.asarray, jr.draft_params)
        # the port's init_params(seed + 1) drew the JAX draft's numbers
        mine = jax.tree.leaves(tr.draft_model.params_tree())
        assert len(mine) == len(jax.tree.leaves(draft)) == 7
        for a, b in zip(mine, jax.tree.leaves(draft)):
            np.testing.assert_array_equal(a, b)
        _predictive(params, draft)
        jr.draft_params = jax.tree.map(jnp.asarray, draft)
        tr.draft_model.load_jax_params(draft)
    jr.params = jax.tree.map(jnp.asarray, params)
    tr.model.load_jax_params(params)
    if tr.draft_model is not None:
        tr.set_spec_thresholds()  # re-slices an FR-Spec head from the loaded weights
    return jeng, teng


@pytest.fixture(scope="module")
def pairs():
    """Engine pairs built once per algorithm and options (the JAX engine's
    compiled programs are most of a test's time); each test gives them
    fresh schedulers (``_serve``)."""
    cache = {}

    def get(algo, **extra):
        key = (algo, tuple(sorted(extra.items())))
        if key not in cache:
            cache[key] = _engines(algo, **extra)
        return cache[key]

    yield get
    cache.clear()


def _serve(pair, semi_pd=False):
    """Fresh schedulers on both engines of a pair, colocated or semi-PD
    (with a fixed prefill chunk budget, so that both schedule alike): new
    queues, radix caches and counters over the same runners, pools and
    compiled programs."""
    from semi_pd_tpu.runtime.scheduler import Scheduler as JaxScheduler

    from semi_pd_tpu_torch.runtime.scheduler import Scheduler

    for eng, sched in zip(pair, (JaxScheduler, Scheduler)):
        assert eng.flush_cache()  # idle, no leak
        args = dataclasses.replace(eng.server_args, enable_semi_pd=semi_pd,
                                   prefill_chunk_budget_tokens=32 if semi_pd else None)
        eng.server_args, eng.scheduler = args, sched(args, eng.runner)
    return pair


def _prompts():
    rng = np.random.default_rng(7)
    short = [rng.integers(0, 64, size=n).tolist() for n in (10, 23)]
    return short + [rng.integers(0, 64, size=66).tolist()]  # three chunks of 32


# the rounds run eagerly, or replayed from round graphs ("-graphs")
@pytest.mark.parametrize("semi_pd,rounds", [(False, "eager"), (True, "eager"),
                                            (False, "graphs"), (True, "graphs")],
                         ids=["colocated", "semi_pd", "colocated-graphs", "semi_pd-graphs"])
@pytest.mark.parametrize("algo", MAIN_ALGOS)
def test_engine_tokens_and_acceptance_match_jax(algo, semi_pd, rounds, pairs):
    """The port's Engine gives the JAX Engine's greedy tokens and accepted
    drafts, its rounds run eagerly or replayed from round graphs (the
    ``EagerRounds`` double of tests/test_torch_round_graphs.py)."""
    jeng, teng = _serve(pairs(algo), semi_pd)
    teng.runner.round_graphs = (RoundGraphs(teng.runner, EagerRounds())
                                if rounds == "graphs" else None)
    counts0 = dict(teng.runner.step_counts), dict(teng.runner.spec_counts)
    sp = dict(max_new_tokens=16, temperature=0.0, ignore_eos=True)
    jout = jeng.generate(input_ids=_prompts(), sampling_params=JaxSamplingParams(**sp))
    tout = teng.generate(input_ids=_prompts(), sampling_params=SamplingParams(**sp))
    got = [o["output_ids"] for o in tout]
    assert got == [o["output_ids"] for o in jout]
    s, js = teng.scheduler, jeng.scheduler
    assert s.n_spec_steps == js.n_spec_steps > 0
    assert s.n_spec_accepted == js.n_spec_accepted > 0
    # every decode tick speculated
    assert teng.runner.step_counts["decode"] == counts0[0]["decode"]
    if algo == "tree":
        assert teng.runner.tree_template.num_nodes == 29
        assert teng.runner.spec_counts["draft_tree"] > counts0[1]["draft_tree"]
    if rounds == "graphs":  # every round replayed, a capture per key
        rg = teng.runner.round_graphs
        assert rg.stats["replays"] == teng.runner.spec_counts["verify"] - counts0[1]["verify"]
        assert rg.stats["captures"] == len(rg.graphs) >= 1
    assert teng.flush_cache() and jeng.flush_cache()  # check_memory() inside
    # the same engine without speculation gives the same greedy tokens
    s.spec_gamma = 0
    plain = teng.generate(input_ids=_prompts(), sampling_params=SamplingParams(**sp))
    assert [o["output_ids"] for o in plain] == got
    assert teng.runner.step_counts["decode"] > counts0[0]["decode"] and teng.flush_cache()


def test_ngram_short_drafts_give_the_plain_tokens():
    """NGRAM verify rows past a short or empty draft: the work list starts
    each request at its row 0's slot, so every row sees the newest
    positions, its own among them, and the speculating serve gives the
    non-speculating serve's greedy tokens. The weights make attention
    decide the tokens (every norm ones), and the vocabulary is one where
    the prompts seldom repeat an n-gram, so most drafts are short."""
    eng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE, **ALGOS["ngram"]),
                 ModelConfig(**dict(CFG, vocab_size=512)), device="cpu")
    params = eng.runner.model.params_tree()
    params["final_norm"] = np.ones_like(params["final_norm"])
    for k in ("input_norm", "post_norm"):
        params["layers"][k] = np.ones_like(params["layers"][k])
    eng.runner.model.load_jax_params(params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (12, 40, 25)]
    sp = SamplingParams(max_new_tokens=16, temperature=0.0, ignore_eos=True)
    got = [o["output_ids"] for o in eng.generate(input_ids=prompts, sampling_params=sp)]
    assert eng.scheduler.n_spec_steps > 0 and eng.flush_cache()
    eng.scheduler.spec_gamma = 0
    plain = [o["output_ids"] for o in eng.generate(input_ids=prompts, sampling_params=sp)]
    assert got == plain and eng.flush_cache()


@pytest.mark.parametrize("algo", ["ngram", "small_tree"])
def test_stop_token_inside_an_accepted_run(algo, pairs):
    jeng, teng = _serve(pairs(algo))
    prompt = _prompts()[1]
    sp0 = dict(max_new_tokens=20, temperature=0.0, ignore_eos=True)
    full = teng.generate(input_ids=prompt, sampling_params=SamplingParams(**sp0))["output_ids"]
    accepted_full = teng.scheduler.n_spec_accepted
    stop = full[5]
    sp = dict(sp0, stop_token_ids=[stop])
    want = jeng.generate(input_ids=prompt, sampling_params=JaxSamplingParams(**sp))
    got = teng.generate(input_ids=prompt, sampling_params=SamplingParams(**sp))
    assert got["output_ids"] == want["output_ids"] == full[: full.index(stop) + 1]
    assert teng.scheduler.n_spec_accepted - accepted_full == jeng.scheduler.n_spec_accepted
    assert accepted_full > 0
    assert teng.flush_cache()


def test_eagle_chunked_prefill_and_radix_hit(pairs):
    jeng, teng = _serve(pairs("chain"))
    prompt = _prompts()[2]  # 66 tokens: three chunks of 32
    sp = dict(max_new_tokens=8, temperature=0.0, ignore_eos=True)
    outs = []
    for _ in range(2):
        j = jeng.generate(input_ids=prompt, sampling_params=JaxSamplingParams(**sp))
        t = teng.generate(input_ids=prompt, sampling_params=SamplingParams(**sp))
        assert t["output_ids"] == j["output_ids"]
        assert t["meta_info"]["cached_tokens"] == j["meta_info"]["cached_tokens"]
        outs.append(t)
    assert outs[1]["meta_info"]["cached_tokens"] > 0
    assert outs[0]["output_ids"] == outs[1]["output_ids"]
    assert teng.scheduler.n_spec_accepted == jeng.scheduler.n_spec_accepted
    assert teng.flush_cache()


@pytest.mark.parametrize("algo", ["chain", "small_tree"])
def test_fr_spec_token_map(tmp_path, algo):
    tmap = tmp_path / "hot.json"
    tmap.write_text(json.dumps(list(range(0, 64, 2))))  # even ids only
    jeng, teng = _engines(algo, speculative_token_map=str(tmap))  # the map is the runner's
    assert teng.runner.spec_hot_head.shape == (CFG["hidden_size"], 32)
    sp = dict(max_new_tokens=16, temperature=0.0, ignore_eos=True)
    j = jeng.generate(input_ids=_prompts()[:2], sampling_params=JaxSamplingParams(**sp))
    t = teng.generate(input_ids=_prompts()[:2], sampling_params=SamplingParams(**sp))
    assert [o["output_ids"] for o in t] == [o["output_ids"] for o in j]
    assert teng.scheduler.n_spec_accepted == jeng.scheduler.n_spec_accepted
    assert teng.flush_cache()


def test_refresh_off():
    jeng, teng = _engines("small_tree", speculative_disable_draft_refresh=True)
    sp = dict(max_new_tokens=16, temperature=0.0, ignore_eos=True)
    j = jeng.generate(input_ids=_prompts()[:2], sampling_params=JaxSamplingParams(**sp))
    t = teng.generate(input_ids=_prompts()[:2], sampling_params=SamplingParams(**sp))
    assert [o["output_ids"] for o in t] == [o["output_ids"] for o in j]
    assert teng.scheduler.n_spec_accepted == jeng.scheduler.n_spec_accepted
    assert teng.runner.spec_counts["draft_decode"] == 0  # no refresh steps, no chain
    assert teng.flush_cache()


def test_sampled_requests_under_a_tree_take_chain_rounds():
    teng = Engine(ServerArgs(random_weights=True, device="cpu", **SERVE,
                             **ALGOS["small_tree"]), ModelConfig(**CFG), device="cpu")
    sp = SamplingParams(max_new_tokens=10, temperature=0.8, ignore_eos=True)
    outs = teng.generate(input_ids=_prompts()[:2], sampling_params=sp)
    assert all(len(o["output_ids"]) == 10 for o in outs)
    counts = teng.runner.spec_counts
    assert counts["verify"] > 0 and counts["draft_tree"] == 0 and counts["draft_decode"] > 0
    assert teng.flush_cache()
    # the pools go and come back, the draft pool with the target's
    assert teng.release_memory_occupation()
    assert teng.runner.kv_cache.buffer is None and teng.runner.draft_kv.buffer is None
    assert teng.resume_memory_occupation()
    assert teng.runner.draft_kv.buffer.shape[2] == teng.runner.kv_cache.buffer.shape[1]
    out = teng.generate(input_ids=_prompts()[0], sampling_params=sp)
    assert len(out["output_ids"]) == 10 and teng.flush_cache()


def test_refusals():
    """What the runner refuses, and what runs in place of the old refusals:
    NEXTN on a Llama target drafts with the llama EAGLE draft (as the JAX
    runner picks it), EAGLE on a DeepSeek target with NextN over a
    one-layer latent pool (speculative/nextn.py; test_torch_nextn.py holds
    it to JAX); a draft checkpoint (ROADMAP A13) and an unknown algorithm
    stay refused."""
    from semi_pd_tpu_torch.speculative.nextn import NextNDraftModel

    eng = Engine(ServerArgs(random_weights=True, device="cpu", speculative_algorithm="NEXTN",
                            **SERVE), ModelConfig(**CFG), device="cpu")
    assert isinstance(eng.runner.draft_model, port_eagle.EagleDraftModel)
    assert eng.scheduler.spec_algo == "EAGLE"
    mla = ModelConfig(
        architecture="DeepseekV2ForCausalLM", vocab_size=64, hidden_size=64,
        intermediate_size=128, num_hidden_layers=1, num_attention_heads=2,
        num_key_value_heads=2, head_dim=192, max_position_embeddings=512,
        context_length=512, use_mla=True, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, dtype="float32")
    eng = Engine(ServerArgs(random_weights=True, device="cpu", speculative_algorithm="EAGLE",
                            **SERVE), mla, device="cpu")
    assert isinstance(eng.runner.draft_model, NextNDraftModel)
    assert tuple(eng.runner.draft_kv.buffer.shape) == (
        1, 1, eng.runner.kv_cache.buffer.shape[2], 1, 576)
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        Engine(ServerArgs(random_weights=True, device="cpu", speculative_algorithm="EAGLE",
                          speculative_draft_model_path="draft", **SERVE), ModelConfig(**CFG),
               device="cpu")
    with pytest.raises(ValueError, match="speculative_algorithm"):
        ServerArgs(speculative_algorithm="MEDUSA")


# ------------------------------------------------------------ rounds, direct
_MODELS = {}


def _models():
    """The JAX target and EAGLE draft (float32, the JAX ``init_params``
    numbers, made predictive) and the port's modules holding the same
    numbers; built once for the direct round tests."""
    if not _MODELS:
        from semi_pd_tpu.models.llama import LlamaForCausalLM as JaxLlama

        from semi_pd_tpu_torch.models.llama import LlamaForCausalLM

        jm, jd = JaxLlama(JaxModelConfig(**CFG)), jax_eagle.EagleDraftModel(
            JaxModelConfig(**CFG))
        params = jax.tree.map(np.array, jm.init_params(0))
        draft = jax.tree.map(np.array, jd.init_params(1))
        _predictive(params, draft)
        tm = LlamaForCausalLM(ModelConfig(**CFG), "cpu")
        tm.load_jax_params(params)
        td = port_eagle.EagleDraftModel(ModelConfig(**CFG), "cpu")
        td.load_jax_params(draft)
        _MODELS.update(jax=(jm, jd, jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, draft)), port=(tm, td))
    return _MODELS


def _round_state(tree=None, gamma=3, seed=5):
    """The same pools, weights and requests for both packages' round: a
    random target pool (chunked) and draft pool (5D), at the scale of the
    model's own K and V (0.01), requests of 20-50 committed positions on
    shuffled pages, random last tokens and hidden states, the predictive
    weights."""
    rng = np.random.default_rng(seed)
    n = tree.num_nodes if tree else gamma + 1
    port, jaxr, table, used = _host_state([20, 47, 31], n, seed)
    args = (table, 16, [1, 2, 4, 8], [8, 16])
    if tree:
        hb = port_batch.build_tree_verify_batch(port, tree, *args)
        jb = jax_batch.build_tree_verify_batch(jaxr, jax_tree_of(tree), *args)
    else:
        hb, _, _ = port_batch.build_spec_verify_batch(port, [[0] * gamma] * 3, gamma, *args)
        jb, _, _ = jax_batch.build_spec_verify_batch(jaxr, [[0] * gamma] * 3, gamma, *args)
    S = used * 16
    kv = rng.normal(size=(2, S, 8, 128)).astype(np.float32) * 0.01
    dkv = rng.normal(size=(1, 2, S, 8, 64)).astype(np.float32) * 0.01
    prev = rng.normal(size=(hb.B, CFG["hidden_size"])).astype(np.float32)
    return dict(**_models(), hb=hb, jb=jb, kv=kv, dkv=dkv, prev=prev)


def jax_tree_of(tree):
    from semi_pd_tpu.speculative.tree import build_tree_template

    return build_tree_template(tree.branching)


def _check_round(st, got, want, kv, dkv, jkv, jdkv):
    for a, b in zip(got[:3], want[:3]):  # accept_len, next_tok, tokens
        np.testing.assert_array_equal(a.numpy()[:3], np.asarray(b)[:3])
    np.testing.assert_allclose(got[3].numpy()[:3], np.asarray(want[3])[:3], atol=TOL,
                               rtol=TOL)
    # both pools, compaction and refresh included, but the dump page (slots
    # 0-15): the padded request's W rows all write its slot 0, a scatter
    # with repeated indices whose winner neither package defines
    np.testing.assert_allclose(kv.numpy()[:, 16:], np.asarray(jkv)[:, 16:], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(dkv.numpy()[:, :, 16:], np.asarray(jdkv)[:, :, 16:],
                               atol=TOL, rtol=TOL)


def test_draft_step_matches_jax():
    st = _round_state()
    (_, jd, _, jdp), (_, td) = st["jax"], st["port"]
    B, H = 4, CFG["hidden_size"]
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(B, H)).astype(np.float32) * 0.02
    hid = rng.normal(size=(B, H)).astype(np.float32)
    pos = np.array([20, 47, 31, 0], np.int32)
    slots = st["hb"].out_slots.reshape(st["hb"].B, -1)[:, 0].astype(np.int32)
    pt = st["hb"].page_table
    from semi_pd_tpu.ops.attention.ragged_paged_attention import AttnMeta as JMeta

    ar = np.arange(B, dtype=np.int32)
    jm = JMeta(jnp.ones(B, jnp.int32), jnp.asarray(pos), jnp.asarray(ar), jnp.asarray(ar),
               jnp.zeros(B, jnp.int32))
    jh, jdkv = jd.step(
        jdp, jnp.asarray(emb), jnp.asarray(hid), jnp.asarray(st["dkv"]),
        jnp.asarray(pos), jnp.asarray(slots), jnp.asarray(pt), jnp.asarray(pos + 1), jm)
    dkv = torch.from_numpy(st["dkv"].copy())
    th = td.step(torch.from_numpy(emb), torch.from_numpy(hid), dkv,
                             torch.from_numpy(pos), torch.from_numpy(slots),
                             torch.from_numpy(pt), torch.from_numpy(pos + 1),
                             port_eagle._decode_meta(torch.from_numpy(pos)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dkv.numpy(), np.asarray(jdkv), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("refresh", [True, False])
def test_eagle_round_matches_jax(refresh):
    st = _round_state(gamma=3)
    (jm, jd, jp, jdp), (tm, td) = st["jax"], st["port"]
    kv, dkv = torch.from_numpy(st["kv"].copy()), torch.from_numpy(st["dkv"].copy())
    got = port_eagle.eagle_round(tm, td, kv, dkv,
                                 st["hb"].to_device("cpu"), torch.from_numpy(st["prev"]), 3,
                                 torch.Generator().manual_seed(0), refresh=refresh)
    want = jax_eagle.eagle_round(jm, jd, jp, jdp,
                                 (jnp.asarray(st["kv"]),), jnp.asarray(st["dkv"]),
                                 st["jb"].to_device(jax.random.PRNGKey(0)),
                                 jnp.asarray(st["prev"]), 3, refresh=refresh)
    _check_round(st, got, want, kv, dkv, want[5][0], want[6])
    assert int(got.accept_len[:3].sum()) > 0  # drafts were accepted


@pytest.mark.parametrize("refresh", [True, False])
def test_eagle_tree_round_matches_jax(refresh):
    tree = default_tree_template(3, 3)  # branching (3, 1, 1): 10 nodes
    st = _round_state(tree=tree)
    (jm, jd, jp, jdp), (tm, td) = st["jax"], st["port"]
    kv, dkv = torch.from_numpy(st["kv"].copy()), torch.from_numpy(st["dkv"].copy())
    got = port_eagle.eagle_tree_round(tm, td, kv, dkv,
                                      st["hb"].to_device("cpu"),
                                      torch.from_numpy(st["prev"]), tree, refresh=refresh)
    want = jax_eagle.eagle_tree_round(jm, jd, jp, jdp,
                                      (jnp.asarray(st["kv"]),), jnp.asarray(st["dkv"]),
                                      st["jb"].to_device(jax.random.PRNGKey(0)),
                                      jnp.asarray(st["prev"]), jax_tree_of(tree),
                                      refresh=refresh)
    _check_round(st, got, want, kv, dkv, want[5][0], want[6])
    assert int(got.accept_len[:3].sum()) > 0  # a path was accepted and compacted
