"""The port's speculating rounds replayed from round graphs
(runtime/cuda_graph_runner.py ``RoundGraphs``), on the CPU.

Graphs cannot be captured on a CPU, so the runners here take
``EagerRounds``, an injected capture-and-replay object that runs the
captured body eagerly over the same static buffers (a replay writes its
graph's output tensors, as a CUDA graph replay does). The card's own
capture is held against the eager round in tests/test_torch_cuda.py and in
chip_smoke.py phase 3r; the Engine on round graphs is held against the
JAX Engine in the parity tests of tests/test_torch_speculative.py and
tests/test_torch_nextn.py.

What is checked: the round keys (one per kind, batch bucket, maxP bucket,
gamma or tree; a second batch of a key does not capture again; sampling
and greedy rounds keyed apart); every round kind through its graph against
the eager round on the same pools, weights and generator state: EAGLE
chain and tree on a Llama target (the chunked pool, the draft's 5D pool),
NextN chain and tree on a DeepSeek-V2-Lite-shaped and a MiniCPM3-shaped
target (latent pools, MoE and longrope), NGRAM's verify with short drafts:
accept_len, next_tok, tokens and next_hidden equal exactly, and both pools
equal after the round but their dump page (the padded rows' scatter to one
slot, whose winner no order defines on the card); a sampling chain round
advancing the generator as the eager one does; the round graphs dropped by
new thresholds, a new routing of either pool, and the pools released and
re-made; the packed and the device forms of a verify batch giving
``to_device``'s arrays; ``_commit_spec``'s single readback; the warm-up
capturing the round keys of the decode buckets.

Models: float32, 2-3 layers, vocab 64-128, weights made predictive (the
target's final norm ones and its embedding x 4, the draft passing the
token embedding through), so that drafts are accepted and the tree's
compaction and the refresh run. Besides: Gemma-2's shape (head_dim 256,
softcaps, a window of 8 that cuts), fp8_e4m3 pools, an FR-Spec hot
vocabulary and the 29-node tree.
"""

import numpy as np
import pytest
import torch

from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.kernels import record_launches
from semi_pd_tpu_torch.layers.attention import pool_attention
from semi_pd_tpu_torch.runtime import batch as port_batch
from semi_pd_tpu_torch.runtime.cuda_graph_runner import RoundGraphs, RoundShape
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import num_q_blocks
from semi_pd_tpu_torch.runtime.req import Req
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams
from semi_pd_tpu_torch.speculative.nextn import NextNDraftModel
from semi_pd_tpu_torch.utils import warmup

PS = 16
TARGETS = {
    # test_torch_speculative.py's: Hkv 8, head_dim 64, the chunked pool
    "llama": dict(architecture="LlamaForCausalLM", vocab_size=64, hidden_size=256,
                  intermediate_size=512, num_hidden_layers=2, num_attention_heads=8,
                  num_key_value_heads=8, head_dim=64, max_position_embeddings=512,
                  context_length=512, rope_theta=10000.0, dtype="float32"),
    # test_torch_nextn.py's DeepSeek-V2-Lite shape: MLA, a dense first layer
    # and an MoE one (the NextN draft mirrors the MoE layer)
    "deepseek": dict(architecture="DeepseekV2ForCausalLM", vocab_size=64, hidden_size=48,
                     intermediate_size=64, moe_intermediate_size=32, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
                     q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8,
                     v_head_dim=16, num_experts=4, num_experts_per_tok=2,
                     num_shared_experts=1, first_k_dense_replace=1, moe_layer_freq=1,
                     max_position_embeddings=512, context_length=512,
                     tie_word_embeddings=False, use_mla=True, head_dim=24, dtype="float32"),
    # test_torch_minicpm3_spec.py's MiniCPM3 shape, with longrope on its pe head
    "minicpm3": dict(architecture="MiniCPM3ForCausalLM", vocab_size=128, hidden_size=64,
                     intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=4, head_dim=24, rms_norm_eps=1e-6,
                     max_position_embeddings=256, context_length=256, rope_theta=10000.0,
                     rope_scaling=dict(type="longrope", original_max_position_embeddings=128,
                                       short_factor=[1.0, 1.5, 2.0, 3.0],
                                       long_factor=[1.2, 2.5, 4.0, 6.0]),
                     use_mla=True, q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
                     qk_rope_head_dim=8, v_head_dim=16, scale_emb=4.0, scale_depth=1.4,
                     dim_model_base=32, tie_word_embeddings=False, dtype="float32"),
    # test_torch_gemma2_spec.py's Gemma-2 shape: head_dim 256 (the draft's
    # 5D pool too), softcaps, a window of 8 on the even layers
    "gemma2": dict(architecture="Gemma2ForCausalLM", hidden_act="gelu_pytorch_tanh",
                   vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=256,
                   max_position_embeddings=256, context_length=256, rope_theta=10000.0,
                   rms_norm_eps=1e-6, query_pre_attn_scalar=64, sliding_window=8,
                   attn_logit_softcap=0.05, logit_softcap=0.5, dtype="float32"),
}
# a tree engine runs every kind: tree rounds, chain rounds (a sampling
# batch takes them in serving) and NGRAM's verify (the target alone)
GAMMA = 3
SPEC = dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=GAMMA,
            speculative_eagle_topk=2)  # branching (2, 1, 1), 7 nodes
SERVE = dict(page_size=PS, max_total_tokens=4096, chunked_prefill_size=64,
             decode_bs_buckets=[2, 4, 8])


class EagerRounds:
    """Capture and replay that run the body eagerly: ``capture`` runs it
    once for output tensors of the right shapes; ``replay`` runs it again
    and writes those tensors, launching nothing that counts."""

    def warmup(self, body):
        body()

    def capture(self, body):
        outputs = tuple(t.clone() for t in body())
        return (body, outputs), outputs

    def replay(self, handle):
        body, outputs = handle
        with record_launches():
            for out, t in zip(outputs, body()):
                out.copy_(t)

    def pool_bytes(self):
        return 0  # no graph memory on the CPU


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    many small ops from stalling when the test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_predictive(runner, gain=4.0):
    """The target's final norm ones (Gemma-2's (1 + w) at w = 0) and its
    embedding x ``gain``; the draft's fc (NextN: eh_proj, its norms ones)
    passing the token embedding through with 0.01 of the fed hidden state:
    the target's argmax follows the last token, and so does the draft's
    (chip_smoke.py's ``make_predictive``)."""
    H = runner.model_config.hidden_size
    gemma = runner.model_config.architecture == "Gemma2ForCausalLM"
    with torch.no_grad():
        runner.model.leaf("final_norm").fill_(0.0 if gemma else 1.0)
        runner.model.leaf("embed.w").mul_(gain)
        draft = runner.draft_model
        nextn = isinstance(draft, NextNDraftModel)
        fc = draft.leaf("eh_proj.w" if nextn else "fc.w")
        fc[H:] *= 0.01
        fc[:H] = torch.eye(H, dtype=fc.dtype)
        if nextn:
            for k in ("enorm", "hnorm", "head_norm"):
                draft.leaf(k).fill_(1.0)
    runner.set_spec_thresholds()


def _engine(target="llama", graphs=True, **extra):
    """A CPU Engine for ``target`` speculating with the (2, 1, 1) tree (the
    runner picks NextN for a DeepSeek target, MiniCPM3 included), on
    predictive weights, its rounds through ``EagerRounds`` graphs."""
    sa = ServerArgs(random_weights=True, device="cpu", **{**SERVE, **SPEC, **extra})
    eng = Engine(sa, ModelConfig(**TARGETS[target]), device="cpu")
    assert eng.runner.round_graphs is None  # a CPU runner never captures
    make_predictive(eng.runner)
    if graphs:
        eng.runner.round_graphs = RoundGraphs(eng.runner, EagerRounds())
    return eng


def _fill_pools(runner, seed):
    g = torch.Generator().manual_seed(seed)
    for buf in (runner.kv_cache.buffer, runner.draft_kv.buffer):
        buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)


def _requests(eng, lens, seed, temperature=0.0):
    """Requests with the given committed KV lengths on pages from the
    allocator (covering the tree's window), random last tokens."""
    runner = eng.runner
    rng = np.random.default_rng(seed)
    vocab = runner.model_config.vocab_size
    reqs = []
    for i, n in enumerate(lens):
        r = Req(rid=f"r{seed}-{i}", input_ids=rng.integers(0, vocab, size=int(n)).tolist(),
                sampling_params=SamplingParams(temperature=temperature))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(int(n) + 32) // PS))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = r.prompt_len
        r.output_ids.append(int(rng.integers(0, vocab)))
        reqs.append(r)
    return reqs


def _round(eng, kind, reqs, seed):
    """A round of ``kind`` over ``reqs`` as the scheduler builds it: a
    function running it through the runner's host form, and its batch.
    NGRAM's drafts: ``_ngram_drafts``."""
    runner, s = eng.runner, eng.scheduler
    rng = np.random.default_rng(seed)
    H = runner.model_config.hidden_size
    table = runner.req_pool.page_table
    if kind == "tree":
        hb = port_batch.build_tree_verify_batch(reqs, runner.tree_template, table, PS,
                                                s.b_buckets, s.p_buckets)
    else:
        drafts = (_ngram_drafts(reqs, seed) if kind == "ngram"
                  else [[0] * GAMMA] * len(reqs))
        hb, dp, dl = port_batch.build_spec_verify_batch(reqs, drafts, GAMMA, table, PS,
                                                        s.b_buckets, s.p_buckets)
    prev = rng.normal(size=(hb.B, H)).astype(np.float32)
    if kind == "chain":
        return (lambda: runner.eagle_step_host(hb, prev, GAMMA)), hb
    if kind == "tree":
        return (lambda: runner.eagle_tree_step_host(hb, prev)), hb
    return (lambda: runner.spec_step_host(hb, dp, dl, GAMMA)), hb


def _live(pool):
    """The pool but its dump page (slots 0 to PS - 1, on the slot axis)."""
    return pool[:, PS:] if pool.dim() == 4 else pool[:, :, PS:]


def _graph_vs_eager(runner, call):
    """``call`` eagerly, then, from the same pools and generator state,
    through the round graphs: returns (graph outputs, eager outputs) after
    checking that they, both pools and the generator's state after each
    are equal."""
    pools = [runner.kv_cache.buffer, runner.draft_kv.buffer]
    start = [p.clone() for p in pools]
    state = runner.generator.get_state()
    graphs, runner.round_graphs = runner.round_graphs, None
    try:
        want = call()
    finally:
        runner.round_graphs = graphs
    want_pools = [p.clone() for p in pools]
    want_state = runner.generator.get_state()
    for p, s in zip(pools, start):
        p.copy_(s)
    runner.generator.set_state(state)
    got = call()
    assert len(got) == len(want) in (2, 4)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for p, w in zip(pools, want_pools):
        assert torch.equal(_live(p), _live(w))
    assert torch.equal(runner.generator.get_state(), want_state)
    return got, want


# ------------------------------------------------------------------ keys
@pytest.mark.parametrize("kind", ["chain", "tree", "ngram"])
def test_round_keys(kind):
    """One graph per (kind, B bucket, maxP bucket, gamma or tree): its key
    is the verify batch's packed shapes with the round's options; a second
    batch of the key (other lengths, pages and tokens) replays without a
    capture; another B bucket and another maxP bucket capture their own; a
    sampling chain round (every row sampling) is keyed apart from a greedy
    one of the same shapes."""
    eng = _engine()
    runner = eng.runner
    _fill_pools(runner, 0)
    rg = runner.round_graphs
    W = runner.tree_template.num_nodes if kind == "tree" else GAMMA + 1
    cases = [([20, 47, 31], 4), ([33, 5, 60], 4), ([12, 40], 2), ([200, 9, 17], 4)]
    for i, (lens, B) in enumerate(cases):
        call, hb = _round(eng, kind, _requests(eng, lens, seed=i), seed=i)
        call()
        assert hb.B == B and hb.T == B * W
        spec = runner.tree_template.branching if kind == "tree" else GAMMA
        draft = kind != "ngram"
        key = RoundShape(kind, hb.T, hb.B, hb.maxP, num_q_blocks(hb.T, hb.B), True, spec,
                         refresh=draft, hot=False,
                         hidden=runner.model_config.hidden_size if draft else 0)
        assert key in rg.graphs
    # the first two share a key; the third has another B bucket, the last
    # another maxP bucket (a request of 200 positions)
    assert rg.stats["captures"] == len(rg.graphs) == 3 and rg.stats["replays"] == 4
    assert sorted({(k.B, k.maxP) for k in rg.graphs}) == [(2, 8), (4, 8), (4, 32)]
    if kind == "chain":
        call, hb = _round(eng, kind, _requests(eng, [20, 47, 31], 9, temperature=1.0), seed=9)
        call()
        assert sorted(k.all_greedy for k in rg.graphs if (k.B, k.maxP) == (4, 8)) == [
            False, True]


# ------------------------------------------------------------------ rounds
# (target, kind, server options)
ROUND_CASES = {
    "llama-chain": ("llama", "chain", {}), "llama-tree": ("llama", "tree", {}),
    "llama-ngram": ("llama", "ngram", {}),
    "llama-tree29": ("llama", "tree", dict(speculative_num_draft_tokens=4,
                                            speculative_eagle_topk=4)),
    "llama-chain-fp8": ("llama", "chain", dict(kv_cache_dtype="fp8_e4m3")),
    "llama-tree-fp8": ("llama", "tree", dict(kv_cache_dtype="fp8_e4m3")),
    "llama-chain-hot": ("llama", "chain", dict(speculative_token_map="hot")),
    "llama-tree-hot": ("llama", "tree", dict(speculative_token_map="hot")),
    "deepseek-chain": ("deepseek", "chain", {}), "deepseek-tree": ("deepseek", "tree", {}),
    "deepseek-tree-fp8": ("deepseek", "tree", dict(kv_cache_dtype="fp8_e4m3")),
    "minicpm3-chain": ("minicpm3", "chain", {}), "minicpm3-tree": ("minicpm3", "tree", {}),
    "gemma2-chain": ("gemma2", "chain", {}), "gemma2-tree": ("gemma2", "tree", {}),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_graph_round_equals_the_eager_round(case, tmp_path):
    """Each round kind through its graph gives the eager round's accept
    lengths, tokens, next tokens and hidden states exactly, and leaves both
    pools as the eager round does, on two batches of one key; drafts are
    accepted in both, so the tree's compaction and the refresh ran."""
    target, kind, extra = ROUND_CASES[case]
    if extra.get("speculative_token_map"):  # the even token ids
        tmap = tmp_path / "hot.json"
        tmap.write_text(str(list(range(0, TARGETS[target]["vocab_size"], 2))))
        extra = dict(extra, speculative_token_map=str(tmap))
    eng = _engine(target, **extra)
    if kind == "tree":
        W = 29 if "tree29" in case else 7
        assert eng.runner.tree_template.num_nodes == W
    runner = eng.runner
    accepted = 0
    for seed, lens in ((1, [20, 47, 31]), (2, [60, 9, 38, 25])):
        _fill_pools(runner, seed)
        call, _ = _round(eng, kind, _requests(eng, lens, seed), seed)
        got, _ = _graph_vs_eager(runner, call)
        accepted += int(got[0].sum())
    (key,) = runner.round_graphs.graphs
    assert key.hot == ("hot" in case)
    assert runner.round_graphs.stats["captures"] == 1
    assert runner.round_graphs.stats["replays"] == 2
    assert accepted > 0


def test_refresh_off_is_keyed_and_replayed():
    """The tree round without the draft refresh: its own key, and the
    replay equals the eager round."""
    eng = _engine(speculative_disable_draft_refresh=True)
    _fill_pools(eng.runner, 3)
    call, _ = _round(eng, "tree", _requests(eng, [20, 47, 31], 3), 3)
    _graph_vs_eager(eng.runner, call)
    assert [k.refresh for k in eng.runner.round_graphs.graphs] == [False]


def test_sampling_chain_round_advances_the_generator():
    """A chain round of sampling rows draws what the eager round draws from
    the same generator state and advances it as far; the next replay draws
    anew."""
    eng = _engine()
    runner = eng.runner
    _fill_pools(runner, 4)
    call, _ = _round(eng, "chain", _requests(eng, [20, 47, 31], 4, temperature=1.0), 4)
    _graph_vs_eager(runner, call)
    state = runner.generator.get_state()
    call()
    after = runner.generator.get_state()
    assert not torch.equal(after, state)
    runner.generator.set_state(state)
    graphs, runner.round_graphs = runner.round_graphs, None
    call()
    runner.round_graphs = graphs
    assert torch.equal(runner.generator.get_state(), after)


# ------------------------------------------------------------------ drops
def test_round_graphs_are_dropped_where_their_captures_change():
    """New acceptance thresholds (constants of the JAX round's trace), a
    new routing of the target or the draft pool, and the pools released
    and re-made each drop the round graphs; the next round captures anew
    and still equals the eager round. The decode graphs' own routing rule
    stands: a draft routing leaves them."""
    eng = _engine()
    runner = eng.runner
    rg = runner.round_graphs

    def capture():
        _fill_pools(runner, 5)
        call, _ = _round(eng, "chain", _requests(eng, [20, 47], 5), 5)
        _graph_vs_eager(runner, call)
        assert len(rg.graphs) == 1

    capture()
    runner.set_spec_thresholds(single=0.5)
    assert not rg.graphs
    capture()
    runner.attention = pool_attention(runner.kv_cache.buffer, plain=True)
    assert not rg.graphs
    capture()
    runner.attention = runner.attention  # the same routing: kept
    assert len(rg.graphs) == 1
    runner.draft_attention = pool_attention(runner.draft_kv.buffer, plain=True)
    assert not rg.graphs
    capture()
    runner.release_kv_memory()
    assert not rg.graphs and runner.kv_cache.buffer is None
    runner.resume_kv_memory()
    assert not rg.graphs
    capture()


# ------------------------------------------------------------------ batches
@pytest.mark.parametrize("kind", ["chain", "tree", "ngram"])
def test_packed_round_batch_gives_to_device_arrays(kind):
    """A verify batch's packed vectors, unpacked in the round's layout,
    give every array ``to_device`` gives (a tree's slot-order positions and
    window starts, a logits row per verify row, the work list), and NGRAM's
    drafts and lengths after them; a round given on the device fills the
    key's buffers with the same values as its host form, and replays its
    graph."""
    eng = _engine()
    runner = eng.runner
    _fill_pools(runner, 6)
    reqs = _requests(eng, [20, 47, 31], 6)
    call, hb = _round(eng, kind, reqs, 6)
    call()
    (shape, g), = runner.round_graphs.graphs.items()
    fb, prev, drafts, lens = runner._unpack_round(g.ints, g.floats, shape)
    want = hb.to_device("cpu")
    names = ["input_ids", "q_req_idx", "q_pos", "out_slots", "page_table", "kv_lens",
             "logits_idx", "mask_pos", "win_base"]
    for n in names:
        a, b = getattr(fb, n), getattr(want, n)
        assert (a is None) == (b is None) == (kind != "tree" and n in ("mask_pos", "win_base"))
        assert a is None or torch.equal(a, b), n
    for a, b in zip(list(fb.attn_meta) + list(fb.sampling),
                    list(want.attn_meta) + list(want.sampling)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert shape.n_ints() == len(g.ints) and shape.n_floats() == len(g.floats)
    if kind == "ngram":
        _, dp, dl = port_batch.build_spec_verify_batch(
            reqs, _ngram_drafts(reqs, 6), GAMMA, runner.req_pool.page_table,
            PS, eng.scheduler.b_buckets, eng.scheduler.p_buckets)
        assert prev is None and torch.equal(drafts, torch.from_numpy(dp))
        assert torch.equal(lens, torch.from_numpy(dl))
    else:
        assert drafts is None and prev.shape == (hb.B, runner.model_config.hidden_size)
    # the device form: the same buffers (but the packed request count, which
    # no round reads), the same graph
    host_ints, host_floats = g.ints.clone(), g.floats.clone()
    extra = [None if t is None else t.clone() for t in (prev, drafts, lens)]
    with torch.inference_mode():  # the buffers are inference tensors
        g.ints.zero_(), g.floats.zero_()
    if kind == "chain":
        runner.eagle_step(want, extra[0], GAMMA)
    elif kind == "tree":
        runner.eagle_tree_step(want, extra[0])
    else:
        runner.spec_step(want, extra[1], extra[2], GAMMA)
    n = port_batch.pack_len(shape.T, shape.B, shape.maxP, shape.NQB, shape.T,
                            tree=kind == "tree") - 1
    assert int(host_ints[n]) == len(reqs) and int(g.ints[n]) == 0
    assert torch.equal(g.ints[:n], host_ints[:n]) and torch.equal(g.ints[n + 1:],
                                                                  host_ints[n + 1:])
    assert torch.equal(g.floats, host_floats)
    assert runner.round_graphs.stats["captures"] == 1


def _ngram_drafts(reqs, seed):
    """NGRAM drafts of 0 to gamma tokens: the last token repeated (which
    the predictive target accepts) for every other request, random tokens
    for the rest."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for i, r in enumerate(reqs):
        n = int(rng.integers(0, GAMMA + 1))
        out.append([r.output_ids[-1]] * n if i % 2 == 0
                   else rng.integers(0, 64, size=n).tolist())
    return out


# ------------------------------------------------------------------ scheduler
@pytest.mark.parametrize("kind", ["chain", "ngram"])
def test_commit_spec_reads_a_round_with_one_copy(kind, monkeypatch):
    """``_commit_spec`` brings a round's accept lengths, next tokens,
    drafts (NGRAM's are the host's already) and hidden states back in one
    device->host copy, and commits what the four readbacks it replaced
    would have committed."""
    eng = _engine()
    runner, sched = eng.runner, eng.scheduler
    _fill_pools(runner, 7)
    reqs = _requests(eng, [20, 47, 31], 7)
    call, hb = _round(eng, kind, reqs, 7)
    out = call()
    drafts = out[2] if kind == "chain" else _ngram_padded(hb, reqs)
    want = [(r.rid, list(map(int, d[: int(a)])) + [int(t)])
            for r, a, t, d in zip(reqs, out[0].numpy(), out[1].numpy(), np.asarray(drafts))]
    calls = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: calls.append(1) or cpu(
        self, *a, **k))
    for r in reqs:
        r.sampling_params.max_new_tokens = 64
    sched.running = list(reqs)
    got = sched._commit_spec(hb.reqs, out[0], out[1], drafts, *out[3:])
    assert len(calls) == 1
    by_req = {}
    for r, t in got:
        by_req.setdefault(r.rid, []).append(t)
    assert [(r.rid, by_req[r.rid]) for r in reqs] == want
    if kind == "chain":
        assert all(np.array_equal(r.spec_hidden, out[3][i].numpy())
                   for i, r in enumerate(reqs))


def _ngram_padded(hb, reqs):
    _, dp, _ = port_batch.build_spec_verify_batch(
        reqs, _ngram_drafts(reqs, 7), GAMMA, np.zeros((64, 64), np.int32), PS,
        [hb.B], [hb.maxP])
    return dp


def test_all_buckets_warmup_captures_the_round_keys():
    """The warm-up's decode batches speculate on a speculating runner: each
    decode bucket up to max_running_requests gets its tree round's key (at
    the smallest maxP bucket), as the decode graphs get theirs on a plain
    runner."""
    eng = _engine(max_running_requests=4)
    warmup.execute_warmups(["all_buckets"], eng)
    keys = eng.runner.round_graphs.graphs
    assert sorted(k.B for k in keys) == [2, 4]
    assert {(k.kind, k.maxP) for k in keys} == {("tree", eng.scheduler.p_buckets[0])}
    assert eng.runner.round_graphs.stats["replays"] >= 2 and eng.flush_cache()


def test_pool_reserve_counts_the_round_verify(monkeypatch):
    """On the card the KV pool is sized from free memory less the graphs'
    pool: a speculating runner's holds its round's verify logits, B x W
    rows of float32 at the largest decode bucket (5 such copies; W the
    tree's nodes, or gamma + 1), where they exceed the decode graphs' 9
    rows a request (a decode step with a mask and penalties); and the
    masked steps' static inputs, a float32 bias and a bool mask [B, V] and
    the penalty histogram [B, 512] (two int32 arrays, one bool), for every
    decode bucket."""
    import types

    from semi_pd_tpu_torch.runtime.model_runner import ModelRunner

    cfg = ModelConfig(**TARGETS["llama"])
    free = 40 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 80 * 2 ** 30))
    V, per_token = 64, 3 * 8 * 64 * 4 * 2  # 2 layers + the draft's, K and V
    static = (2 + 8) * (V * (4 + 1) + 512 * (4 + 4 + 1))
    for spec, rows in (({}, 9 * 8), (dict(speculative_algorithm="NGRAM"), 5 * 8 * 5),
                       (dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=4,
                             speculative_eagle_topk=4), 5 * 8 * 29),
                       (dict(speculative_algorithm="EAGLE", speculative_num_draft_tokens=1),
                        5 * 8 * 2)):
        args = ServerArgs(random_weights=True, mem_fraction_static=0.5,
                          decode_bs_buckets=[2, 8], **spec)
        stub = types.SimpleNamespace(model_config=cfg, device=torch.device("cuda"),
                                     _graphs_on=True, draft_model=object(), server_args=args)
        stub._graph_pool_reserve = lambda s=stub: ModelRunner._graph_pool_reserve(s)
        assert ModelRunner._graph_pool_reserve(stub) == rows * V * 4 + static
        got = ModelRunner._profile_kv_tokens(stub, torch.float32)
        assert got == max(int((free - rows * V * 4 - static) * 0.5 // per_token), 4096)
