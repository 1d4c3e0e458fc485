"""The port's decode graphs (runtime/cuda_graph_runner.py), its warmup
registry (utils/warmup.py), bench_one_batch and the MoE's device-side
expert count, on the CPU.

Graphs cannot be captured on a CPU, so the runner's graphs here take
``EagerGraphs``, an injected capture-and-replay object that runs the
captured body eagerly over the same static buffers (a replay writes its
graph's output tensors, as a CUDA graph replay does). The card's own
capture is held against the eager step in tests/test_torch_cuda.py and in
chip_smoke.py.

Test model: the engine parity test's (2 layers, hidden 256, Hq 8, Hkv 2,
D 64, vocab 512, float32). Greedy tokens must be equal exactly, log-probs
within rtol 1e-5 / atol 1e-5 (test_torch_model.py's).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_pd_tpu.config.model_config import ModelConfig as JaxModelConfig
from semi_pd_tpu.config.server_args import ServerArgs as JaxServerArgs
from semi_pd_tpu.runtime import batch as jax_batch
from semi_pd_tpu.runtime.engine import Engine as JaxEngine
from semi_pd_tpu.runtime.req import Req as JaxReq
from semi_pd_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from semi_pd_tpu.utils import warmup as jax_warmup

from semi_pd_tpu_torch import bench_one_batch
from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs
from semi_pd_tpu_torch.kernels import KERNELS, CudaKernel, record_launches, register
from semi_pd_tpu_torch.ops import moe
from semi_pd_tpu_torch.runtime.batch import build_decode_batch
from semi_pd_tpu_torch.runtime.cuda_graph_runner import DecodeGraphs, decode_key
from semi_pd_tpu_torch.runtime.engine import Engine
from semi_pd_tpu_torch.runtime.forward_batch import num_q_blocks
from semi_pd_tpu_torch.runtime.req import Req
from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams
from semi_pd_tpu_torch.utils import warmup

CFG = dict(architecture="LlamaForCausalLM", vocab_size=512, hidden_size=256,
           intermediate_size=512, num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=2, head_dim=64, max_position_embeddings=512,
           context_length=512, rope_theta=10000.0, dtype="float32")
SERVE = dict(page_size=16, max_total_tokens=2048, chunked_prefill_size=64)
PS = 16


class EagerGraphs:
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
            for dst, src in zip(outputs, body()):
                dst.copy_(src)

    def pool_bytes(self):
        return 0  # no graph memory on the CPU


def _engine(graphs: bool, **serve):
    eng = Engine(ServerArgs(random_weights=True, device="cpu", **dict(SERVE, **serve)),
                 ModelConfig(**CFG), device="cpu")
    assert eng.runner.graphs is None  # a CPU runner never captures
    if graphs:
        eng.runner.graphs = DecodeGraphs(eng.runner, EagerGraphs())
    return eng


def _decode_batch(eng, lens, seed=0):
    """A decode batch of requests with the given KV lengths, their pages
    allocated (shuffled by the allocator's state), last token random."""
    runner, sched = eng.runner, eng.scheduler
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(lens):
        r = Req(rid=f"d{seed}-{i}", input_ids=rng.integers(0, 512, size=int(n)).tolist(),
                sampling_params=SamplingParams(temperature=0.0))
        r.req_slot = runner.req_pool.alloc()
        pages = runner.page_allocator.alloc(-(-(int(n) + 1) // PS))
        r.pages = pages.tolist()
        runner.req_pool.write(r.req_slot, 0, pages)
        r.prefilled_len = r.prompt_len
        r.output_ids.append(int(rng.integers(0, 512)))
        reqs.append(r)
    return build_decode_batch(reqs, runner.req_pool.page_table, PS, sched.b_buckets,
                              sched.p_buckets)


def _fill_pool(eng, seed=0):
    g = torch.Generator().manual_seed(seed)
    buf = eng.runner.kv_cache.buffer
    buf.copy_(torch.randn(buf.shape, generator=g))


def _eager(runner, *args, **kw):
    graphs, runner.graphs = runner.graphs, None
    try:
        return runner.step_packed_raw(*args, **kw)
    finally:
        runner.graphs = graphs


# ------------------------------------------------------------------ keys
@pytest.mark.parametrize("p_index", [0, 1, 2, 3])
@pytest.mark.parametrize("b_bucket", [8, 32, 64])
def test_decode_key_is_the_packed_decode_shape(b_bucket, p_index):
    """At decode buckets 8/32/64 and every maxP bucket, the graph key is
    (B, maxP, NQB) of the port's build_decode_batch + pack; B and maxP are
    the JAX package's for the same requests, T == B in both, and the two
    packed steps agree up to the work list."""
    sa = ServerArgs(random_weights=True, device="cpu", page_size=PS, max_total_tokens=65536,
                    decode_bs_buckets=[8, 32, 64], context_length=8192)
    cfg = dict(CFG, context_length=8192, max_position_embeddings=8192)
    eng = Engine(sa, ModelConfig(**cfg), device="cpu")
    p_buckets = eng.scheduler.p_buckets
    assert p_buckets == [8, 32, 128, 512]
    lo = (p_buckets[p_index - 1] if p_index else 0) * PS
    hi = p_buckets[p_index] * PS - 2
    n_reqs = b_bucket - 3  # a padded bucket
    rng = np.random.default_rng(b_bucket + p_index)
    lens = rng.integers(lo + 1, hi + 1, size=n_reqs)
    lens[0] = hi  # the longest request sets maxP
    reqs, jreqs = [], []
    for i, n in enumerate(lens):
        kw = dict(rid=f"k{i}", input_ids=[1] * int(n))
        r = Req(sampling_params=SamplingParams(temperature=0.0), **kw)
        jr = JaxReq(sampling_params=JaxSamplingParams(temperature=0.0), **kw)
        pages = list(range(1 + i * 512, 1 + i * 512 + -(-(int(n) + 1) // PS)))
        for x in (r, jr):
            x.pages = pages
            x.prefilled_len = int(n)
            x.output_ids.append(3)
        reqs.append(r)
        jreqs.append(jr)
    table = np.zeros((n_reqs, 512), np.int32)
    for i, r in enumerate(reqs):
        r.req_slot = jreqs[i].req_slot = i
        table[i, :len(r.pages)] = r.pages
    hb = build_decode_batch(reqs, table, PS, [8, 32, 64], p_buckets)
    jhb = jax_batch.build_decode_batch(jreqs, table, PS, [8, 32, 64], p_buckets)
    ints, floats, shapes = hb.pack()
    jints, jfloats, jshapes = jhb.pack()
    assert shapes[0] == shapes[1] == b_bucket and shapes[2] == p_buckets[p_index]
    # NQB is the work list's static length at each package's own extend
    # q-block (the port's kernels take 128 rows)
    assert decode_key(shapes, True) == (b_bucket, p_buckets[p_index],
                                        num_q_blocks(b_bucket, b_bucket), True)
    assert jshapes[0] == jshapes[1] == b_bucket and jshapes[2] == p_buckets[p_index]
    # the same step: every array up to the work list (ids, positions,
    # slots, page table, lengths, logits rows, q lengths and starts)
    head = 4 * b_bucket + b_bucket * shapes[2] + 4 * b_bucket
    np.testing.assert_array_equal(ints[:head], jints[:head])
    np.testing.assert_array_equal(floats, jfloats)
    with pytest.raises(ValueError, match="T == B"):
        decode_key((shapes[0] + 1, *shapes[1:]), True)


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("chained", [False, True], ids=["plain", "chained"])
def test_graph_step_equals_the_eager_step(chained):
    """A step through a key's static buffers gives the eager step's tokens
    and log-probs exactly, plain and chained, on two batches of one key
    (other lengths and pages): the second replay reads its own inputs."""
    eng = _engine(graphs=True)
    runner = eng.runner
    _fill_pool(eng)
    hb1 = _decode_batch(eng, [40, 3, 90, 17, 60], seed=1)
    hb2 = _decode_batch(eng, [70, 33, 5, 100, 8, 51], seed=2)
    prev = torch.tensor([7, 300, 12, 450, 99, 0, 0, 0], dtype=torch.int32)
    for hb in (hb1, hb2):
        ints, floats, shapes = hb.pack()
        kw = dict(chained=chained, prev_tokens=prev if chained else None, is_decode=True)
        want = _eager(runner, ints, floats, shapes, **kw)
        got = runner.step_packed_raw(ints, floats, shapes, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert runner.graphs.stats["captures"] == 1 and len(runner.graphs.graphs) == 1
    assert runner.graphs.stats["replays"] == 2


def test_chained_input_ids_come_from_prev_tokens():
    """A chained step embeds ``prev_tokens``, not the packed input ids: the
    static int vector's head holds them and the result equals the eager
    step with the override; without ``prev_tokens`` the runner's last
    decode tokens are chained."""
    eng = _engine(graphs=True)
    runner = eng.runner
    _fill_pool(eng)
    hb = _decode_batch(eng, [40, 3, 90, 17, 60], seed=3)
    ints, floats, shapes = hb.pack()
    B = shapes[1]
    first = runner.step_packed_raw(ints, floats, shapes, is_decode=True)
    g = next(iter(runner.graphs.graphs.values()))
    assert torch.equal(g.ints[:B], torch.from_numpy(ints[:B]))
    prev = torch.arange(100, 100 + B, dtype=torch.int32)
    got = runner.step_packed_raw(ints, floats, shapes, chained=True, prev_tokens=prev,
                                 is_decode=True)
    assert torch.equal(g.ints[:B], prev)
    want = _eager(runner, ints, floats, shapes, chained=True, prev_tokens=prev, is_decode=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plain = _eager(runner, ints, floats, shapes, is_decode=True)
    assert not torch.equal(got[1], plain[1])  # the override changed the inputs
    # chained without prev_tokens: the runner's carried tokens (the eager
    # step above set them)
    carried = runner._chain_tokens
    got = runner.step_packed_raw(ints, floats, shapes, chained=True, is_decode=True)
    assert torch.equal(g.ints[:B], carried)
    assert first[0].shape == (B,)


def test_a_replay_leaves_earlier_results_untouched():
    """The ring hazard: a replay overwrites its graph's outputs, so the
    tokens and log-probs a step returned must be its own tensors, still
    equal to what they were after later replays of the same key."""
    eng = _engine(graphs=True)
    runner = eng.runner
    _fill_pool(eng)
    hb1 = _decode_batch(eng, [40, 3, 90, 17, 60], seed=4)
    hb2 = _decode_batch(eng, [70, 33, 5, 100, 8, 51], seed=5)
    a = runner.step_packed_raw(*hb1.pack(), is_decode=True)
    kept = (a[0].clone(), a[1].clone())
    b = runner.step_packed_raw(*hb2.pack(), is_decode=True)
    g = next(iter(runner.graphs.graphs.values()))
    assert torch.equal(a[0], kept[0]) and torch.equal(a[1], kept[1])
    assert not torch.equal(a[1], b[1])
    for out, static in zip(b, g.outputs):
        assert out.data_ptr() != static.data_ptr() and torch.equal(out, static)


def test_capture_counts_nothing_and_replay_counts_its_launches(monkeypatch):
    """A capture adds no launch and no step; each replay adds the launches
    the capture recorded and one decode step; extend steps stay eager."""
    fake = register(CudaKernel("graph_test_kernel", "csrc/rpa_decode.cu", "x", [], "none"))
    fake._fn = lambda *a: 0
    try:
        eng = _engine(graphs=True)
        runner = eng.runner
        step = runner._step

        def counting_step(fb):
            for _ in range(3):
                fake.launch()
            return step(fb)

        monkeypatch.setattr(runner, "_step", counting_step)
        _fill_pool(eng)
        hb = _decode_batch(eng, [40, 3, 90], seed=6)
        runner.step_counts = {"decode": 0, "extend": 0}
        fake.launches = 0
        runner.step_packed_raw(*hb.pack(), is_decode=True)  # warm-up + capture + replay
        g = next(iter(runner.graphs.graphs.values()))
        assert g.tally == {"graph_test_kernel": 3}
        assert fake.launches == 3 and runner.step_counts == {"decode": 1, "extend": 0}
        runner.step_packed_raw(*hb.pack(), is_decode=True)
        assert fake.launches == 6 and runner.step_counts == {"decode": 2, "extend": 0}
        assert runner.graphs.stats["captures"] == 1 and runner.graphs.stats["replays"] == 2
        out = eng.generate(input_ids=[5, 6, 7], sampling_params=SamplingParams(
            max_new_tokens=3, temperature=0.0, ignore_eos=True))
        steps = runner.step_counts
        # eager extend steps launch through the wrapper; decode steps replay
        assert fake.launches == 3 * (steps["decode"] + steps["extend"])
        assert runner.graphs.stats["replays"] == steps["decode"]
        assert len(out["output_ids"]) == 3
    finally:
        del KERNELS["graph_test_kernel"]


def test_sampling_graphs_are_keyed_apart_and_advance_the_generator():
    """A batch with a sampling row takes another graph than an all-greedy
    batch of the same shapes (the eager step skips the sampler's sort for
    the latter); its replays draw as the eager step does from the same
    generator state, and the generator advances between replays."""
    eng = _engine(graphs=True)
    runner = eng.runner
    _fill_pool(eng)
    hb = _decode_batch(eng, [40, 3, 90, 17, 60], seed=7)
    ints, floats, shapes = hb.pack()
    runner.step_packed_raw(ints, floats, shapes, is_decode=True)
    floats = floats.copy()
    B = shapes[1]
    floats[:B] = 1.0  # temperature: every row samples
    state = runner.generator.get_state()
    want = _eager(runner, ints, floats, shapes, is_decode=True)
    runner.generator.set_state(state)
    got = runner.step_packed_raw(ints, floats, shapes, is_decode=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sorted(k[3] for k in runner.graphs.graphs) == [False, True]
    again = runner.step_packed_raw(ints, floats, shapes, is_decode=True)
    assert not torch.equal(again[0], got[0])  # new draws
    after = runner.generator.get_state()
    runner.generator.set_state(state)
    _eager(runner, ints, floats, shapes, is_decode=True)
    _eager(runner, ints, floats, shapes, is_decode=True)
    assert torch.equal(runner.generator.get_state(), after)


@pytest.mark.parametrize("semi_pd", [False, True], ids=["colocated", "semi_pd"])
def test_engine_on_graphs_serves_the_eager_tokens(semi_pd):
    """The engine with its decode steps through the graphs gives the eager
    engine's tokens and log-probs exactly, with chained (overlapped)
    decode steps and buckets that change as requests finish."""
    outs = []
    for graphs in (False, True):
        eng = _engine(graphs, enable_semi_pd=semi_pd)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 512, size=n).tolist() for n in (20, 100, 37, 5, 64)]
        sps = [SamplingParams(max_new_tokens=n, temperature=0.0, ignore_eos=True)
               for n in (6, 9, 3, 12, 7)]
        reqs = [eng.make_request(p, sp, return_logprob=True) for p, sp in zip(prompts, sps)]
        for r in reqs:
            eng.scheduler.add_request(r)
        eng._run_until_done(reqs)
        outs.append([(r.output_ids, r.output_logprobs) for r in reqs])
        if graphs:
            stats = eng.runner.graphs.stats
            assert stats["replays"] == eng.runner.step_counts["decode"] > 0
            assert stats["captures"] == len(eng.runner.graphs.graphs) >= 2
        assert eng.flush_cache()
    assert outs[0] == outs[1]


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize("seed,T,E,K", [(0, 37, 64, 6), (1, 5, 16, 2), (2, 1, 8, 8)])
def test_expert_counts_equal_bincount(seed, T, E, K):
    """The device-side count equals torch.bincount and
    jnp.bincount(length=E), experts with no rows included."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, E // 2, size=(T, K)).astype(np.int32)  # half the experts idle
    got = moe.expert_counts(torch.from_numpy(idx).reshape(-1), E)
    assert got.dtype == torch.int64 and got.shape == (E,)
    assert torch.equal(got, torch.bincount(torch.from_numpy(idx).reshape(-1).long(),
                                           minlength=E))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.bincount(
        jnp.asarray(idx.reshape(-1)), length=E)))
    assert int(got[E // 2:].sum()) == 0


def test_grouped_matmul_dense_equals_the_plain_loop():
    """The float32 grouped product of the card (every row times every
    expert, each row keeping its own) against the per-expert loop, with
    empty groups."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((23, 16), generator=g)
    w = torch.randn((6, 16, 12), generator=g)
    sizes = torch.tensor([5, 0, 9, 0, 9, 0])
    got = moe.grouped_matmul_dense(x, w, sizes)
    want = moe.grouped_matmul_plain(x, w, sizes)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ warmup
def test_warmup_registry_matches_the_jax_package(caplog):
    assert set(warmup._warmup_registry) == set(jax_warmup._warmup_registry)
    eng = _engine(graphs=False)
    with caplog.at_level("WARNING"):
        warmup.execute_warmups(["no_such_warmup"], eng)
    assert "no_such_warmup" in caplog.text


def test_all_buckets_captures_every_decode_bucket_up_to_max_running():
    eng = _engine(graphs=True, decode_bs_buckets=[1, 2, 4, 8, 16], max_running_requests=8)
    warmup.execute_warmups(["all_buckets"], eng)
    keys = set(eng.runner.graphs.graphs)
    assert {k[0] for k in keys} == {1, 2, 4, 8}
    assert all(k[1] == eng.scheduler.p_buckets[0] and k[3] for k in keys)
    assert eng.flush_cache()


class _Recording:
    """An engine as a warmup sees it, whose generations are kept."""

    def __init__(self, engine):
        self.engine = engine
        self.server_args = engine.server_args
        self.runner = engine.runner
        self.outputs = []

    def generate(self, **kw):
        out = self.engine.generate(return_logprob=True, **kw)
        self.outputs += out if isinstance(out, list) else [out]
        return out


@pytest.mark.parametrize("name", ["all_buckets", "voice_chat"])
def test_warmup_generations_match_jax(name):
    """The port's warmups (through the graphs) generate the JAX engine's
    greedy tokens on the engine parity test's config, the weights carried
    by load_jax_params; voice_chat samples, and only its lengths compare
    (a torch.Generator cannot replay jax.random's stream)."""
    serve = dict(SERVE, decode_bs_buckets=[1, 2, 4, 8], max_running_requests=8)
    jeng = JaxEngine(server_args=JaxServerArgs(model_path="", random_weights=True, **serve),
                     model_config=JaxModelConfig(**CFG))
    teng = _engine(graphs=True, decode_bs_buckets=[1, 2, 4, 8], max_running_requests=8)
    teng.runner.model.load_jax_params(jax.tree.map(np.asarray, jeng.runner.params))
    jrec, trec = _Recording(jeng), _Recording(teng)
    getattr(jax_warmup, name)(jrec)
    getattr(warmup, name)(trec)
    assert len(trec.outputs) == len(jrec.outputs) > 0
    for t, j in zip(trec.outputs, jrec.outputs):
        assert len(t["output_ids"]) == len(j["output_ids"])
        if name == "all_buckets":
            assert t["output_ids"] == j["output_ids"]
            np.testing.assert_allclose(t["meta_info"]["output_logprobs"],
                                       j["meta_info"]["output_logprobs"], rtol=1e-5,
                                       atol=1e-5)
    assert teng.runner.graphs.stats["replays"] == teng.runner.step_counts["decode"] > 0
    assert teng.flush_cache() and jeng.flush_cache()


# ------------------------------------------------------------------ bench
def test_bench_one_batch_on_the_cpu(capsys):
    out = bench_one_batch.main(["--batch-size", "2", "--input-len", "24", "--output-len", "4",
                                "--page-size", "16", "--device", "cpu"],
                               model_config=ModelConfig(**CFG))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert set(printed) == {"batch_size", "input_len", "output_len", "prefill_latency_s",
                            "prefill_throughput_tok_s", "median_decode_latency_s",
                            "decode_throughput_tok_s", "total_throughput_tok_s"}
    assert printed["batch_size"] == 2 and printed["decode_throughput_tok_s"] > 0
