"""The port's continuous-batching pool against the JAX package's
``ContinuousBatchingScheduler``, on the reduced qwen2.5-7b of
``tests/test_torch_engine.py`` with the same weights (through the weight
bridge) and the same requests.

Greedy tokens must be equal on every layout and option; logprobs agree
within ATOL_LOGPROB = 2e-5 (f32 on both sides, the same arithmetic in
another summation order through 4 layers and the head; observed <= 2.2e-6,
int8 and fp8 pools included — both sides encode and dequantize the same
codes, so quantized pools need no wider bound). Sampled requests cannot
match JAX's threefry bits: they are pinned against the port's own
``generate``, with and without speculative decoding. Speculative cases that
must accept drafts use ``ScriptedDrafter``, which proposes the known
continuation for a planned number of positions per tick: full, partial and
zero accepts all run, and the verify must accept exactly as planned."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.models import build_model
from repro.serving import FedAttnEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as JSched
from repro.types import FedAttnConfig as JFed
from repro_torch.checkpoint.bridge import params_from_numpy, pool_from_numpy
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.kernels import flash_decode as tfd
from repro_torch.serving import ContinuousBatchingScheduler as TSched
from repro_torch.serving import Request as TRequest
from repro_torch.serving.engine import FedAttnEngine as TEngine
from repro_torch.serving.spec import ScriptedDrafter
from repro_torch.types import FedAttnConfig as TFed

ATOL_LOGPROB = 2e-5


@pytest.fixture(scope="module")
def model():
    tc, jc = t_reduced("qwen2.5-7b"), j_reduced("qwen2.5-7b")
    jp = build_model(jc).init(jax.random.key(0))
    return tc, jc, params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu"), jp


def _prompts(seed, lens, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lens]


def _shared_prefix(sys_len, tails, seed=1):
    rng = np.random.default_rng(seed)
    stem = rng.integers(0, 512, sys_len)
    return [np.concatenate([stem, rng.integers(0, 512, t)]).astype(np.int32) for t in tails]


MIXED = (_prompts(0, [24, 17, 30, 9, 11]), [8, 5, 3, 12, 2])
# name: (prompts, n_new, fedattn kwargs, scheduler kwargs)
CASES = {
    "paged": (*MIXED, {}, dict(max_slots=2, capacity=64, page_size=16)),
    "dense": (*MIXED, {}, dict(max_slots=2, capacity=64, kv_layout="dense")),
    "odd-page-size": (_prompts(2, [10, 16, 7]), [4, 6, 3], {},
                      dict(max_slots=2, capacity=30, page_size=7)),
    "sparse-strided-steps3": (*MIXED, dict(kv_exchange_ratio=0.5, kv_selection="strided"),
                              dict(max_slots=3, capacity=64, steps_per_admit=3)),
    "prefix-cow": (_shared_prefix(26, [3, 5, 3, 5]), [4] * 4, {},
                   dict(max_slots=2, capacity=64, page_size=8, prefix_cache=True)),
    "page-exhaustion-fifo": (_prompts(3, [20, 6, 6, 6]), [4] * 4, {},
                             dict(max_slots=3, capacity=32, page_size=8, num_pages=4)),
    "spec-k3": (*MIXED, {}, dict(max_slots=2, capacity=64, spec_k=3)),
    # accepts straddle the 4-token pages; the scripted drafter is built per run
    "spec-k3-scripted": (*MIXED, {}, dict(max_slots=2, capacity=64, page_size=4, spec_k=3,
                                          drafter="scripted")),
    "int8": (*MIXED, {}, dict(max_slots=2, capacity=64, kv_quant="int8")),
    "fp8-prefix": (_shared_prefix(24, [4, 4, 6]), [5, 3, 4], {},
                   dict(max_slots=2, capacity=64, page_size=8, kv_quant="fp8", prefix_cache=True)),
    "attnmass": (*MIXED, dict(kv_exchange_ratio=0.5, kv_selection="attnmass"),
                 dict(max_slots=2, capacity=64, page_size=8)),
}
SCRIPT = [3, 1, 0, 2]  # accepts per verify tick: full, partial, zero, partial


def _assert_accepts_as_planned(drafter, k):
    s = drafter.summary(k)
    assert s["as_planned"] and s["full"] and s["partial"] and s["zero"], s


STATS = ("full_prefills", "suffix_prefills", "prefill_tokens", "peak_resident",
         "spec_drafted", "spec_accepted", "verify_ticks", "prefix_hits", "prefix_tokens_reused")


@pytest.mark.parametrize("name", CASES)
def test_pool_matches_jax_scheduler(model, name):
    tc, jc, tp, jp = model
    prompts, n_new, fed, kw = CASES[name]
    fed = dict(n_participants=4, sync_interval=4, **fed)
    teng = TEngine(tc, tp, fedattn=TFed(**fed), device="cpu")
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("drafter") == "scripted":
        plans = {tuple(p): teng.generate(p[None], n).tokens[0] for p, n in zip(prompts, n_new)}
        jkw["drafter"], tkw["drafter"] = (ScriptedDrafter(plans, SCRIPT, tc.vocab_size) for _ in "jt")
    jsched = JSched(JEngine(jc, jp, fedattn=JFed(**fed)), **jkw)
    want = jsched.run([JRequest(tokens=jnp.asarray(p), n_new=n) for p, n in zip(prompts, n_new)])
    tsched = TSched(teng, **tkw)
    got = tsched.run([TRequest(tokens=p, n_new=n) for p, n in zip(prompts, n_new)])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=f"request {i}")
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=ATOL_LOGPROB, rtol=0)
        assert g.prefill_comm_bytes == w.prefill_comm_bytes
    ts, js = tsched.pool_stats(), jsched.pool_stats()
    for key in STATS:
        assert ts.get(key) == js.get(key), key
    if name == "prefix-cow":
        assert ts["suffix_prefills"] >= 1 and ts["prefix_tokens_reused"] >= 26
    if name == "page-exhaustion-fifo":
        # 4 pages of 8: the 20-token request (3 pages) holds the next one at
        # the head of the queue, so never all three slots fill
        assert ts["peak_resident"] == 2 and ts["full_prefills"] == 4
    if kw.get("drafter") == "scripted":
        assert ts["spec_accepted"] > 0
        for d in (jkw["drafter"], tkw["drafter"]):
            _assert_accepts_as_planned(d, kw["spec_k"])


def _sampled_requests():
    prompts = _prompts(7, [14, 9, 21, 12])
    return [
        TRequest(tokens=p, n_new=n, temperature=t, generator=torch.Generator().manual_seed(100 + i))
        for i, (p, n, t) in enumerate(zip(prompts, [6, 9, 4, 7], [0.8, 0.0, 1.3, 0.8]))
    ]


@pytest.mark.parametrize("spec_k", [0, 3])
def test_sampled_pool_matches_own_generate(model, spec_k):
    """Token m draws the noise of (seed, m) alone: the pool, a speculative
    verify and standalone generate agree token for token. With ``spec_k``
    the drafter proposes generate's own tokens, so sampled drafts are
    accepted (fully, partly and not at all, as scripted)."""
    tc, _, tp, _ = model
    fed = TFed(n_participants=4, sync_interval=4, kv_exchange_ratio=0.5, kv_selection="random")
    eng = TEngine(tc, tp, fedattn=fed, device="cpu")
    reqs = _sampled_requests()
    wants = [eng.generate(r.tokens[None], r.n_new, temperature=r.temperature,
                          generator=torch.Generator().manual_seed(r.generator.initial_seed()))
             for r in reqs]
    drafter = ScriptedDrafter({tuple(r.tokens): w.tokens[0] for r, w in zip(reqs, wants)},
                              SCRIPT, tc.vocab_size)
    sched = TSched(eng, max_slots=2, capacity=48, spec_k=spec_k, drafter=drafter)
    got = sched.run(reqs)
    for g, want in zip(got, wants):
        np.testing.assert_array_equal(g.tokens, want.tokens)
        np.testing.assert_allclose(g.logprobs, want.logprobs, atol=ATOL_LOGPROB, rtol=0)
    if spec_k:
        assert sched.stats["spec_accepted"] > 0
        _assert_accepts_as_planned(drafter, spec_k)


def test_cuda_backend_on_cpu_runs_k2_plain_once_per_layer_and_tick(model):
    tc, _, tp, _ = model
    eng = TEngine(tc, tp, backend="cuda", device="cpu")
    sched = TSched(eng, max_slots=2, capacity=48)
    calls, launches = tfd.paged_flash_decode_plain.calls, tfd.paged_flash_decode.launches
    res = sched.run([TRequest(tokens=p, n_new=n) for p, n in zip(_prompts(4, [12, 20, 7]), [5, 2, 6])])
    assert sched.stats["ticks"] > 0
    assert tfd.paged_flash_decode_plain.calls - calls == tc.n_layers * sched.stats["ticks"]
    assert tfd.paged_flash_decode.launches == launches
    plain = TSched(TEngine(tc, tp, backend="torch", device="cpu"), max_slots=2, capacity=48)
    ref = plain.run([TRequest(tokens=p, n_new=n) for p, n in zip(_prompts(4, [12, 20, 7]), [5, 2, 6])])
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_paged_decode_step_on_bridged_pool_matches_jax(model, kv_quant):
    """One pooled decode step on the SAME random pool (carried over by
    ``pool_from_numpy``): logits and the written pool agree."""
    from repro.core.fedattn import FedAttnContext as JCtx
    from repro.models import transformer as JT
    from repro_torch.core.fedattn import FedAttnContext as TCtx
    from repro_torch.models import transformer as TT

    tc, jc, tp, jp = model
    S, N, ps, Pp = 3, 16, 4, 5
    C = Pp * ps
    rng = np.random.default_rng(8)
    jcache = JT.init_paged_cache(jc, S, N, ps, kv_quant=kv_quant)
    jcache = [
        {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)).astype(v.dtype)
             if k in ("pk", "pv") else jnp.asarray(rng.random(v.shape).astype(np.float32) * 0.05))
         for k, v in layer.items()}
        for layer in jcache
    ]
    tcache = pool_from_numpy(jax.tree.map(np.asarray, jcache), tc, "cpu")
    pages = rng.permutation(N)[: S * Pp].reshape(S, Pp).astype(np.int32)
    pages[2, 3:] = N
    wp = np.array([7, 13, 9], np.int32)
    tok = rng.integers(0, tc.vocab_size, S).astype(np.int32)
    kv_seg = np.tile((np.arange(C) * 4 // C).astype(np.int32), (S, 1))
    q_seg = np.full(S, 3, np.int32)
    vec = dict(positions=wp[:, None], segments=q_seg[:, None],
               kv_positions=np.arange(C, dtype=np.int32), kv_segments=kv_seg)

    jctx = JCtx.build(jc.fedattn, jc.n_layers, C)
    jd = jctx.decode_template(C).__class__(**{**jctx.decode_template(C).__dict__,
                                               **{k: jnp.asarray(v) for k, v in vec.items()}})
    jl, jnew = JT.TransformerLM(jc).decode_step(
        jp, jcache, jnp.asarray(tok)[:, None], jnp.asarray(wp), jctx, dctx=jd,
        pages=jnp.asarray(pages))
    tctx = TCtx.build(tc.fedattn, tc.n_layers, C)
    import dataclasses
    td = dataclasses.replace(tctx.decode_template(C), **{k: torch.from_numpy(v) for k, v in vec.items()})
    tl = TT.TransformerLM(tc).decode_step(
        tp, tcache, torch.from_numpy(tok)[:, None].long(), torch.from_numpy(wp), tctx, dctx=td,
        pages=torch.from_numpy(pages))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
    for tlay, jlay in zip(tcache, jax.tree.map(np.asarray, jnew)):
        for key in tlay:
            t = tlay[key]
            t = t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
            j = jlay[key].view(np.uint8) if jlay[key].dtype.name == "float8_e4m3fn" else jlay[key]
            if key in ("pk", "pv") and kv_quant is not None:
                np.testing.assert_array_equal(t.numpy(), j)
            else:
                np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=1e-5)


def test_validation(model):
    tc, _, tp, _ = model
    eng = TEngine(tc, tp, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        TSched(eng, kv_layout="dense", kv_quant="int8")
    with pytest.raises(ValueError, match="paged"):
        TSched(eng, kv_layout="dense", prefix_cache=True)
    with pytest.raises(ValueError, match="steps_per_admit"):
        TSched(eng, spec_k=2, steps_per_admit=3)
    with pytest.raises(ValueError, match="spec_k"):
        TSched(eng, spec_k=-1)
    with pytest.raises(ValueError, match="slots hold"):
        TSched(eng, capacity=16).submit(TRequest(tokens=np.zeros(12, np.int32), n_new=8))
    with pytest.raises(ValueError, match="kv_quant"):
        TEngine(tc, tp, device="cpu", kv_quant="int4")
    assert TSched.capacity_for(eng, [TRequest(tokens=np.zeros(20, np.int32), n_new=3)]) == 32
    # K2's limits refuse a 'cuda' pool when it is built, not at its first verify tick
    ceng = TEngine(tc, tp, backend="cuda", device="cpu")
    g = tc.n_heads // tc.n_kv_heads
    with pytest.raises(ValueError, match="K2 serves"):
        TSched(ceng, spec_k=tfd.MAX_ROWS // g)
    with pytest.raises(ValueError, match="K2 serves"):
        TSched(ceng, page_size=tfd.MAX_PAGE_SIZE + 1)
    TSched(ceng, spec_k=tfd.MAX_ROWS // g - 1, page_size=tfd.MAX_PAGE_SIZE)
    TSched(eng, spec_k=tfd.MAX_ROWS // g, page_size=tfd.MAX_PAGE_SIZE + 1)  # plain torch: no limit


def test_serve_stream_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--stream", "--stream-requests", "5", "--arrival-rate", "50",
                "--n-new", "4", "--seq-len", "24", "--spec-k", "2", "--kv-quant", "int8"])
    out = capsys.readouterr().out
    assert "aggregate decode throughput" in out and "tpot p50" in out and "acceptance rate" in out
