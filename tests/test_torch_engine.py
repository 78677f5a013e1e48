"""The port's ``FedAttnEngine.generate`` against the JAX package's, on the
same weights (through the weight bridge) and prompts: greedy tokens equal
exactly, logprobs within atol 2e-5 — f32 on both sides, the same
arithmetic in another summation order through 4 layers and the head
(observed ~1.5e-6). Sampled decode draws from a torch.Generator, so it is
pinned for seed-determinism inside torch only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.models import build_model
from repro.serving import FedAttnEngine as JEngine
from repro.types import FedAttnConfig as JFed, LayerSpec as JSpec
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.serving.engine import FedAttnEngine as TEngine
from repro_torch.types import FedAttnConfig as TFed, LayerSpec as TSpec

ATOL_LOGPROB = 2e-5


@pytest.fixture(scope="module")
def models():
    """Reduced qwen2.5-7b (4 layers, d 256, 4 query heads over 1 KV head,
    dh 64) — once with its structural sync at layer 3, once without
    structural sync flags so ``sync_interval`` places the syncs."""
    out = {}
    for name, tspec, jspec in (("pattern", None, None), ("uniform", TSpec(), JSpec())):
        kw_t = {} if tspec is None else dict(pattern=(tspec,))
        kw_j = {} if jspec is None else dict(pattern=(jspec,))
        tc, jc = t_reduced("qwen2.5-7b", **kw_t), j_reduced("qwen2.5-7b", **kw_j)
        assert (tc.n_layers, tc.d_model, tc.n_heads, tc.n_kv_heads, tc.head_dim) == (4, 256, 4, 1, 64)
        jp = build_model(jc).init(jax.random.key(0))
        out[name] = (tc, jc, params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu"), jp)
    return out


# (model, N, H, kv_exchange_ratio, L, n_new, port backend)
CASES = [
    ("pattern", 4, 4, 1.0, 37, 5, "torch"),
    ("pattern", 4, 4, 0.5, 37, 5, "cuda"),
    ("pattern", 1, 1, 1.0, 21, 5, "torch"),
    ("uniform", 4, 1, 1.0, 30, 5, "cuda"),
    ("uniform", 4, 2, 0.5, 45, 5, "torch"),
    ("uniform", 4, 2, 0.5, 45, 1, "ref"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_greedy_generate_matches_jax(models, case):
    arch, N, H, ratio, L, n_new, backend = case
    tc, jc, tp, jp = models[arch]
    fed = dict(n_participants=N, sync_interval=H, kv_exchange_ratio=ratio, kv_selection="strided")
    toks = np.random.default_rng(L).integers(0, tc.vocab_size, (2, L)).astype(np.int32)
    want = JEngine(jc, jp, fedattn=JFed(**fed)).generate(jnp.asarray(toks), n_new)
    eng = TEngine(tc, tp, fedattn=TFed(**fed), backend=backend, device="cpu")
    launches = tfa.flash_attention.launches
    got = eng.generate(toks, n_new)
    assert tfa.flash_attention.launches == launches  # CPU tensors never launch
    assert got.tokens.shape == got.logprobs.shape == (2, n_new)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=ATOL_LOGPROB, rtol=0)
    assert got.prefill_comm_bytes == want.prefill_comm_bytes


def test_cuda_backend_on_cpu_uses_plain_version_once_per_layer_and_step(models):
    tc, jc, tp, jp = models["pattern"]
    eng = TEngine(tc, tp, backend="cuda", device="cpu")
    calls = tfa.flash_attention_plain.calls
    eng.generate(np.zeros((1, 10), np.int32), 3)
    assert tfa.flash_attention_plain.calls - calls == tc.n_layers * 3  # prefill + 2 steps


def test_sampled_generate_is_seed_deterministic(models):
    tc, jc, tp, jp = models["pattern"]
    eng = TEngine(tc, tp, fedattn=TFed(n_participants=4, sync_interval=4, kv_exchange_ratio=0.5),
                  device="cpu")
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (2, 19)).astype(np.int32)
    run = lambda seed: eng.generate(toks, 6, temperature=1.5, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.logprobs, b.logprobs)
    assert not np.array_equal(a.tokens, c.tokens)
    strided = TEngine(tc, tp, fedattn=TFed(n_participants=4, sync_interval=4, kv_exchange_ratio=0.5,
                                           kv_selection="strided"), device="cpu")
    # temperature > 0 without a generator decodes greedily
    np.testing.assert_array_equal(
        strided.generate(toks, 6, temperature=1.5).tokens, strided.generate(toks, 6).tokens
    )
