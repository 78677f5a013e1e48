"""The port's dense decoder against the JAX package's, on the same weights
(through the weight bridge) and inputs: each layer function, then
``TransformerLM.apply`` and ``decode_step`` logits on reduced configs.

Tolerance: float32 atol 2e-5 on layer outputs and 1e-4 on logits — the
same f32 arithmetic in another summation order (matmul blocking), growing
through the 4 layers and the d=256 head (observed ~1e-6 and ~1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as j_reduced
from repro.core.fedattn import FedAttnContext as JCtx
from repro.models import build_model
from repro.models import layers as JL
from repro.types import FedAttnConfig as JFed
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core.fedattn import FedAttnContext as TCtx
from repro_torch.models import layers as TL
from repro_torch.models.transformer import TransformerLM
from repro_torch.types import FedAttnConfig as TFed

ATOL_LAYER, ATOL_LOGITS = 2e-5, 1e-4
ARCHS = ["qwen2.5-7b", "qwen2-7b", "llama3-8b"]


def _rng(i=0):
    return np.random.default_rng(i)


def _pair(cfg_name, **kw):
    return t_reduced(cfg_name, **kw), j_reduced(cfg_name, **kw)


def _close(t, j, atol=ATOL_LAYER):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    tc, jc = _pair("qwen2.5-7b", norm=norm)
    x = _rng(1).standard_normal((2, 5, tc.d_model)).astype(np.float32) * 3
    p = {"scale": _rng(2).standard_normal(tc.d_model).astype(np.float32),
         "bias": _rng(3).standard_normal(tc.d_model).astype(np.float32)}
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), tc)
    _close(got, JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc))


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row):
    x = _rng(4).standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + 1000
    if per_row:
        pos = np.stack([pos, pos * 3])
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _close(got, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), atol=1e-4)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_ffn(act):
    tc, jc = _pair("llama3-8b", ffn_activation=act)
    d, f = tc.d_model, tc.d_ff
    r = _rng(5)
    p = {"w_gate": r.standard_normal((d, f)), "w_up": r.standard_normal((d, f)),
         "w_down": r.standard_normal((f, d))}
    p = {k: (v / np.sqrt(v.shape[0])).astype(np.float32) for k, v in p.items()}
    if act != "swiglu":
        del p["w_gate"]
    x = r.standard_normal((2, 4, d)).astype(np.float32)
    got = TL.apply_ffn({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), tc)
    _close(got, JL.apply_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc))


@pytest.mark.parametrize("tie,vocab,cap", [(False, 600, None), (True, 600, None), (False, 512, 30.0)])
def test_embed_and_lm_head(tie, vocab, cap):
    tc = dataclasses.replace(t_reduced("qwen2-7b"), tie_embeddings=tie, vocab_size=vocab, logit_soft_cap=cap)
    jc = dataclasses.replace(j_reduced("qwen2-7b"), tie_embeddings=tie, vocab_size=vocab, logit_soft_cap=cap)
    assert tc.padded_vocab == jc.padded_vocab == (1024 if vocab == 600 else 512)
    r = _rng(6)
    emb = r.standard_normal((tc.padded_vocab, tc.d_model)).astype(np.float32)
    head = (r.standard_normal((tc.d_model, tc.padded_vocab)) / 16).astype(np.float32)
    toks = r.integers(0, vocab, (2, 7)).astype(np.int32)
    te, je = {"tok": torch.from_numpy(emb)}, {"tok": jnp.asarray(emb)}
    x_t = TL.embed_tokens(te, torch.from_numpy(toks), tc)
    x_j = JL.embed_tokens(je, jnp.asarray(toks), jc)
    _close(x_t, x_j)
    th = {} if tie else {"w": torch.from_numpy(head)}
    jh = {} if tie else {"w": jnp.asarray(head)}
    x = r.standard_normal((2, 3, tc.d_model)).astype(np.float32) / 16
    got = TL.apply_lm_head(th, te, torch.from_numpy(x), tc)
    want = JL.apply_lm_head(jh, je, jnp.asarray(x), jc)
    assert got.shape[-1] == vocab
    _close(got, want, atol=ATOL_LOGITS)


def _models(arch):
    tc, jc = _pair(arch)
    jm = build_model(jc)
    jp = jm.init(jax.random.key(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return tc, jc, TransformerLM(tc), tp, jm, jp


def _fed(cls, n):
    return cls(n_participants=n, sync_interval=2, kv_exchange_ratio=0.5, kv_selection="strided")


@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_apply_and_decode_step(arch):
    tc, jc, tm, tp, jm, jp = _models(arch)
    B, L, cap = 2, 21, 32
    toks = _rng(7).integers(0, tc.vocab_size, (B, L + 1)).astype(np.int32)
    tctx = TCtx.build(_fed(TFed, 4), tc.n_layers, L)
    jctx = JCtx.build(_fed(JFed, 4), jc.n_layers, L)
    got = tm.apply(tp, torch.from_numpy(toks[:, :L]), tctx)
    want = jm.apply(jp, jnp.asarray(toks[:, :L]), jctx)
    _close(got, want, atol=ATOL_LOGITS)

    # bulk decode-write of the prompt, then one single-token step
    tcache = tm.init_cache(B, cap, device="cpu")
    jcache = jm.init_cache(B, cap)
    tpre = dataclasses.replace(tctx.for_decode_step(cap, 0, n_new=L), positions=tctx.positions, segments=tctx.segments)
    jpre = dataclasses.replace(jctx.for_decode_step(cap, 0, n_new=L), positions=jctx.positions, segments=jctx.segments)
    got = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, :L]), 0, tctx, dctx=tpre)
    want, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, :L]), 0, jctx, dctx=jpre)
    _close(got, want, atol=ATOL_LOGITS)
    got = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, L:]), L, tctx, step=0)
    want, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, L:]), L, jctx, step=0)
    _close(got, want, atol=ATOL_LOGITS)
    _close(tcache[1]["k"], jcache[1]["k"], atol=ATOL_LOGITS)


def test_bridge_rejects_unknown_and_missing_keys():
    tc, jc, tm, tp, jm, jp = _models("qwen2-7b")
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"][0]["attn"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unknown"):
        params_from_numpy(tree, tc, "cpu")
    tree = jax.tree.map(np.asarray, jp)
    del tree["head"]["w"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, tc, "cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"]["scale"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, tc, "cpu")


def test_port_init_matches_bridge_layout():
    tc = t_reduced("qwen2.5-7b")
    own = TransformerLM(tc).init(torch.Generator().manual_seed(0))
    from repro_torch.checkpoint.bridge import expected_shapes, flatten

    flat = flatten(own)
    assert {k: tuple(v.shape) for k, v in flat.items()} == expected_shapes(tc)
    assert flat["layers/0/attn/wq"].abs().max() <= 2 * tc.d_model**-0.5 + 1e-6  # truncated at 2 std
